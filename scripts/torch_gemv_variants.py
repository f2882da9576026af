#!/usr/bin/env python3
"""Device time of design variants of the port's GEMV kernel on one CUDA card.

    python3 scripts/torch_gemv_variants.py [--baseline DIR]

Each variant is accblas_tpu_torch/csrc/gemv.cu with one design choice
changed in the text: the loads of A a lane issues before it uses one, the
rows a warp takes (which share each load of x), warps per CTA, a load of A
that allocates no L1 line or of x through the read-only cache, or a grid
of one wave whose warps loop over the rows. `--baseline DIR` also builds
the gemv.cu of another checkout's csrc/ with that checkout's headers,
launched through the earlier 16-argument C entry (a storage code beside
each operand, the tier and vec_ok as arguments of their own).

All variants are built in parallel with the port's nvcc flags. Each one's
bits are compared with the design's; then, in 6 turns (forward and
backward through the list), each is launched 20 times back to back
between two CUDA events, 5 times, and the least mean per launch is
printed beside the bytes bound (3.35 TB/s). Cases: 16384^2 for
Acc<f32,bf16>, fixed f32 and Acc<df64,bf16> fast (beta = 0), and
16384 x 16448 for Acc<f32,bf16> (a row pitch that is not a power of two);
beside torch.mv and, as the card's streaming rate for the same bytes, the
port's DOT kernel over the two halves of A. Prints the card's name and
power limit first. Writes nothing outside build/.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from accblas_tpu_torch.ops import _build  # noqa: E402
from accblas_tpu_torch.ops.dot import acc_dot  # noqa: E402
from accblas_tpu_torch.utils import devgen  # noqa: E402

N = 16384
PEAK_BYTES = 3.35e12
SRC = ROOT / "accblas_tpu_torch" / "csrc"
OUT = _build.BUILD_DIR / "variants"

_LOADS = "constexpr int kLoads = 16;"
_ROWS = "constexpr int kRows = 1;"
# load helpers some variants add after the includes: the 4, 8 or 16 bytes
# of a pack as unsigned words, read past L1 or through the read-only cache
_HELPERS = """
namespace accblas {
template <int B> struct Words;
template <> struct Words<4> { using type = unsigned; };
template <> struct Words<8> { using type = uint2; };
template <> struct Words<16> { using type = uint4; };
template <class T, int V>
__device__ __forceinline__ Pack<T, V> load_pack_ldg(const T* p) {
  using W = typename Words<sizeof(Pack<T, V>)>::type;
  Pack<T, V> r;
  *reinterpret_cast<W*>(&r) = __ldg(reinterpret_cast<const W*>(p));
  return r;
}
template <class T, int V>
__device__ __forceinline__ Pack<T, V> load_pack_no_l1(const T* p) {
  constexpr int B = sizeof(Pack<T, V>);
  Pack<T, V> r;
  auto& w = *reinterpret_cast<typename Words<B>::type*>(&r);
  if constexpr (B == 16) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w) : "l"(p));
  } else if constexpr (B == 8) {
    asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];" : "=r"(w.x), "=r"(w.y) : "l"(p));
  } else {
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(w) : "l"(p));
  }
  return r;
}
}  // namespace accblas
"""
HELPERS = ('#include "reduce.cuh"\n', '#include "reduce.cuh"\n' + _HELPERS)
# one wave: as many CTAs as the card holds at once, each warp looping over
# row groups
ONE_WAVE = [
    ("  if (row0 < m) {  // a whole warp leaves together\n",
     "  for (int64_t g = row0; g < m; g += static_cast<int64_t>(gridDim.x) * kWarps * kRows) {\n"),
    ("row0, threadIdx.x & 31);", "g, threadIdx.x & 31);"),
    ("        const int64_t grid = (m + rows - 1) / rows;\n", """\
        static int per_sm = 0, sms = 0;
        if (per_sm == 0) {
          int dev = 0;
          cudaGetDevice(&dev);
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemv_rows<SA, SX, TIER>,
                                                        kWarps * 32, 0);
        }
        const int64_t need = (m + rows - 1) / rows, wave = int64_t(per_sm) * sms;
        const int64_t grid = need < wave ? need : wave;
"""),
]

# (name, [(text in gemv.cu, its replacement)])
VARIANTS = [
    ("design", []),
    ("1 load in flight", [(_LOADS, "constexpr int kLoads = 1;")]),
    ("4 loads in flight", [(_LOADS, "constexpr int kLoads = 4;")]),
    ("8 loads in flight", [(_LOADS, "constexpr int kLoads = 8;")]),
    ("2 rows a warp", [(_ROWS, "constexpr int kRows = 2;")]),
    ("4 rows a warp", [(_ROWS, "constexpr int kRows = 4;")]),
    ("8 warps a CTA", [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")]),
    ("A past L1", [HELPERS,
                   ("ap[u][r] = load_pack<SA, V>(", "ap[u][r] = load_pack_no_l1<SA, V>(")]),
    ("x by __ldg", [HELPERS, ("xp[u] = load_pack<SX, V>(", "xp[u] = load_pack_ldg<SX, V>(")]),
    ("one wave", ONE_WAVE),
    ("design again", []),  # the spread between two builds of one source
]

_NEW_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2 + [ctypes.c_float] * 2 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
_OLD_ARGS = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
    ctypes.c_void_p,
]


def build(jobs: list[tuple[str, Path, str]]) -> dict[str, ctypes.CDLL]:
    """Compile each (name, include dir, source text) at once; load them."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, inc, text) in enumerate(jobs):
        src, lib = OUT / f"v{i}.cu", OUT / f"libv{i}.so"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(inc), "-o", str(lib), str(src)]
        procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        regs = sorted({int(line.split("Used ")[1].split()[0]) for line in log.splitlines()
                       if "Used " in line and "registers" in line})
        print(f"built {name}: registers {regs[0]}-{regs[-1]} over its instantiations",
              flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def per_launch_ms(fn, launches: int = 20, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / launches)
    return best


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, help="another checkout's csrc/ directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)

    text = (SRC / "gemv.cu").read_text()
    jobs = []
    for name, edits in VARIANTS:
        t = text
        for old, new in edits:
            if old not in t:
                raise SystemExit(f"variant {name}: {old!r} is not in gemv.cu")
            t = t.replace(old, new)
        jobs.append((name, SRC, t))
    if args.baseline:
        jobs.append(("baseline", args.baseline, (args.baseline / "gemv.cu").read_text()))
    libs = build(jobs)

    dev = torch.device("cuda", 0)
    a = devgen.gen_f32((N, N), 42, "gemv_a", device=dev).to(torch.bfloat16)
    x = devgen.gen_f32((N,), 42, "gemv_x", device=dev).to(torch.bfloat16)
    a32, x32 = a.float(), x.float()
    # a row pitch that is not a power of two
    w = N + 64
    aw = devgen.gen_f32((N, w), 42, "gemv_a", device=dev).to(torch.bfloat16)
    xw = devgen.gen_f32((w,), 42, "gemv_x", device=dev).to(torch.bfloat16)
    res = torch.zeros(N, device=dev)
    out = torch.empty(N, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    st, tc = _build.STORAGE_CODE, _build.TIER_CODE

    def dot_halves(t):
        """The port's DOT kernel over the two halves of t's bytes: the same
        bytes streamed from one end to the other, the card's streaming rate
        at this size."""
        flat = t.reshape(-1)
        h = flat.numel() // 2
        return lambda: acc_dot(flat[:h], flat[h:], "f32")

    cases = [  # label, A, x, A and x storage, tier, bytes, references
        ("Acc<f32,bf16>", a, x, "bf16", "f32", N * N * 2 + N * 6,
         {"torch.mv": lambda: torch.mv(a, x), "DOT, same bytes": dot_halves(a)}),
        ("Acc<f32,bf16>", aw, xw, "bf16", "f32", N * w * 2 + N * 4 + w * 2,
         {"torch.mv": lambda: torch.mv(aw, xw)}),
        ("fixed f32", a32, x32, "f32", "f32", N * N * 4 + N * 8,
         {"torch.mv": lambda: torch.mv(a32, x32), "DOT, same bytes": dot_halves(a32)}),
        ("Acc<df64,bf16> fast", a, x, "bf16", "df64_fast", N * N * 2 + N * 6, {}),
    ]
    for label, av, xv, s, tier, nbytes, refs in cases:
        m, n = av.shape
        calls = {}
        for name, lib in libs.items():
            old = name == "baseline"
            fn = lib.accblas_gemv
            fn.argtypes, fn.restype = (_OLD_ARGS if old else _NEW_ARGS), ctypes.c_int
            if old:
                argv = (av.data_ptr(), st[s], xv.data_ptr(), st[s], res.data_ptr(), st["f32"],
                        out.data_ptr(), None, m, n, 1.0, 0.0, tc[tier], 1024, 1, stream)
            else:
                codes = st[s] | st[s] << 4 | st["f32"] << 8 | tc[tier] << 12
                argv = (av.data_ptr(), xv.data_ptr(), res.data_ptr(), out.data_ptr(), None, m,
                        n, 1.0, 0.0, 1024, codes, stream)
            calls[name] = (lambda f=fn, v=argv: f(*v))
        want = None
        for name, call in calls.items():  # the order of every sum is the design's
            out.fill_(float("nan"))
            _build.check(call(), f"variant {name} launch")
            torch.cuda.synchronize()
            want = out.clone() if want is None else want
            print(f"{label} {m}x{n}: {name} bits equal to the design's: {torch.equal(out, want)}",
                  flush=True)
        calls.update(refs)
        best = {name: float("inf") for name in calls}
        order = list(calls)
        for turn in range(6):  # forward and backward, in turns
            for name in order if turn % 2 == 0 else order[::-1]:
                best[name] = min(best[name], per_launch_ms(calls[name]))
        bound = nbytes / PEAK_BYTES * 1e3
        print(f"{label} {m}x{n}, bound {bound:.4f} ms:", flush=True)
        for name, ms in best.items():
            print(f"  {name:22s} {ms:.4f} ms  {bound / ms:6.1%} of the bound", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
