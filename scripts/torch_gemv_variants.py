#!/usr/bin/env python3
"""Device time of design variants of the port's GEMV kernels on one CUDA card.

    python3 scripts/torch_gemv_variants.py [--baseline DIR] [--only NAME,...]

Each variant is accblas_tpu_torch/csrc/ with one design choice of gemv.cu
changed in the text. gemv_rows (one warp a row): the loads of A a lane
issues before it uses one, the rows a warp takes (which share each load of
x), warps per CTA, A read past L1 (row.stream_pack) or x through the
read-only cache (__ldg), or a grid of one wave whose warps loop over the
rows. gemv_staged (x stored in f8, widened once a CTA into shared memory):
x staged in f16 rather than f32, 32 or 8 warps a CTA rather than 16, A
read past L1 (at 16 and 32 warps), A widened one value a conversion rather
than two, and the staged rows without their 16-byte gap (bank
conflicts). `--baseline DIR` also builds the gemv.cu of
another checkout's csrc/ with that checkout's headers; `--only` keeps the
named variants (and the design).

All variants are built in parallel with the port's nvcc flags. Each one's
bits are compared with the design's; then, in 6 turns (forward and
backward through the list), each is launched 20 times back to back
between two CUDA events, 5 times, and the least mean per launch is
printed beside the bytes bound (3.35 TB/s). Cases: 16384^2 for
Acc<f32,bf16>, fixed f32 and Acc<df64,bf16> fast (beta = 0), and
16384 x 16448 for Acc<f32,bf16> (a row pitch that is not a power of two);
Acc<f32,f8e4m3> at 24576^2 with f8 x (the staged kernel, and gemv_rows as
"per-row route", here and in every f8-x case) and with f32 x, and bf16 A
with f8 x at 16384^2 (gemv_rows, the kernel the C entry takes for it, and
each variant's); beside torch.mv and, as the card's
streaming rate for the same bytes, the port's DOT kernel over the two
halves of A. Prints the card's name and power limit first. Writes nothing
outside build/.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
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
N8 = 24576  # scripts/probe_r4e.py's shape
PEAK_BYTES = 3.35e12
SRC = ROOT / "accblas_tpu_torch" / "csrc"
OUT = _build.BUILD_DIR / "variants"
# the C entry's route requests (bits 16-17 of its codes): gemv_rows, gemv_staged
ROWS, STAGED = 1 << 16, 2 << 16

_LOADS = "constexpr int kLoads = 16;"
_STAGED_WARPS = "constexpr int kStagedWarps = 16;"
# gemv_staged's loads of A, and the same loads past L1
_STAGED_A = ("ap[u][r] = a[r].template pack<V>(u * kStride);\n  }\n#pragma unroll\n"
             "  for (int u = 0; u < K; ++u) {\n    float xv[V];\n    x.load(")
_ROWS = "constexpr int kRows = 1;"
# x's packs through the read-only cache: a Row read that loads by __ldg
_LDG = [
    ("accessor.cuh", "// ---- vector stores: V storage values in one aligned access ----", """\
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

// ---- vector stores: V storage values in one aligned access ----"""),
    ("range.cuh", "    // the same row from column c on: its column 0 is this row's column c\n", """\
    template <int V>
    __device__ __forceinline__ Pack<std::remove_const_t<St>, V> ldg_pack(int j) const {
      return load_pack_ldg<std::remove_const_t<St>, V>(p_ + j);
    }
    // the same row from column c on: its column 0 is this row's column c
"""),
    ("gemv.cu", "    xp[u] = x.template pack<V>(u * kStride);",
     "    xp[u] = x.template ldg_pack<V>(u * kStride);"),
]
# one wave: as many CTAs as the card holds at once, each warp looping over
# row groups
ONE_WAVE = [
    ("gemv.cu", "  if (row0 < m) {  // a whole warp leaves together\n",
     "  for (int64_t g = row0; g < m; g += static_cast<int64_t>(gridDim.x) * kWarps * kRows) {\n"),
    ("gemv.cu", "gemv_group<SA, SX, TIER>(ra, rx, rr, ro, alpha, beta, bn, vec_ok, row0,",
     "gemv_group<SA, SX, TIER>(ra, rx, rr, ro, alpha, beta, bn, vec_ok, g,"),
    ("gemv.cu", "        const int64_t grid = (m + rows - 1) / rows;\n", """\
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

# (name, [(file in csrc/, text, its replacement)])
VARIANTS = [
    ("design", []),
    ("1 load in flight", [("gemv.cu", _LOADS, "constexpr int kLoads = 1;")]),
    ("4 loads in flight", [("gemv.cu", _LOADS, "constexpr int kLoads = 4;")]),
    ("8 loads in flight", [("gemv.cu", _LOADS, "constexpr int kLoads = 8;")]),
    ("2 rows a warp", [("gemv.cu", _ROWS, "constexpr int kRows = 2;")]),
    ("4 rows a warp", [("gemv.cu", _ROWS, "constexpr int kRows = 4;")]),
    ("8 warps a CTA", [("gemv.cu", "constexpr int kWarps = 4;", "constexpr int kWarps = 8;")]),
    ("A past L1", [("gemv.cu", "ap[u][r] = a[r].template pack<V>(u * kStride);\n  }\n#pragma unroll\n"
                    "  for (int u = 0; u < K; ++u) {\n    float xv[V];\n    in_row<SX>::widen",
                    "ap[u][r] = a[r].template stream_pack<V>(u * kStride);\n  }\n#pragma unroll\n"
                    "  for (int u = 0; u < K; ++u) {\n    float xv[V];\n    in_row<SX>::widen")]),
    ("x by __ldg", _LDG),
    ("one wave", ONE_WAVE),
    ("staged f16", [("gemv.cu", "using XStage = float;", "using XStage = __half;")]),
    ("staged 32 warps", [("gemv.cu", _STAGED_WARPS, "constexpr int kStagedWarps = 32;")]),
    ("staged 8 warps", [("gemv.cu", _STAGED_WARPS, "constexpr int kStagedWarps = 8;")]),
    ("staged A past L1", [("gemv.cu", _STAGED_A, _STAGED_A.replace("pack<", "stream_pack<"))]),
    ("staged A past L1 32 warps", [
        ("gemv.cu", _STAGED_A, _STAGED_A.replace("pack<", "stream_pack<")),
        ("gemv.cu", _STAGED_WARPS, "constexpr int kStagedWarps = 32;")]),
    ("staged A one a conversion", [("gemv.cu", "in_row<SA>::widen_paired(ap[u][r], av);",
                                    "in_row<SA>::widen(ap[u][r], av);")]),
    ("staged no gap", [("gemv.cu", "return V * sizeof(XStage) > 16 ? V + kStagedPiece : V;",
                        "return V;")]),
    ("design again", []),  # the spread between two builds of one source
]

# the C entry's arguments; the last, its report of the kernel it launched,
# is passed null (a checkout whose entry lacks it ignores it)
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2 + [ctypes.c_float] * 2 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def variant_dir(i: int, edits) -> Path:
    """A copy of csrc/ under build/ with the variant's edits."""
    d = OUT / f"v{i}"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(SRC, d)
    for name, old, new in edits:
        path = d / name
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {i}: {name} holds {text.count(old)} of {old!r}")
        path.write_text(text.replace(old, new))
    return d


def build(jobs: list[tuple[str, Path]]) -> dict[str, ctypes.CDLL]:
    """Compile each (name, csrc dir)'s gemv.cu at once; load them."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, inc) in enumerate(jobs):
        lib = OUT / f"libv{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(inc), "-o", str(lib),
               str(inc / "gemv.cu")]
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
    ap.add_argument("--only", help="a comma list of the variants to build (and the design)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)

    keep = set(args.only.split(",")) | {"design"} if args.only else None
    jobs = [(name, variant_dir(i, edits)) for i, (name, edits) in enumerate(VARIANTS)
            if keep is None or name in keep]
    if args.baseline:
        jobs.append(("baseline", args.baseline))
    libs = build(jobs)

    dev = torch.device("cuda", 0)
    bf, f8 = torch.bfloat16, torch.float8_e4m3fn
    a = devgen.gen_f32((N, N), 42, "gemv_a", device=dev).to(bf)
    x = devgen.gen_f32((N,), 42, "gemv_x", device=dev).to(bf)
    a32, x32 = a.float(), x.float()
    # a row pitch that is not a power of two
    w = N + 64
    aw = devgen.gen_f32((N, w), 42, "gemv_a", device=dev).to(bf)
    xw = devgen.gen_f32((w,), 42, "gemv_x", device=dev).to(bf)
    a8 = devgen.gen_f32((N8, N8), 42, "p4a_a", device=dev).to(f8)
    x8f = devgen.gen_f32((N8,), 42, "p4a_x", device=dev)
    x8 = x8f.to(f8)
    xb8 = x.to(f8)
    res = torch.zeros(N8, device=dev)
    out = torch.empty(N8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    st, tc = _build.STORAGE_CODE, _build.TIER_CODE

    def dot_halves(t):
        """The port's DOT kernel over the two halves of t's bytes: the same
        bytes streamed from one end to the other, the card's streaming rate
        at this size."""
        flat = t.reshape(-1)
        h = flat.numel() // 2
        return lambda: acc_dot(flat[:h], flat[h:], "f32")

    cases = [  # label, A, x, A and x storage, tier, route bit, bytes, references
        ("Acc<f32,bf16>", a, x, "bf16", "bf16", "f32", 0, N * N * 2 + N * 6,
         {"torch.mv": lambda: torch.mv(a, x), "DOT, same bytes": dot_halves(a)}),
        ("Acc<f32,bf16>", aw, xw, "bf16", "bf16", "f32", 0, N * w * 2 + N * 4 + w * 2,
         {"torch.mv": lambda: torch.mv(aw, xw)}),
        ("fixed f32", a32, x32, "f32", "f32", "f32", 0, N * N * 4 + N * 8,
         {"torch.mv": lambda: torch.mv(a32, x32), "DOT, same bytes": dot_halves(a32)}),
        ("Acc<df64,bf16> fast", a, x, "bf16", "bf16", "df64_fast", 0, N * N * 2 + N * 6, {}),
        ("Acc<f32,f8e4m3> f8 x", a8, x8, "f8e4m3", "f8e4m3", "f32", STAGED,
         N8 * N8 + N8 * 5, {"DOT, same bytes": dot_halves(a8.view(torch.uint8).view(bf))}),
        ("Acc<f32,f8e4m3> f32 x", a8, x8f, "f8e4m3", "f32", "f32", 0, N8 * N8 + N8 * 8, {}),
        ("Acc<f32,bf16 A, f8e4m3 x>", a, xb8, "bf16", "f8e4m3", "f32", 0,
         N * N * 2 + N * 5, {}),
    ]
    for label, av, xv, sa, sx, tier, route, nbytes, refs in cases:
        m, n = av.shape
        calls = {}
        codes = st[sa] | st[sx] << 4 | st["f32"] << 8 | tc[tier] << 12
        for name, lib in libs.items():
            fn = lib.accblas_gemv
            fn.argtypes, fn.restype = _ARGS, ctypes.c_int
            argv = (av.data_ptr(), xv.data_ptr(), res.data_ptr(), out.data_ptr(), None, m, n,
                    1.0, 0.0, 1024, codes | route, stream, None)
            calls[name] = (lambda f=fn, v=argv: f(*v))
        if route:
            fn = libs["design"].accblas_gemv
            argv = (av.data_ptr(), xv.data_ptr(), res.data_ptr(), out.data_ptr(), None, m, n,
                    1.0, 0.0, 1024, codes | ROWS, stream, None)
            calls["per-row route"] = (lambda f=fn, v=argv: f(*v))
        want = None
        for name, call in calls.items():  # the order of every sum is the design's
            out.fill_(float("nan"))
            _build.check(call(), f"variant {name} launch")
            torch.cuda.synchronize()
            want = out[:m].clone() if want is None else want
            print(f"{label} {m}x{n}: {name} bits equal to the design's: "
                  f"{torch.equal(out[:m], want)}", flush=True)
        calls.update(refs)
        best = {name: float("inf") for name in calls}
        order = list(calls)
        for turn in range(6):  # forward and backward, in turns
            for name in order if turn % 2 == 0 else order[::-1]:
                best[name] = min(best[name], per_launch_ms(calls[name]))
        bound = nbytes / PEAK_BYTES * 1e3
        print(f"{label} {m}x{n}, bound {bound:.4f} ms:", flush=True)
        for name, ms in best.items():
            print(f"  {name:26s} {ms:.4f} ms  {bound / ms:6.1%} of the bound", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
