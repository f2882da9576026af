"""Time the generic kernels (``csrc/generic.cu``) and the main path's kernels
(the DOT, ``csrc/dot.cu``; the GEMV, ``csrc/gemv.cu``; the TRSV sweep,
``csrc/trsv.cu``) of this checkout beside another checkout's and beside
design variants of this one, in turns, on one card.

    python3 scripts/torch_generic_ab.py [--baseline OTHER_ROOT] [--variants [A,B,...]]
                                        [--sass] [--reps 20]

OTHER_ROOT is the root of another checkout: its ``accblas_tpu_torch`` is
imported from there and built into its own ``build/``. ``--variants`` adds
copies of this checkout's package under ``build/generic_variants/<name>/``,
each with one design choice changed in the text (``VARIANTS``; all of them
if none is named). The generic GEMV's: 8 warps a block instead of 4
(``warps8``), 8 vector steps in flight instead of 16 (``steps8``), x staged
once a block in shared memory (``x_shared``), A and the window read through
L1 (``a_l1``). AXPY's: 16 vector steps in flight instead of 8
(``axpy_steps16``) or 4 (``axpy_steps4``), plain stores instead of
evict-first ones (``axpy_store``), a grid of the blocks the card holds at
once instead of one block a tile (``axpy_resident``), 85 registers at
most, 3 blocks an SM (``axpy_lb3``), and a ring of 1-D TMA bulk copies of x and y into shared
memory fed by one producer warp (``axpy_tma``). The DOT's: 1, 4 or 16
vector steps in flight instead of 8 (``dot_steps1``, ``dot_steps4``,
``dot_steps16``), the f32 tier held to 32 registers so that its grid is
one wave (``dot_one_wave``), and, to find what held the fixed bf16 tier, its step
sums pushed into the counter one by one (``dot_push_each``, the same bits)
and the tier's roundings to bf16 left out (``bf16_unrounded``: other bits,
by design). Every kernel's reads past L1: through the non-coherent path
(``nc_loads``), or with 256-byte L2 fetches (``l2_256``).

``--sass`` compiles ``dot.cu``, ``gemv.cu`` and ``trsv.cu`` of each tree
once more, each alone, with the tree's own nvcc flags, into a temporary
file, and prints one JSON line a tree and source: the seconds nvcc took,
ptxas' registers and spill bytes of ``dot_reduce``, ``gemv_rows`` (and
``gemv_staged``, where the tree has it) and ``trsv_sweep`` (the range over
their instantiations), and, from ``cuobjdump -sass``, their global load
and store instructions counted by opcode with its modifiers
(``LDG.E.128``, ``.CONSTANT``, ``.EF``, ``STG.E``, ...), summed over the
instantiations; then a line of the conversion instructions (``F2FP``,
``F2F``, ``HADD2.F32``, ``I2F``, ``F2I`` by opcode) of the GEMV's
instantiations over f8e4m3 A and x in the f32 tier; then, for each other
tree, the instantiations whose counts differ from this tree's.

All libraries are built first: this tree's, then the others at once, a
variant reusing this tree's library where its sources are the same (a
variant that does not build is reported and left out); then each tree is timed in a process of its own,
forward and backward through the list (baseline, this, variants...,
variants..., this, baseline), so that a drift of the card shows as a gap
between the two readings of one tree. Each line is one process, CUDA-event
minima in ms: ``axpy`` over (16384, 32768) and over its window one column on
(V = 1), ``gemv_generic`` at 16384^2 and ``window_sum`` of the (8192, 16384)
window at (4096, 8192) of a (16384, 32768) parent, at f32/f32, bf16/f32 and
f32/df64; the DOT's rows (Acc<f32,bf16> at 2^29, the main path's;
Acc<f32,f32> at 2^27 and 2^27 + 17; Acc<f32,bf16>, the fixed bf16 and f16
tiers and df64 fast and precise at 2^27; Acc<f32,f8e4m3> and the bf16
tier over f8e4m3 at 2^27; Acc<f32,f32> and Acc<f32,bf16> at 2^27 one
element off alignment); the GEMV's (Acc<f32,bf16> at 16384^2 and
the flagship 1024 x 2048; fixed f32, df64 fast and df64 precise at 16384^2;
Acc<f32,f8e4m3> at 24576^2 with f32 x and with f8 x, and with f8 x one
element off, with e5m2 x, and in the bf16, df64 fast and df64 precise
tiers; Acc<f32,bf16> and fixed f32 at 16384^2 one element off); the TRSV
sweep's at n = 16384 on a
unit upper uniform(-1, 1) / n triangle (the kernel alone: f32, df64, TRSM
k = 8, and f32 one element off; and the whole trsv call), each main-path
row with its kernel's device ms beside ("<row> device": the mean of its
torch.profiler records over 10 calls); and the host us a DOT call takes
(medians: the call, its checks alone with the launch stubbed, its bare
ctypes call). A hash of each row's result bits closes
the line; the last line lists, for each tree, the rows whose bits differ
from this one's. Prints the card's name and power limit first. Compare
trees only within one run.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
PAIRS = (("f32", "f32"), ("bf16", "f32"), ("f32", "df64"))
VARIANT_DIR = HERE / "build" / "generic_variants"

_LAUNCH = """        if (v == kV) {
          generic_gemv<kV, kLevelsVec><<<grid, 32 * kGemvWarps, 0, s>>>(
              ra, rx, rr, ro, alpha, beta, lanes, log2_per, slots);
        } else if (v == 1) {
          generic_gemv<1, kLevelsOne><<<grid, 32 * kGemvWarps, 0, s>>>(
              ra, rx, rr, ro, alpha, beta, lanes, log2_per, slots);
        } else {"""
_LAUNCH_STAGED = """        const size_t smem = n * sizeof(Ar);
        auto staged = [&](auto kern) {
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
          int dev = 0, sms = 0, per_sm = 0;
          cudaGetDevice(&dev);
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 32 * kGemvWarps, smem);
          const unsigned g = grid < unsigned(per_sm * sms) ? grid : unsigned(per_sm * sms);
          kern<<<g, 32 * kGemvWarps, smem, s>>>(ra, rx, rr, ro, alpha, beta, lanes, log2_per,
                                                slots);
        };
        if (v == kV) {
          staged(generic_gemv<kV, kLevelsVec, Ar, SI, SO>);
        } else if (v == 1) {
          staged(generic_gemv<1, kLevelsOne, Ar, SI, SO>);
        } else {"""

# AXPY through a ring of shared-memory stages, each a chunk of x and of y
# brought by 1-D TMA bulk copies (cp.async.bulk, completion counted on an
# mbarrier) that one producer warp issues; kThreads consumer threads read
# V-wide packs from shared memory and store as the kernel does. Rows whose
# width is a whole number of chunks only (the launch below checks).
_TMA_KERNEL = """constexpr int kTmaStages = 4;     // stages of the ring
constexpr int kTmaChunk = 4096;    // elements of x (and of y) a stage

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" : : "r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               : : "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" : : "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{\\n .reg .pred p;\\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
                 " selp.u32 %0, 1, 0, p;\\n}"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1], %2, [%3];"
               : : "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

template <int V, class Ar, class SI, class SO>
__global__ void __launch_bounds__(kThreads + 32)
    generic_axpy_tma(const SI* x, int64_t sx, const SI* y, int64_t sy, range_t<Ar, SO> o,
                     float alpha) {
  constexpr unsigned kBytes = kTmaChunk * sizeof(SI);
  extern __shared__ __align__(128) unsigned char smem[];
  SI* xs = reinterpret_cast<SI*>(smem);
  SI* ys = xs + kTmaStages * kTmaChunk;
  __shared__ uint64_t full[kTmaStages], empty[kTmaStages];
  const int64_t per_row = o.length(1) / kTmaChunk;
  const int64_t chunks = o.length(0) * per_row;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTmaStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" : : : "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kThreads) {  // the producer warp: one thread issues the copies
    if (threadIdx.x == kThreads) {
      int k = 0;
      for (int64_t t = blockIdx.x; t < chunks; t += gridDim.x, ++k) {
        const int s = k % kTmaStages;
        if (k >= kTmaStages) mbar_wait(&empty[s], (k / kTmaStages - 1) & 1);
        const int64_t i = t / per_row, c0 = (t - i * per_row) * kTmaChunk;
        mbar_expect_tx(&full[s], 2 * kBytes);
        bulk_copy(xs + s * kTmaChunk, x + i * sx + c0, kBytes, &full[s]);
        bulk_copy(ys + s * kTmaChunk, y + i * sy + c0, kBytes, &full[s]);
      }
    }
    return;
  }
  int k = 0;
  for (int64_t t = blockIdx.x; t < chunks; t += gridDim.x, ++k) {
    const int s = k % kTmaStages;
    mbar_wait(&full[s], (k / kTmaStages) & 1);
    const int64_t i = t / per_row, c0 = (t - i * per_row) * kTmaChunk;
    const auto orow = o.window(i, c0, 1, kTmaChunk).row(0);
#pragma unroll 4
    for (int c = threadIdx.x * V; c < kTmaChunk; c += kThreads * V) {
      const Pack<SI, V> px = *reinterpret_cast<const Pack<SI, V>*>(xs + s * kTmaChunk + c);
      const Pack<SI, V> py = *reinterpret_cast<const Pack<SI, V>*>(ys + s * kTmaChunk + c);
      Ar v[V];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        v[u] = Widen<Ar>::from(load_f32(px.v[u])) * alpha + Widen<Ar>::from(load_f32(py.v[u]));
      }
      orow.store_stream(c, v);
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
  }
}

"""
_AXPY_LAUNCH = """        if (v == kV) {
          launch(generic_axpy<kV, Ar, SI, SO>, kAxpyTile<kV>);"""
_AXPY_LAUNCH_TMA = """        if (v == kV && cols % kTmaChunk == 0) {
          auto kern = generic_axpy_tma<kV, Ar, SI, SO>;
          const int smem = 2 * kTmaStages * kTmaChunk * sizeof(SI);
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
          int dev = 0, sms = 0, per_sm = 0;
          cudaGetDevice(&dev);
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads + 32, smem);
          kern<<<sms * per_sm, kThreads + 32, smem, s>>>(static_cast<const SI*>(x), sx,
                                                        static_cast<const SI*>(y), sy, ro,
                                                        alpha);
        } else if (v == kV) {
          launch(generic_axpy<kV, Ar, SI, SO>, kAxpyTile<kV>);"""

# name: [(file under accblas_tpu_torch/, text, replacement), ...]
VARIANTS = {
    "warps8": [("csrc/generic.cu", "constexpr int kGemvWarps = 4;",
                "constexpr int kGemvWarps = 8;")],
    "steps8": [("csrc/generic.cu", "constexpr int kStepsLog2 = 4;",
                "constexpr int kStepsLog2 = 3;"),
               ("ops/generic.py", "_STEPS = 16\n", "_STEPS = 8\n")],
    "x_shared": [("csrc/generic.cu", "  const auto xr = x.row(0);\n",
                  "  const auto xr = x.row(0);\n"
                  "  extern __shared__ __align__(32) unsigned char x_smem[];\n"
                  "  Ar* xs = reinterpret_cast<Ar*>(x_smem);\n"
                  "  for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = xr(j);\n"
                  "  __syncthreads();\n"),
                 ("csrc/generic.cu", "          xr.load(c, xv);\n",
                  "          const auto xp = *reinterpret_cast<const Pack<Ar, V>*>(xs + c);\n"
                  "#pragma unroll\n"
                  "          for (int u = 0; u < V; ++u) xv[u] = xp.v[u];\n"),
                 ("csrc/generic.cu", "? arow(j) * xr(j) : Ar{};", "? arow(j) * xs[j] : Ar{};"),
                 ("csrc/generic.cu", _LAUNCH, _LAUNCH_STAGED)],
    # A and the window read through L1 like x (row.load, not row.stream)
    "a_l1": [("csrc/generic.cu", "          arow.stream(c, av);\n",
              "          arow.load(c, av);\n"),
             ("csrc/generic.cu", ".stream(static_cast<int>(q & col_mask), v[s]);",
              ".load(static_cast<int>(q & col_mask), v[s]);")],
    "axpy_steps16": [("csrc/generic.cu", "constexpr int kAxpySteps = 8;",
                      "constexpr int kAxpySteps = 16;")],
    "axpy_store": [("csrc/generic.cu", "        orow.store_stream((s * kThreads + threadIdx.x) * V, v);",
                    "        orow.store((s * kThreads + threadIdx.x) * V, v);")],
    "axpy_tma": [("csrc/generic.cu", "// o(i, 0) = (sum_j a(i, j) * x(0, j)) * alpha",
                  _TMA_KERNEL + "// o(i, 0) = (sum_j a(i, j) * x(0, j)) * alpha"),
                 ("csrc/generic.cu", _AXPY_LAUNCH, _AXPY_LAUNCH_TMA)],
    "axpy_steps4": [("csrc/generic.cu", "constexpr int kAxpySteps = 8;",
                     "constexpr int kAxpySteps = 4;")],
    # a grid of the blocks the card holds at once, each walking many tiles
    "axpy_resident": [("csrc/generic.cu",
                       "          const unsigned grid = static_cast<unsigned>(tiles < (1 << 20) ? "
                       "tiles : 1 << 20);\n          kern<<<grid, kThreads, 0, s>>>",
                       "          int dev = 0, sms = 0, per_sm = 0;\n"
                       "          cudaGetDevice(&dev);\n"
                       "          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
                       "          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, "
                       "kThreads, 0);\n"
                       "          const int64_t cap = int64_t{sms} * per_sm;\n"
                       "          const unsigned grid = static_cast<unsigned>(tiles < cap ? tiles "
                       ": cap);\n          kern<<<grid, kThreads, 0, s>>>")],
    # the bf16/f16 tiers' step sums pushed one by one (the same bits)
    "dot_push_each": [("csrc/reduce.cuh",
                       "      for (int r = 0; r < K; r += 2 * w) p[r] = round_ar<TIER>(__fadd_rn(p[r], "
                       "p[r + w]));\n    }\n    push<log2_of(K)>(p[0]);",
                       "      for (int r = 0; r < K; r += 2 * w) {}\n    }\n#pragma unroll\n"
                       "    for (int s = 0; s < K; ++s) push(p[s]);")],
    # the f32 tier held to 32 registers, so that its 1024 blocks are one wave
    "dot_one_wave": [("csrc/dot.cu", "__global__ void __launch_bounds__(kThreads)\n    dot_reduce(",
                      "__global__ void __launch_bounds__(kThreads, TIER == TIER_F32 ? 8 : 1)\n"
                      "    dot_reduce(")],
    # AXPY held to 85 registers: 3 blocks an SM in place of 2
    "axpy_lb3": [("csrc/generic.cu", "__global__ void __launch_bounds__(kThreads)\n"
                  "    generic_axpy(", "__global__ void __launch_bounds__(kThreads, 3)\n"
                  "    generic_axpy(")],
    # the streaming reads through the non-coherent path, or asking L2 for
    # 256-byte fetches (every kernel that reads past L1)
    "nc_loads": [("csrc/accessor.cuh", "ld.global.L1::no_allocate.v4.u32",
                  "ld.global.nc.L1::no_allocate.v4.u32")],
    "l2_256": [("csrc/accessor.cuh", "ld.global.L1::no_allocate.v4.u32",
                "ld.global.L1::no_allocate.L2::256B.v4.u32")],
    "dot_steps1": [("csrc/dot.cu", "constexpr int kSteps = 8;", "constexpr int kSteps = 1;")],
    "dot_steps4": [("csrc/dot.cu", "constexpr int kSteps = 8;", "constexpr int kSteps = 4;")],
    "dot_steps16": [("csrc/dot.cu", "constexpr int kSteps = 8;", "constexpr int kSteps = 16;")],
    "bf16_unrounded": [("csrc/accessor.cuh",
                        "    return __bfloat162float(__float2bfloat16_rn(v));\n"
                        "  } else if constexpr (TIER == TIER_F16) {",
                        "    return v;\n  } else if constexpr (TIER == TIER_F16) {")],
}


def make_variant(name: str) -> str:
    """A copy of this checkout's package with the variant's edits; returns
    its root."""
    root = VARIANT_DIR / name
    pkg = root / "accblas_tpu_torch"
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(HERE / "accblas_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in VARIANTS[name]:
        path = pkg / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {rel} holds {text.count(old)} of {old!r}")
        path.write_text(text.replace(old, new))
    return str(root)


def host_us(fn, reps: int = 2000) -> float:
    """Median host us of a call of `fn`, timed one by one, the card drained
    every 100 calls outside the timed ones (chip_smoke.py's host_us)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if i % 100 == 99:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return sorted(times)[reps // 2] * 1e6


def dot_host_split(dotops, build, call) -> dict:
    """Host us of a DOT call, of its checks alone (`_dot_cuda` stubbed out)
    and of its bare ctypes call with the arguments it passed."""
    import torch

    res = torch.zeros(2, device="cuda").unbind()  # (hi, lo) for either tree's caller
    real_cuda, real_fn, seen = dotops._dot_cuda, build.function, []

    def spy(lib, name, argtypes):
        fn = real_fn(lib, name, argtypes)
        return lambda *args: seen.append((fn, args)) or fn(*args)

    out = {"call": host_us(call)}
    dotops._dot_cuda = lambda *args: res
    try:
        out["checks"] = host_us(call)
    finally:
        dotops._dot_cuda = real_cuda
    build.function = spy
    try:
        kept = call()  # noqa: F841 (keeps the output the arguments point to)
    finally:
        build.function = real_fn
    (fn, args), = seen
    out["ctypes"] = host_us(lambda: fn(*args))
    return out


# the main path's kernels, by their source
MAIN_KERNELS = {"dot": ("dot_reduce",), "gemv": ("gemv_rows", "gemv_staged"),
                "trsv": ("trsv_sweep",)}
GEMV_KERNELS = MAIN_KERNELS["gemv"]
# SASS conversion opcodes (by the opcode's base), and f16 -> f32 on the FMA pipe
_CONVERSIONS = ("F2FP", "F2F", "I2F", "F2I", "I2FP", "F2IP")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/cuobjdump"):
        return "/usr/local/cuda/bin/cuobjdump"
    raise SystemExit("cuobjdump not found")


def _demangle(names: list[str]) -> list[str]:
    return subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True,
                          check=True).stdout.split("\n")[:len(names)]


def _is_global_access(op: str) -> bool:
    """A load or store of device memory: LDG/STG, a generic LD/ST, or an
    atomic or reduction there (not shared, constant or local memory)."""
    base = op.split(".")[0]
    return base in ("LDG", "STG", "LD", "ST", "ATOMG", "ATOM", "RED", "REDG")


def _is_conversion(op: str) -> bool:
    return op.split(".")[0] in _CONVERSIONS or op == "HADD2.F32"


def sass_counts(lib: str, kernels) -> dict:
    """{instantiation: {opcode with modifiers: count}} of the global loads
    and stores of `kernels`' instantiations in the library's SASS, with the
    number of its instructions ("sass_ops"), a hash of their opcode
    sequence, operands left out ("sass_hash": equal where the code differs
    at most in its registers and addresses), and its conversion
    instructions by opcode ("conversions")."""
    sass = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    ops, name = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = m.group(1)
            ops[name] = []
        elif name and (m := re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                                     line)):
            ops[name].append(m.group(1))
    out = {}
    for pretty, seq in zip(_demangle(list(ops)), ops.values()):
        if any(k in pretty for k in kernels):
            c = collections.Counter(op for op in seq if _is_global_access(op))
            cv = collections.Counter(op for op in seq if _is_conversion(op))
            out[pretty] = {**dict(sorted(c.items())), "sass_ops": len(seq),
                           "sass_hash": hashlib.sha256("\n".join(seq).encode()).hexdigest()[:12],
                           "conversions": dict(sorted(cv.items()))}
    return out


def ptxas_counts(log: str, kernels) -> dict:
    """{instantiation: [registers, spill bytes]} of `kernels` from ptxas -v."""
    found, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = m.group(1)
            found[name] = [0, 0]
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                      line)):
            found[name][1] = int(m.group(1)) + int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            found[name][0] = int(m.group(1))
    return {p: rs for p, rs in zip(_demangle(list(found)), found.values())
            if any(k in p for k in kernels)}


def static_facts(root: str) -> dict:
    """For each main-path source of the tree at `root`: nvcc's seconds
    compiling it alone with the tree's flags, ptxas' registers and spills,
    and the SASS global access counts of its kernel."""
    sys.path.insert(0, root)
    from accblas_tpu_torch.ops import _build

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src, kernels in MAIN_KERNELS.items():
            lib = os.path.join(tmp, f"lib{src}.so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build._CSRC), "-o", lib,
                   str(_build._CSRC / f"{src}.cu")]
            t0 = time.perf_counter()
            done = subprocess.run(cmd, capture_output=True, text=True, check=True)
            seconds = time.perf_counter() - t0
            regs = ptxas_counts(done.stdout + done.stderr, kernels)
            sass = sass_counts(lib, kernels)
            total = collections.Counter()
            for c in sass.values():
                total.update({k: v for k, v in c.items()
                              if k not in ("sass_ops", "sass_hash", "conversions")})
            out[src] = {"build_s": round(seconds, 1), "kernel": ", ".join(kernels),
                        "instantiations": len(regs),
                        "registers": [min(r for r, _ in regs.values()),
                                      max(r for r, _ in regs.values())],
                        "spill_bytes": max(sp for _, sp in regs.values()),
                        "global_access": dict(sorted(total.items())),
                        "per_instantiation": {p: {"registers": regs.get(p, [0, 0])[0],
                                                  "spill": regs.get(p, [0, 0])[1], **c}
                                              for p, c in sass.items()}}
    return out


def child(root: str, reps: int, build_only: bool) -> None:
    sys.path.insert(0, root)
    import torch

    from accblas_tpu_torch.ops import _build
    from accblas_tpu_torch.ops import dot as dotops
    from accblas_tpu_torch.ops import gemv as gemvops
    from accblas_tpu_torch.ops import generic as gen
    from accblas_tpu_torch.ops import trsv as trsvops

    _build.build("generic", "dot", "gemv", "trsv")
    if build_only:
        return
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    n = 16384
    a, x, r = (torch.rand(s, device=dev, generator=g) * 2 - 1 for s in ((n, n), (n,), (n,)))
    parent = torch.rand(16384, 32768, device=dev, generator=g) * 2 - 1
    other = torch.rand(16384, 32768, device=dev, generator=g) * 2 - 1

    def best(fn) -> float:
        fn()
        torch.cuda.synchronize()
        out = float("inf")
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out = min(out, start.elapsed_time(end))
        return out

    def result_bytes(out) -> bytes:
        words = [out.hi, out.lo] if isinstance(out, tuple) else [out]
        return b"".join(w.float().cpu().numpy().tobytes() for w in words)

    def device_ms(fn, kernel) -> float:
        """The mean device ms of the records of `kernel` (a name, or a tuple
        of names) over 10 calls (torch.profiler): one record a call for the
        main path's kernels."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        names = (kernel,) if isinstance(kernel, str) else kernel
        recs = [e for e in prof.key_averages() if any(k in e.key for k in names)]
        count = sum(e.count for e in recs)
        return sum(e.self_device_time_total for e in recs) / count / 1e3 if count else None

    row = {"tree": str(Path(gen.__file__).resolve().parents[2])}
    bits = {}

    def timed(label: str, fn, kernel: str | None = None):
        """The row's minimum, the hash of its result's bits, and for a
        main-path kernel its device ms ("<label> device")."""
        bits[label] = hashlib.sha256(result_bytes(fn())).hexdigest()[:16]
        row[label] = best(fn)
        if kernel:
            row[f"{label} device"] = device_ms(fn, kernel)

    for st, ar in PAIRS:
        dt = torch.float32 if st == "f32" else torch.bfloat16
        a_st, x_st, p_st, o_st = a.to(dt), x.to(dt), parent.to(dt), other.to(dt)
        calls = {"axpy": lambda: gen.axpy(p_st, o_st, ar, "f32"),
                 "axpy V=1 one column on": lambda: gen.axpy(p_st[:, 1:], o_st[:, 1:], ar, "f32"),
                 "gemv": lambda: gen.gemv_generic(a_st, x_st, r, ar, "f32"),
                 "window": lambda: gen.window_sum(p_st, 4096, 8192, 8192, 16384, ar)}
        for kind, fn in calls.items():
            timed(f"{kind} {st}/{ar}", fn)
        del a_st, x_st, p_st, o_st
        torch.cuda.empty_cache()
    del parent, other
    torch.cuda.empty_cache()

    # the GEMV: the main path's Acc<f32,bf16> (beta = 0) and the flagship,
    # the tiers the TPU ran on its full-row kernel, the f8 probes' forms,
    # and one element off alignment (the element-load body)
    bf, f16, f8 = torch.bfloat16, torch.float16, torch.float8_e4m3fn
    ab, xb = a.to(bf), x.to(bf)
    fl = torch.rand(1024 * 2048 + 2048 + 1024, device=dev, generator=g) * 2 - 1
    fa, fx, fr = fl[:1024 * 2048].view(1024, 2048).to(bf), fl[-3072:-1024].to(bf), fl[-1024:]
    timed("gemv Acc<f32,bf16> 16384^2",
          lambda: gemvops.acc_gemv(ab, xb, r, 1.0, 0.0, "f32"), "gemv_rows")
    timed("gemv Acc<f32,bf16> 1024x2048",
          lambda: gemvops.acc_gemv(fa, fx, fr, 1.0, 1.0, "f32"), "gemv_rows")
    timed("gemv fixed f32 16384^2",
          lambda: gemvops.gemv(a, x, r, 1.0, 0.0), "gemv_rows")
    timed("gemv Acc<df64,f32> fast 16384^2",
          lambda: gemvops.acc_gemv(a, x, r, 1.0, 0.0, "df64"), "gemv_rows")
    timed("gemv Acc<df64,f32> precise 16384^2",
          lambda: gemvops.acc_gemv(a, x, r, 1.0, 0.0, "df64", precise=True), "gemv_rows")
    flat = torch.empty(n * n + 1, device=dev, dtype=bf)
    off_b = flat[1:].view(n, n)
    off_b.copy_(ab)
    timed("gemv Acc<f32,bf16> 16384^2 one element off",
          lambda: gemvops.acc_gemv(off_b, xb, r, 1.0, 0.0, "f32"), "gemv_rows")
    del flat, off_b, ab
    torch.cuda.empty_cache()
    flat = torch.empty(n * n + 1, device=dev)
    off_f = flat[1:].view(n, n)
    off_f.copy_(a)
    timed("gemv fixed f32 16384^2 one element off",
          lambda: gemvops.gemv(off_f, x, r, 1.0, 0.0), "gemv_rows")
    del flat, off_f
    torch.cuda.empty_cache()
    n8 = 24576
    a8 = (torch.rand(n8, n8, device=dev, generator=g) * 2 - 1).to(f8)
    x8f = torch.rand(n8, device=dev, generator=g) * 2 - 1
    x8, r8 = x8f.to(f8), torch.zeros(n8, device=dev)
    timed("gemv Acc<f32,f8e4m3> 24576^2 f32 x",
          lambda: gemvops.acc_gemv(a8, x8f, r8, 1.0, 0.0, "f32"), "gemv_rows")
    # f8 x: gemv_staged on a tree that has it, gemv_rows on one that does not
    timed("gemv Acc<f32,f8e4m3> 24576^2 f8 x",
          lambda: gemvops.acc_gemv(a8, x8, r8, 1.0, 0.0, "f32"), GEMV_KERNELS)
    x5 = x8f.to(torch.float8_e5m2)
    timed("gemv Acc<f32,f8e4m3 A, f8e5m2 x> 24576^2",
          lambda: gemvops.acc_gemv(a8, x5, r8, 1.0, 0.0, "f32"), GEMV_KERNELS)
    for ar, precise, name in (("bf16", False, "Acc<bf16,f8e4m3>"),
                              ("df64", False, "Acc<df64,f8e4m3> fast"),
                              ("df64", True, "Acc<df64,f8e4m3> precise")):
        timed(f"gemv {name} 24576^2 f8 x",
              lambda: gemvops.acc_gemv(a8, x8, r8, 1.0, 0.0, ar, precise=precise), GEMV_KERNELS)
    flat = torch.empty(n8 * n8 + 1, device=dev, dtype=f8)
    off_8 = flat[1:].view(n8, n8)
    off_8.copy_(a8)
    del a8
    timed("gemv Acc<f32,f8e4m3> 24576^2 f8 x one element off",
          lambda: gemvops.acc_gemv(off_8, x8, r8, 1.0, 0.0, "f32"), GEMV_KERNELS)
    del flat, off_8, x8f, x8, x5, r8
    torch.cuda.empty_cache()

    # the TRSV sweep at 16384 on a unit upper uniform(-1, 1) / n triangle:
    # the kernel alone (phase 1 once, outside), and the whole call
    at = a.mul(1.0 / n)
    del a
    torch.cuda.empty_cache()
    nb = n // trsvops.BLOCK
    inv = trsvops._leaf_inverses(
        trsvops._extract_leaf_diag(at, nb * trsvops.BLOCK // trsvops.LEAF, False, True), False)
    ones = torch.ones(n, 1, device=dev)
    bt1 = trsvops._rhs_panels(ones, nb)
    bt8 = trsvops._rhs_panels(torch.rand(n, 8, device=dev, generator=g), nb)
    for ar in ("f32", "df64"):
        timed(f"trsv_sweep {ar} 16384",
              lambda: trsvops._trsv_sweep_cuda(at, inv, bt1, False, ar, torch.float32),
              "trsv_sweep")
    timed("trsv_sweep f32 16384 k=8",
          lambda: trsvops._trsv_sweep_cuda(at, inv, bt8, False, "f32", torch.float32),
          "trsv_sweep")
    timed("trsv f32 16384 (the call)", lambda: trsvops.trsv(at, ones[:, 0], "upper", True))
    flat = torch.empty(n * n + 1, device=dev)
    off_t = flat[1:].view(n, n)
    off_t.copy_(at)
    timed("trsv_sweep f32 16384 one element off",
          lambda: trsvops._trsv_sweep_cuda(off_t, inv, bt1, False, "f32", torch.float32),
          "trsv_sweep")
    del flat, off_t, at, inv, bt1, bt8, x, r
    torch.cuda.empty_cache()

    # the DOT: the main path's Acc<f32,bf16> at 2^29, then every tier at
    # 2^27, and one element off alignment (the element-load body)
    xb, yb = (torch.rand(2**29, device=dev, generator=g).mul_(2).sub_(1).to(bf) for _ in "xy")
    main = lambda: dotops.acc_dot(xb, yb, "f32")  # noqa: E731
    timed("dot Acc<f32,bf16> 2^29", main, "dot_reduce")
    row["dot host us Acc<f32,bf16> 2^29"] = dot_host_split(dotops, _build, main)
    del xb, yb
    torch.cuda.empty_cache()
    x27, y27 = (torch.rand(2**27 + 17, device=dev, generator=g) * 2 - 1 for _ in "xy")
    xs, ys = x27[:2**27], y27[:2**27]
    xb, yb, xh, yh = xs.to(bf), ys.to(bf), xs.to(f16), ys.to(f16)
    xbo, ybo = x27.to(bf)[1:2**27 + 1], y27.to(bf)[1:2**27 + 1]
    x8, y8 = xs.to(f8), ys.to(f8)
    dots = {"Acc<f32,f32> 2^27": lambda: dotops.acc_dot(xs, ys, "f32"),
            "Acc<f32,f32> 2^27 + 17": lambda: dotops.acc_dot(x27, y27, "f32"),
            "Acc<f32,bf16> 2^27": lambda: dotops.acc_dot(xb, yb, "f32"),
            "fixed bf16 2^27": lambda: dotops.dot(xb, yb),
            "fixed f16 2^27": lambda: dotops.dot(xh, yh),
            "Acc<df64,f32> fast 2^27": lambda: dotops.acc_dot(xs, ys, "df64"),
            "Acc<df64,f32> precise 2^27": lambda: dotops.acc_dot(xs, ys, "df64", precise=True),
            "Acc<f32,f8e4m3> 2^27": lambda: dotops.acc_dot(x8, y8, "f32"),
            "fixed bf16 over f8e4m3 2^27": lambda: dotops.acc_dot(x8, y8, "bf16"),
            "Acc<f32,f32> 2^27 one element off":
                lambda: dotops.acc_dot(x27[1:2**27 + 1], y27[1:2**27 + 1], "f32"),
            "Acc<f32,bf16> 2^27 one element off": lambda: dotops.acc_dot(xbo, ybo, "f32")}
    for label, fn in dots.items():
        timed(f"dot {label}", fn, "dot_reduce")
    row["dot host us Acc<f32,f32> 2^27"] = dot_host_split(dotops, _build, dots["Acc<f32,f32> 2^27"])
    t = torch.zeros(2, device=dev)
    row["torch host us"] = {"torch.empty(2)": host_us(lambda: torch.empty(2, device=t.device)),
                            "new_empty(2)": host_us(lambda: t.new_empty(2)),
                            "out[0], out[1]": host_us(lambda: (t[0], t[1])),
                            "unbind": host_us(t.unbind),
                            "torch.dot 2^27": host_us(lambda: torch.dot(xs, ys))}
    row["bits"] = bits
    print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="root of the other checkout")
    ap.add_argument("--variants", nargs="?", const=",".join(VARIANTS), default="",
                    help="time these design variants too (a comma list; all if none named)")
    ap.add_argument("--sass", action="store_true",
                    help="compile dot.cu, gemv.cu and trsv.cu of each tree alone and print "
                         "their build seconds, registers and SASS global access counts")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--static", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child and args.static:
        print(json.dumps(static_facts(args.child)), flush=True)
        return 0
    if args.child:
        child(args.child, args.reps, args.build_only)
        return 0
    if not args.baseline and not args.variants:
        ap.error("give --baseline, --variants or both")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    this = str(HERE)
    trees = ([str(Path(args.baseline).resolve())] if args.baseline else []) + [this]
    if args.variants:
        trees += [make_variant(name) for name in args.variants.split(",")]
    cmd = [sys.executable, __file__, "--reps", str(args.reps), "--child"]
    # this tree first: a variant reuses its libraries where its sources are
    # the same (the file name carries their hash), then the rest at once
    first = subprocess.run(cmd + [this, "--build-only"], capture_output=True, text=True)
    if first.returncode:
        sys.stdout.write(first.stdout + first.stderr)
        return 1
    built = HERE / "build" / "accblas_tpu_torch"
    for root in trees:
        if root.startswith(str(VARIANT_DIR)):
            dest = Path(root) / "build" / "accblas_tpu_torch"
            dest.mkdir(parents=True, exist_ok=True)
            for lib in built.glob("lib*"):
                shutil.copy2(lib, dest / lib.name)
    builds = [(root, subprocess.Popen(cmd + [root, "--build-only"], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
              for root in trees if root != this]
    for root, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode:
            if not root.startswith(str(VARIANT_DIR)):
                sys.stdout.write(log)
                return 1
            print(json.dumps({"tree": root, "build": "failed", "log": log[-3000:]}), flush=True)
            trees.remove(root)
    if args.sass:
        facts = {}
        for root in trees:
            out = subprocess.run(cmd + [root, "--static"], capture_output=True, text=True)
            if out.returncode:
                sys.stdout.write(out.stdout + out.stderr)
                return 1
            facts[root] = json.loads(out.stdout.strip().splitlines()[-1])
            for src, f in facts[root].items():
                print(json.dumps({"tree": root, "source": f"{src}.cu",
                                  **{k: v for k, v in f.items() if k != "per_instantiation"}}),
                      flush=True)
            print(json.dumps({"tree": root, "conversions": {
                p[p.index("gemv_"):p.index(">(") + 1]: {k: c[k] for k in ("conversions",
                                                                          "sass_ops")}
                for p, c in facts[root]["gemv"]["per_instantiation"].items()
                if "<__nv_fp8_e4m3, __nv_fp8_e4m3, 0>" in p}}), flush=True)
        for root in trees:
            if root == this:
                continue
            for src, f in facts[root].items():
                mine = facts[this][src]["per_instantiation"]
                theirs = f["per_instantiation"]
                differ = {p: {"this": mine.get(p), "other": theirs.get(p)}
                          for p in sorted(set(mine) | set(theirs)) if mine.get(p) != theirs.get(p)}
                print(json.dumps({"sass_and_registers_differ": f"{src}.cu", "tree": root,
                                  "instantiations": len(differ), "of": len(mine),
                                  "differences": differ}), flush=True)
    bits = {}
    for root in trees + trees[::-1]:
        out = subprocess.run(cmd + [root], capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr)
        if out.returncode:
            return 1
        bits[root] = json.loads(out.stdout.strip().splitlines()[-1])["bits"]
    differ = {root: [k for k in b if b[k] != bits[this].get(k)] for root, b in bits.items()
              if b != bits[this]}
    print(json.dumps({"bits_differ_from_this_tree": differ}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
