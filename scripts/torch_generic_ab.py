"""Time the generic kernels (``csrc/generic.cu``) of this checkout beside
another checkout's and beside design variants of this one, in turns, on one
card.

    python3 scripts/torch_generic_ab.py [--baseline OTHER_ROOT] [--variants]
                                        [--reps 20]

OTHER_ROOT is the root of another checkout: its ``accblas_tpu_torch`` is
imported from there and built into its own ``build/``. ``--variants`` adds
copies of this checkout's package under ``build/generic_variants/<name>/``,
each with one design choice changed in the text (``VARIANTS``): 8 GEMV
warps a block instead of 4, 8 vector steps in flight instead of 16, x
staged once a block in shared memory as the arithmetic type (the grid then
capped at the blocks the card holds at once) instead of read through L1,
and A and the window read through L1 instead of past it.

All libraries are built first, at once; then each tree is timed in a
process of its own, forward and backward through the list (baseline, this,
variants..., variants..., this, baseline), so that a drift of the card
shows as a gap between the two readings of one tree. Each line is one
process: ``axpy`` over (16384, 32768), ``gemv_generic`` at 16384^2 and
``window_sum`` of the (8192, 16384) window at (4096, 8192) of a (16384,
32768) parent, at f32/f32, bf16/f32 and f32/df64, as CUDA-event minima in
ms, and a hash of each result's bits; the last line says which trees'
bits differ from this one's. Prints the card's name and power limit first.
Compare trees only within one run.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
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

# name: [(file under accblas_tpu_torch/, text, replacement), ...]
VARIANTS = {
    "warps8": [("csrc/generic.cu", "constexpr int kGemvWarps = 4;",
                "constexpr int kGemvWarps = 8;"),
               ("ops/generic.py", "_GEMV_ROWS = 4 ", "_GEMV_ROWS = 8 ")],
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


def child(root: str, reps: int, build_only: bool) -> None:
    sys.path.insert(0, root)
    import torch

    from accblas_tpu_torch.ops import _build
    from accblas_tpu_torch.ops import generic as gen

    _build.build("generic")
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

    row = {"tree": str(Path(gen.__file__).resolve().parents[2])}
    bits = hashlib.sha256()
    for st, ar in PAIRS:
        dt = torch.float32 if st == "f32" else torch.bfloat16
        a_st, x_st, p_st, o_st = a.to(dt), x.to(dt), parent.to(dt), other.to(dt)
        calls = {"axpy": lambda: gen.axpy(p_st, o_st, ar, "f32"),
                 "gemv": lambda: gen.gemv_generic(a_st, x_st, r, ar, "f32"),
                 "window": lambda: gen.window_sum(p_st, 4096, 8192, 8192, 16384, ar)}
        for kind, fn in calls.items():
            bits.update(fn().cpu().numpy().tobytes())
            row[f"{kind} {st}/{ar}"] = best(fn)
        del a_st, x_st, p_st, o_st
        torch.cuda.empty_cache()
    row["bits"] = bits.hexdigest()[:16]
    print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="root of the other checkout")
    ap.add_argument("--variants", nargs="?", const=",".join(VARIANTS), default="",
                    help="time these design variants too (a comma list; all if none named)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
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
    builds = [subprocess.Popen(cmd + [root, "--build-only"]) for root in trees]
    if any(p.wait() for p in builds):
        return 1
    bits = {}
    for root in trees + trees[::-1]:
        out = subprocess.run(cmd + [root], capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr)
        if out.returncode:
            return 1
        bits[root] = json.loads(out.stdout.strip().splitlines()[-1])["bits"]
    differ = [root for root, b in bits.items() if b != bits[this]]
    print(json.dumps({"bits_differ_from_this_tree": differ}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
