"""Time the generic kernels (``csrc/generic.cu``) of this checkout beside
another checkout's, in turns, on one card.

    python3 scripts/torch_generic_ab.py --baseline OTHER_ROOT [--reps 20]

OTHER_ROOT is the root of another checkout: its ``accblas_tpu_torch`` is
imported from there and built into its own ``build/``. Both libraries are
built first, at once; then each tree is timed in a process of its own in
the order baseline, this, this, baseline, so that a drift of the card
shows as a gap between the two readings of one tree. Each line is one
process: ``gemv_generic`` at 16384^2 and ``window_sum`` of the (8192,
16384) window at (4096, 8192) of a (16384, 32768) parent, at f32/f32,
bf16/f32 and f32/df64, as CUDA-event minima in ms. Compare trees only
within one run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
PAIRS = (("f32", "f32"), ("bf16", "f32"), ("f32", "df64"))


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
    for st, ar in PAIRS:
        dt = torch.float32 if st == "f32" else torch.bfloat16
        a_st, x_st, p_st = a.to(dt), x.to(dt), parent.to(dt)
        row[f"gemv {st}/{ar}"] = best(lambda: gen.gemv_generic(a_st, x_st, r, ar, "f32"))
        row[f"window {st}/{ar}"] = best(lambda: gen.window_sum(p_st, 4096, 8192, 8192, 16384, ar))
    print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child, args.reps, args.build_only)
        return 0
    if not args.baseline:
        ap.error("--baseline is required")
    base, this = str(Path(args.baseline).resolve()), str(HERE)
    cmd = [sys.executable, __file__, "--reps", str(args.reps), "--child"]
    builds = [subprocess.Popen(cmd + [root, "--build-only"]) for root in (base, this)]
    if any(p.wait() for p in builds):
        return 1
    for root in (base, this, this, base):
        if subprocess.call(cmd + [root]):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
