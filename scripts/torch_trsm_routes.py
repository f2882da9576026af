#!/usr/bin/env python3
"""Variants of the blocked TRSM composition (accblas_tpu_torch.ops.trsv
``_trsv_small`` / ``_trsm_small_df64``), timed and checked side by side on
a CUDA card:

- the f32 composition with the refinement as its gate sets it and forced
  on, and the df64 composition, at each block size;
- for bf16 storage at k < 32, the shipped composition (A cast to f32 once,
  upfront);
- "f32 tf32": the f32 composition with TF32 products, the fault its
  ``ieee_f32()`` guard keeps out: the error a bound on the composition
  must catch;
- the sweep and ``xla_trsm`` at the same point.

    python3 scripts/torch_trsm_routes.py [--n 16384] [--k 1 64] [--blocks 512]

The operand is the LU factor of the TRSV driver's fp64 master (its disk
cache, as chip_smoke.py uses it; upper, non-unit), the right-hand sides the
card's seeded draw. Each line: the variant, its relative 1-norm error
against the float64 solve of the stored triangle, its CUDA-event ms (1
warm-up, 10 reps, minimum), its device records and device ms per call
(chip_smoke.profile_calls) and its event and host ms (medians of the same
calls, chip_smoke.paired_ms). A CPU-op profile of the shipped f32
composition at the first n and k follows (host time by op).
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from accblas_tpu_torch.ops import trsv as tt  # noqa: E402


@contextlib.contextmanager
def _tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def tf32_products(fn):
    """`fn()` with the compositions' ``ieee_f32()`` guard swapped for one
    that turns TF32 on."""
    real = tt.ieee_f32
    tt.ieee_f32 = _tf32
    try:
        return fn()
    finally:
        tt.ieee_f32 = real


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, nargs="+", default=[16384])
    p.add_argument("--k", type=int, nargs="+", default=[1, 64])
    p.add_argument("--blocks", type=int, nargs="+", default=[512])
    args = p.parse_args(argv)
    from accblas_tpu_torch.bench import trsv_benchmark
    from accblas_tpu_torch.utils import devgen
    from accblas_tpu_torch.utils.bench import benchmark_function

    if not torch.cuda.is_available():
        raise SystemExit("torch_trsm_routes: no CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    lu64 = trsv_benchmark.lu_cached(max(chip_smoke.N_TRSV, *args.n), chip_smoke.SEED, dev)
    for n in args.n:
        a = torch.from_numpy(lu64[:n, :n].astype(np.float32)).to(dev)
        bmax = devgen.gen_f32((n, max(args.k)), chip_smoke.SEED, "trsv_b", device=dev)
        ref = chip_smoke._solve64(a, bmax, "upper", False)
        for k in args.k:
            b, r = bmax[:, :k].contiguous(), ref[:, :k]
            for block in args.blocks:
                variants = {
                    "f32": lambda: tt._trsv_small(a, b, "upper", False, "f32", block=block),
                    "f32 refine": lambda: tt._trsv_small(a, b, "upper", False, "f32",
                                                         block=block, refine=True),
                    "f32 tf32": lambda: tf32_products(lambda: tt._trsv_small(
                        a, b, "upper", False, "f32", block=block)),
                    "df64": lambda: tt._trsm_small_df64(a, b, "upper", False, "f32",
                                                        block=block),
                }
                refs = {name: r for name in variants}
                if k < 32:
                    abf = a.to(torch.bfloat16)
                    variants["bf16"] = lambda: tt._trsv_small(abf, b, "upper", False, "f32",
                                                              block=block)
                    refs["bf16"] = chip_smoke._solve64(abf, b, "upper", False)
                for name, fn in variants.items():
                    err = chip_smoke._rel1(fn(), refs[name])
                    ms = benchmark_function(fn)
                    ev, host = chip_smoke.paired_ms(fn)
                    _, dev_ms, records = chip_smoke.profile_calls(name, fn, {}, calls=3, top=0)
                    print(f"variant n={n} k={k} block={block} {name}: err={err:.3e} "
                          f"{ms:.4f} ms {records:g} records device {dev_ms:.4f} ms median "
                          f"event {ev:.4f} host {host:.4f} ms", flush=True)
            for name, fn in (("sweep f32", lambda: tt.trsm(a, b, "upper", False, resident=False)),
                             ("xla", lambda: tt.xla_trsm(a, b, "upper", False))):
                print(f"variant n={n} k={k} {name}: err={chip_smoke._rel1(fn(), r):.3e} "
                      f"{benchmark_function(fn):.4f} ms", flush=True)
    # host time by op of the shipped f32 composition at the first point
    from torch.profiler import ProfilerActivity, profile

    n, k = args.n[0], args.k[0]
    a = torch.from_numpy(lu64[:n, :n].astype(np.float32)).to(dev)
    b = devgen.gen_f32((n, k), chip_smoke.SEED, "trsv_b", device=dev)
    tt._trsv_small(a, b, "upper", False, "f32")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            tt._trsv_small(a, b, "upper", False, "f32")
        torch.cuda.synchronize()
    print(f"host profile of _trsv_small n={n} k={k}, 3 calls:", flush=True)
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=18), flush=True)


if __name__ == "__main__":
    main()
