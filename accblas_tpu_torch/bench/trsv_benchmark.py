"""TRSV/TRSM benchmark driver, the ``trsv_benchmark`` executable analogue
(reference ``cuda/trsv_benchmark.cu``; counterpart of
``accblas_tpu.bench.trsv_benchmark``, with its columns and CSV).

    python -m accblas_tpu_torch.bench.trsv_benchmark [--error] [--nrhs K] [--no-unit] [--device cpu]

The fp64 master matrix is LU-factorized once at the maximum size by
``torch.linalg.lu_factor`` in float64 on the driver's device (cuSOLVER getrf
on a card: the reference's ``cusolverDnDgetrf`` role,
``cuda/trsv_memory.cuh:150-163``), so its triangles are realistic factors,
and cached on disk (``lu_cached``); the sweep solves on leading blocks.
Upper triangle, unit diagonal: the reference's benchmark mode
(``cuda/trsv_benchmark.cu:26-27``); the unit-upper triangle of an LU factor
is ill-conditioned, so error studies pass ``--no-unit``. FLOP count n² (the
triangle's multiply-adds); error mode is the 1-norm relative error against a
scipy fp64 solve of the master's triangle, each variant run once, untimed,
plus the df64-refinement device oracle (``ops.oracle.trsv_df64``).

``--nrhs K`` times TRSM (T X = B, B of shape (n, K)); FLOP count n²·K.

**Cold and warm columns.** The JAX driver's "cold" columns re-do the leaf
inversion (phase 1) inside its timing loop, which XLA otherwise hoists. In
eager torch nothing is hoisted: every call re-does phase 1, so a cold and a
warm column time the same work. Both headers stay for CSV parity.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from . import common

MIN_SIZE = 128
DEFAULT_SIZE = 16384
ALIGN = 128
UPLO, UNIT = "upper", True  # reference: tmtx_t::upper, dmtx_t::unit
SEED = 42


def cache_dir() -> Path:
    """Where factors are cached: $ACCBLAS_TORCH_CACHE, else
    ``build/accblas_tpu_torch/cache`` in the checkout."""
    from ..ops._build import BUILD_DIR

    env = os.environ.get("ACCBLAS_TORCH_CACHE")
    return Path(env) if env else BUILD_DIR / "cache"


def lu_cached(max_n: int, seed: int, device) -> np.ndarray:
    """The packed LU factor of the seeded fp64 master, disk-cached per
    (seed, size, device type): the speed and error runs of the driver then
    solve the identical factor (the reference factorizes once per process)."""
    from ..utils import MatrixInfo, gen_mtx
    from ..utils.memory import lu_factor64

    dev = torch.device(device)
    path = cache_dir() / f"lu64_seed{seed}_n{max_n}_{dev.type}.npy"
    if path.exists():
        return np.load(path)
    lu64 = lu_factor64(gen_mtx(MatrixInfo(max_n, max_n), seed=seed), dev)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp.npy")
        np.save(tmp, lu64)
        os.replace(tmp, path)  # atomic: a concurrent reader sees all or nothing
    except OSError as e:
        common.progress(f"LU cache not written ({e})")
    return lu64


def main(argv=None):
    def extra(p):
        p.add_argument("--uplo", choices=["upper", "lower"], default=UPLO)
        p.add_argument("--no-unit", dest="unit", action="store_false", default=UNIT,
                       help="non-unit diagonal (the reference hardcodes unit; unit-upper on "
                       "an LU factor is ill-conditioned, so error studies pass --no-unit)")
        p.add_argument("--nrhs", type=int, default=0,
                       help="benchmark TRSM with this many right-hand sides (0 = TRSV)")
        p.add_argument("--only", default=None,
                       help="speed mode: only the columns whose name contains this "
                       "substring")

    args = common.parse_args("trsv_benchmark", DEFAULT_SIZE, MIN_SIZE, extra=extra, argv=argv)
    import scipy.linalg

    from ..native import host
    from ..ops import oracle
    from ..ops import trsv as trsvops
    from ..utils import MatrixInfo, gen_mtx
    from ..utils.compare import relative_error
    from ..utils.memory import lead

    uplo, unit, nrhs, dev = args.uplo, args.unit, args.nrhs, args.device
    sizes = common.sweep_sizes(args, MIN_SIZE, ALIGN, dense_step=1024)
    max_n = max(sizes)
    common.progress(f"host master data: {host.describe()}")

    lu64 = lu_cached(max_n, SEED, dev)
    b64 = gen_mtx(MatrixInfo(max_n, nrhs) if nrhs else MatrixInfo(1, max_n), seed=SEED + 1)
    if not nrhs:
        b64 = b64[0]
    a32_full = torch.from_numpy(lu64.astype(np.float32)).to(dev)
    b32_full = torch.from_numpy(b64.astype(np.float32)).to(dev)

    op = "TRSM" if nrhs else "TRSV"
    solve = trsvops.trsm if nrhs else trsvops.trsv
    acc_solve = trsvops.acc_trsm if nrhs else trsvops.acc_trsv
    vendor_solve = trsvops.xla_trsm if nrhs else trsvops.xla_trsv
    flops = (lambda n: n * n * nrhs) if nrhs else (lambda n: n * n)

    # (column, storage of A, solve(a, b)); narrow storage opts out of the
    # bf16 envelope warning, as the JAX driver's columns do
    def acc(ar, **kw):
        return lambda a, b: acc_solve(a, b, uplo, unit, ar=ar, **kw)

    columns = [
        (f"{op} fp32", torch.float32, lambda a, b: solve(a, b, uplo, unit)),
        (f"{op} fp32 cold", torch.float32, lambda a, b: solve(a, b, uplo, unit)),
        (f"{op} Acc<f32,f32>", torch.float32, acc("f32")),
        (f"{op} Acc<f32,bf16>", torch.bfloat16, acc("f32", unstable_ok=True)),
        (f"{op} Acc<f32,f16>", torch.float16, acc("f32", unstable_ok=True)),
        (f"{op} Acc<f32,f8e4m3>", torch.float8_e4m3fn, acc("f32", unstable_ok=True)),
        (f"{op} Acc<df64,f32>", torch.float32, acc("df64")),
        (f"{op} Acc<df64,f32> cold", torch.float32, acc("df64")),
        (f"torch {op} fp32", torch.float32, lambda a, b: vendor_solve(a, b, uplo, unit)),
    ]
    if args.error:
        if args.only:
            raise SystemExit("--only is speed-mode only")
        # cold columns time the warm ones' work; the f8 error is out of the
        # benched matrix (O(1) on LU-factor triangles), as in the JAX driver
        columns = [c for c in columns if not (c[0].endswith(" cold") or "f8e4m3" in c[0])]
    if args.only:
        columns = [c for c in columns if args.only.lower() in c[0].lower()]
        if not columns:
            raise SystemExit(f"--only {args.only!r} matches no column")
    names = [c[0] for c in columns]
    with_oracle = args.error and not nrhs
    if with_oracle:
        names.append(f"{op} df64 oracle (device)")
    common.emit_header("n", names)
    storages = {st: a32_full.to(st) for _, st, _ in columns}

    if with_oracle:
        # split of the solved triangle itself (masked, unit diagonal
        # materialized) for the refinement oracle (ops.oracle.trsv_df64)
        t64 = torch.from_numpy(lu64).to(dev)
        t64 = torch.triu(t64) if uplo == "upper" else torch.tril(t64)
        if unit:
            t64.fill_diagonal_(1.0)
        th_full = t64.float()
        tl_full = (t64 - th_full.double()).float()
        del t64
        bl_full = torch.from_numpy((b64 - b64.astype(np.float32)).astype(np.float32)).to(dev)

    timer = None if args.error else common.timer(dev)
    run = common.run_once(dev)
    for n in sizes:
        b = b32_full[:n]
        a_n = {st: lead(a, n) for st, a in storages.items()}
        if args.error:
            t = np.triu(lu64[:n, :n]) if uplo == "upper" else np.tril(lu64[:n, :n])
            if unit:
                np.fill_diagonal(t, 1.0)
            ref = scipy.linalg.solve_triangular(t, b64[:n], lower=(uplo == "lower"),
                                                unit_diagonal=unit)
            vals = [common.guarded(
                lambda: relative_error(run(lambda: fn(a_n[st], b)).double().cpu().numpy(), ref),
                f"{nm} n={n}") for nm, st, fn in columns]
            if with_oracle:
                def eval_oracle():
                    x = run(lambda: oracle.trsv_df64(lead(th_full, n), lead(tl_full, n), b,
                                                     bl_full[:n], uplo, unit))
                    return relative_error((x.hi.double() + x.lo.double()).cpu().numpy(), ref)

                vals.append(common.guarded(eval_oracle, f"oracle n={n}"))
        else:
            vals = [common.guarded(
                lambda: flops(n) / (timer(lambda: fn(a_n[st], b)) * 1e-3) / 1e9,
                f"{nm} n={n}") for nm, st, fn in columns]
        common.emit_row(n, vals)
        common.progress(f"{op.lower()} n={n} done")
        del a_n


if __name__ == "__main__":
    main()
