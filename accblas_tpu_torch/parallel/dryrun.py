"""The multi-rank dryrun: every sharded op once on small shapes (the port's
counterpart of ``__graft_entry__.dryrun_multichip``).

    python -c "import accblas_tpu_torch.parallel.dryrun as d; d.dryrun_multichip(4, 'cpu')"

On the 2-D mesh of R ranks: a bf16 `power_step`, the df64 `pdot` and
`pgemv` through the exact combine, an rhs-sharded `ptrsm` and a row-sharded
`ptrsv`, and 20 iterations of df64 `pcg`; then on the other mesh shapes
(1 x R, R x 1 and the transpose) 10 iterations of `pcg` in df64 and on bf16
storage. Every result must be finite and of its shape. Rank 0 prints the
JAX dryrun's summary line.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import MatrixInfo, gen_mtx
from . import collectives, launch
from .blas import pcg, pdot, pgemv, power_step, ptrsm, ptrsv
from .mesh import make_mesh, shard, unshard


def _require(ok: bool, what: str):
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _finite(t) -> bool:
    return bool(torch.isfinite(torch.as_tensor(t).float()).all())


def dryrun_rank(device=None) -> str:
    """The dryrun's body, run by every rank of a launched process group
    (`device` as ``make_mesh``). Returns the summary line."""
    world = collectives.world_size()
    mesh = make_mesh(device=device)
    rows_n, cols_n = mesh.rows, mesh.cols
    # tiny shapes, divisible by the mesh
    m, n = 128 * rows_n * 2, 128 * cols_n * 2
    a64 = gen_mtx(MatrixInfo(m, n), seed=42)
    x64 = gen_mtx(MatrixInfo(1, n), seed=43)[0]
    r64 = gen_mtx(MatrixInfo(1, m), seed=44)[0]
    a32, x32, r32 = (v.astype(np.float32) for v in (a64, x64, r64))

    a = shard(a32, mesh, ("rows", "cols"), st="bf16")
    x = shard(x32, mesh, ("cols",))
    r = shard(r32, mesh, ("rows",))
    # x in A's storage (bf16), as acc_gemv pairs them
    x_next, nu = power_step(a, x.to(torch.bfloat16), r, mesh=mesh, ar="f32")
    _require(_finite(nu), "power_step produced a non-finite norm")
    _require(unshard(x_next, mesh, ("cols",), (m,)).shape == (m,), "power_step's shape")

    # the sharded df64 DOT and GEMV through the exact combine (a gather of
    # the DF partials and a df_add fold, never a component-wise sum)
    nu_df = pdot(x, x, mesh, axis="cols", ar="df64", precise=True)
    _require(_finite(nu_df.hi + nu_df.lo), "df64 pdot is not finite")
    y_df = pgemv(shard(a32, mesh, ("rows", "cols")), x, r, 1.0, 1.0, ar="df64", mesh=mesh)
    y_df = unshard(y_df, mesh, ("rows",), (m,))
    _require(y_df.shape == (m,) and _finite(y_df), "df64 pgemv")

    # rhs-sharded TRSM (T replicated, no collective in the solve) on a
    # well-conditioned unit-upper triangle
    k = 8 * cols_n
    t64 = np.triu(gen_mtx(MatrixInfo(n, n), seed=46), k=1) / n + np.eye(n)
    t32 = t64.astype(np.float32)
    b32 = gen_mtx(MatrixInfo(n, k), seed=45).astype(np.float32)
    xs = ptrsm(shard(t32, mesh, ()), shard(b32, mesh, (None, "cols")), uplo="upper",
               unit=True, ar="f32", mesh=mesh)
    xs = unshard(xs, mesh, (None, "cols"), (n, k))
    _require(xs.shape == (n, k) and _finite(xs), "ptrsm")

    # row-sharded single-rhs TRSV (block-row substitution over the rows axis)
    xv = ptrsv(shard(t32, mesh, ("rows", None), identity_tail=True),
               shard(b32[:, 0], mesh, ("rows",)), uplo="upper", unit=True, ar="f32",
               mesh=mesh)
    xv = unshard(xv, mesh, ("rows",), (n,))
    _require(xv.shape == (n,) and _finite(xv), "ptrsv")

    # mesh-sharded CG on an SPD system, df64 Krylov dots
    s64 = gen_mtx(MatrixInfo(n, n), seed=47)
    spd32 = (s64 @ s64.T / n + np.eye(n) * 2.0).astype(np.float32)
    bcg32 = gen_mtx(MatrixInfo(1, n), seed=48)[0].astype(np.float32)
    _, rs_cg, it_cg = pcg(shard(spd32, mesh, ("rows", "cols")), shard(bcg32, mesh, ("cols",)),
                          mesh=mesh, iters=20, ar="df64")
    _require(_finite(rs_cg) and int(it_cg) == 20, "df64 pcg")

    # the other mesh factorizations, in df64 and on bf16 storage
    alt_shapes = []
    if world > 1:
        alt_shapes = [(1, world), (world, 1)]
        if cols_n != rows_n:
            alt_shapes.append((cols_n, rows_n))
    for shp in alt_shapes:
        mesh_a = make_mesh(shape=shp, device=mesh.device)
        b_a = shard(bcg32, mesh_a, ("cols",))
        _, rs_a, _ = pcg(shard(spd32, mesh_a, ("rows", "cols")), b_a, mesh=mesh_a, iters=10,
                         ar="df64")
        _, rs_b, _ = pcg(shard(spd32, mesh_a, ("rows", "cols"), st="bf16"), b_a, mesh=mesh_a,
                         iters=10, ar="f32")
        _require(_finite(rs_a) and _finite(rs_b), f"mesh {shp}: non-finite pcg residual")

    return (f"dryrun_multichip OK: mesh {rows_n}x{cols_n} ({world} devices), "
            f"A {m}x{n} bf16 sharded (rows, cols), |y|^2 = {float(nu):.6g}, "
            f"TRSM {n}x{k} rhs-sharded + TRSV row-sharded, "
            f"pcg |r|^2 = {float(rs_cg):.3g} after "
            f"{int(it_cg)} sharded df64-dot iterations; alt meshes "
            f"{alt_shapes} pcg df64+bf16 ok")


def dryrun_multichip(n_ranks: int, device=None) -> str:
    """Launch `n_ranks` ranks on `device` ("cpu", or None for the cards:
    ``launch.run``) and run the dryrun; prints and returns rank 0's line."""
    dev = "cuda" if device is None else device
    line = launch.run(dryrun_rank, n_ranks, device, device=dev)[0]
    print(line, flush=True)
    return line
