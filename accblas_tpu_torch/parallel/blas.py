"""Sharded BLAS over a mesh of ranks (counterpart of
``accblas_tpu.parallel.blas``, with its names, signatures and results).

Each function is the body the JAX package hands to ``shard_map``: every rank
of the mesh calls it on its own blocks (``mesh.shard``), and the combines are
collectives over one mesh axis (``collectives``). The local work runs the
port's kernels on CUDA tensors and their plain versions on CPU tensors.

- `pdot`: x and y split over one axis; the local accessor DOT, then one
  all-reduce, or for df64 a gather of the (hi, lo) partials and an exact
  ``df_sum`` fold.
- `pgemv`: A split over (rows, cols), x over cols, res and the result over
  rows; the local GEMV, then one all-reduce over cols, or for df64 a gather
  of the unrounded (hi, lo) row partials and an exact fold.
- `ptrsm`: the triangle replicated, the right-hand sides split over one
  axis; no collective.
- `ptrsv`: block rows of T and b split over rows; d dependency-ordered
  steps, each one gather of the step owner's solved block.
- `pcg`: ``models.solvers.cg`` with `pgemv` and `pdot` injected.
- `power_step`: one normalised power iteration from the sharded ops.

The df64 combines never sum hi and lo apart: summing each in f32 leaves the
rounding of the hi-sum nowhere, and cancellation across ranks then drops
the result from df64 toward f32 accuracy. Where XLA inserts a reshard
(``with_sharding_constraint``), the port gathers over rows and slices
(`_rows_to_cols`), a counted collective.
"""

from __future__ import annotations

import torch

from ..accessor import dtypes
from ..ops import df64 as dfm
from ..ops import dot as dotops
from ..ops import gemv as gemvops
from ..ops import trsv as trsvops
from . import collectives
from .mesh import Mesh


def _f32(v, device) -> torch.Tensor:
    """alpha or beta as a float32 scalar tensor (a tensor stays one: no read
    to the host)."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _df_or_f32(v):
    return dfm.df_to_f32(v) if isinstance(v, dfm.DF) else v.float()


def pdot(x, y, mesh: Mesh, axis: str = "cols", ar: str = "f32", precise: bool = False):
    """Sharded DOT of this rank's blocks x and y (split over `axis`, padded
    with zeros): the local accessor DOT, combined over `axis`, the same
    value on every rank.

    Fixed and f32 tiers combine with one all-reduce. The df64 tier gathers
    the (hi, lo) partials, stacked, and folds them with ``df_sum``'s exact
    ``df_add`` chain, keeping the full double-float width."""
    ar = dtypes.check_arithmetic(ar)
    local = dotops.acc_dot(x, y, ar=ar, precise=precise)
    if ar == "df64":
        parts = collectives.all_gather(torch.stack([local.hi, local.lo]), axis, mesh)
        return dfm.df_sum(dfm.DF(parts[:, 0], parts[:, 1]))
    return collectives.all_reduce_sum(local, axis, mesh)


def pgemv(a, x, res, alpha=1.0, beta=1.0, ar: str = "f32", *, mesh: Mesh,
          row_axis: str = "rows", col_axis: str = "cols"):
    """Sharded GEMV, res = alpha·A@x + beta·res, on this rank's blocks: A
    (rows, cols), x (cols), res and the result (rows), each padded with
    zeros. One all-reduce over `col_axis` for the f32 and narrow tiers.

    df64: the local partials stay unrounded (``acc_gemv(..., df_out=True)``)
    through one gather and an exact ``df_sum`` fold; alpha and beta apply in
    DF and the result is rounded once, to the storage of res. A beta that is
    the number 0 never reads res (it may hold NaN); a tensor alpha or beta
    stays on the device."""
    ar = dtypes.check_arithmetic(ar)
    beta_is_static_zero = isinstance(beta, (int, float)) and float(beta) == 0.0
    zero = torch.zeros(res.shape, dtype=torch.float32, device=res.device)
    if ar == "df64":
        part = gemvops.acc_gemv(a, x, zero, 1.0, 0.0, ar="df64", df_out=True)
        parts = collectives.all_gather(torch.stack([part.hi, part.lo]), col_axis, mesh)
        tot = dfm.df_sum(dfm.DF(parts[:, 0], parts[:, 1]), axis=0)
        out = dfm.df_mul_f32(tot, _f32(alpha, res.device))
        if not beta_is_static_zero:
            out = dfm.df_add(out, dfm.df_from(res.float() * _f32(beta, res.device)))
        return dfm.df_to_f32(out).to(res.dtype)
    part = gemvops.acc_gemv(a, x, zero, 1.0, 0.0, ar=ar)
    out = alpha * collectives.all_reduce_sum(part, col_axis, mesh)
    if not beta_is_static_zero:
        out = out + beta * res.float()
    return out.to(res.dtype)


def ptrsm(a, b, uplo: str = "upper", unit: bool = True, ar: str = "f32", *, mesh: Mesh,
          rhs_axis: str = "cols"):
    """Sharded multi-RHS triangular solve T X = B: T replicated, B's columns
    split over `rhs_axis` (``shard(b, mesh, (None, rhs_axis))``, uneven k
    padded with zero columns, which solve to exact zeros). The columns are
    independent solves, so each rank solves its (n, k / extent) panel with
    ``acc_trsm``: no collective."""
    if b.dim() != 2:
        raise ValueError(f"ptrsm: b is this rank's (n, k) panel, got {tuple(b.shape)}")
    return trsvops.acc_trsm(a, b, uplo, unit, ar=ar)


def ptrsv(a, b, uplo: str = "upper", unit: bool = True, ar: str = "f32", *, mesh: Mesh,
          row_axis: str = "rows"):
    """Row-sharded single-rhs triangular solve T x = b: this rank holds an
    (m, d·m) block row of T and the m entries of b beside it
    (``shard(t, mesh, (row_axis, None), identity_tail=True)``: an uneven n
    is padded with an identity tail, whose unknowns solve to zeros).

    Block substitution over the d ranks of `row_axis`, in dependency order
    (the last block first for upper, the first for lower). At each step
    every rank solves its own diagonal block against its running residual
    (``acc_trsv``, `ar` its tier), one gather picks the step owner's
    solution, and every rank takes its panel's product with it off the
    residual: f32 products in genuine f32 (``ieee_f32``, the JAX package's
    HIGHEST). Only the owner's candidate is ever read; the others are dead
    values. The last step's update, which nothing reads, is skipped."""
    d, idx = mesh.shape[row_axis], mesh.index(row_axis)
    m = b.shape[0]
    if a.shape != (m, d * m):
        raise ValueError(f"ptrsv: A must be this rank's ({m}, {d * m}) block row, got "
                         f"{tuple(a.shape)}")
    dblk = a[:, idx * m:(idx + 1) * m].contiguous()
    acc = b.float()
    x_local = torch.zeros(m, dtype=torch.float32, device=b.device)
    order = list(range(d) if uplo == "lower" else range(d - 1, -1, -1))
    for s in order:
        cand = trsvops.acc_trsv(dblk, acc.to(b.dtype), uplo, unit, ar=ar, unstable_ok=True)
        x_s = collectives.all_gather(_df_or_f32(cand), row_axis, mesh)[s]
        if idx == s:
            x_local = x_s
        if s != order[-1]:
            with trsvops.ieee_f32():
                acc = acc - torch.matmul(a[:, s * m:(s + 1) * m].float(), x_s)
    return x_local.to(b.dtype)


def _rows_to_cols(v, n_cols: int, mesh: Mesh, row_axis: str, col_axis: str):
    """Reshard a vector from its rows block to its cols block of `n_cols`
    entries: one gather over `row_axis` and a slice. The padded lanes of
    both layouts hold zeros, so none of the global length is needed."""
    full = collectives.all_gather(v, row_axis, mesh).reshape(-1)
    start = mesh.index(col_axis) * n_cols
    out = full[start:start + n_cols]
    if out.shape[0] < n_cols:
        out = torch.cat([out, out.new_zeros(n_cols - out.shape[0])])
    return out


def pcg(a, b, *, mesh: Mesh, iters: int = 50, ar: str = "f32", tol: float = 0.0,
        row_axis: str = "rows", col_axis: str = "cols"):
    """Mesh-sharded conjugate gradients: ``models.solvers.cg`` with sharded
    closures injected. A is this rank's (rows, cols) block, b its cols block;
    every vector of the recurrence lives in cols blocks. Each matvec is a
    `pgemv` (its rows-block result resharded to cols, `_rows_to_cols`), each
    dot a `pdot` over `col_axis`; `ar` sets the tier of both, and 'df64'
    runs the dots through the exact combine. Returns (this rank's cols block
    of x, the final |r|^2, the iterations run), the last two the same on
    every rank."""
    from ..models import solvers

    ar = dtypes.check_arithmetic(ar)
    b32 = b.float()
    zero_rows = torch.zeros(a.shape[0], dtype=torch.float32, device=b.device)

    def matvec(p):
        ap = pgemv(a, p.to(a.dtype), zero_rows, 1.0, 0.0, ar=ar, mesh=mesh,
                   row_axis=row_axis, col_axis=col_axis)
        return _rows_to_cols(ap.float(), b32.shape[0], mesh, row_axis, col_axis)

    def dot(u, v):
        return _df_or_f32(pdot(u, v, mesh, axis=col_axis, ar=ar, precise=(ar == "df64")))

    return solvers.cg(a, b32, iters=iters, ar=ar, tol=tol, matvec=matvec, dot=dot)


def power_step(a, x, r, *, mesh: Mesh, ar: str = "f32"):
    """One sharded power iteration: y = A@x + r (`pgemv`, all-reduce over
    cols), nu = <y, y> (`pdot` over rows), and x' = y / sqrt(nu) resharded
    from rows to cols blocks. Returns (this rank's cols block of x', nu)."""
    y = pgemv(a, x, r, 1.0, 1.0, ar=ar, mesh=mesh)
    nu = pdot(y, y, mesh, axis="rows", ar=ar)
    y_norm = y * torch.rsqrt(_df_or_f32(nu) + 1e-30)
    n_cols = -(-y.shape[0] * mesh.rows // mesh.cols)
    return _rows_to_cols(y_norm, n_cols, mesh, "rows", "cols"), nu
