"""Device-side high-precision oracle, the cuBLAS-fp64 cross-check analogue
(counterpart of ``accblas_tpu.ops.oracle``, with its signatures and its df64
construction).

The reference's error plots include a cuBLAS fp64 line at ~1e-14
(``cuda/utils.cuh:315-332``): an independent on-device implementation whose
agreement with the fp64 host reference certifies that neither side is
systematically wrong. Here the oracle runs df64 arithmetic over an exact
two-word (hi, lo) f32 split of the fp64 master data
(``utils.devgen.split_df64``, or a host split of an LU-factored matrix):

    x·y = (xh+xl)·(yh+yl) = xh·yh [exact two_prod] + xh·yl + xl·yh [f32
    products, O(2^-24) of O(2^-24) terms -> O(2^-48) rounding] + xl·yl
    [O(2^-48), dropped for DOT]

~2^-48 ≈ 4e-15 of arithmetic error, far below every measured tier. The
drivers' error mode emits it as the ``df64 oracle (device)`` column.

- ``dot_df64``: three DOTs of the port (the DOT kernel on a card);
- ``gemv_df64``: a row-blocked two_prod / two_sum tree in torch ops, as the
  JAX package's is in jnp;
- ``trsv_df64``: iterative refinement around the port's ``trsv`` (the sweep
  on a card) with ``gemv_df64`` residuals.
"""

from __future__ import annotations

import torch

from . import df64 as dfm
from . import dot as dotops
from . import trsv as trsvops


def dot_df64(xh, xl, yh, yl) -> dfm.DF:
    """df64 DOT over split-f64 storage: three accessor dots combined.

    The main term takes exact two_prod products (``precise=True``); the
    cross terms are ~2^-24 relative, so their f32 product rounding lands at
    ~2^-48 overall, the df64 floor either way."""
    main = dotops.acc_dot(xh, yh, ar="df64", precise=True)
    c1 = dotops.acc_dot(xh, yl, ar="df64")
    c2 = dotops.acc_dot(xl, yh, ar="df64")
    return dfm.df_add(dfm.df_add(main, c1), c2)


def _gemv_block_df64(ah, al, xh, xl):
    """df64 matvec of one row block over split storage: exact two_prod on the
    main term; the cross terms ride the error channel of a two_sum halving
    tree over the columns."""
    p, e = dfm.two_prod(ah, xh[None, :])
    err = e + ah * xl[None, :] + al * xh[None, :] + al * xl[None, :]
    s = p
    while s.shape[1] > 1:
        half = s.shape[1] // 2
        s_new, e2 = dfm.two_sum(s[:, :half], s[:, half : 2 * half])
        err_new = err[:, :half] + err[:, half : 2 * half] + e2
        if s.shape[1] % 2:
            s0, e0 = dfm.two_sum(s_new[:, :1], s[:, 2 * half :])
            err_new = torch.cat([err_new[:, :1] + e0 + err[:, 2 * half :], err_new[:, 1:]], 1)
            s_new = torch.cat([s0, s_new[:, 1:]], 1)
        s, err = s_new, err_new
    return s[:, 0], err[:, 0]


def gemv_df64(ah, al, xh, xl, block: int = 2048) -> dfm.DF:
    """df64 GEMV over split-f64 storage, row-blocked (error mode runs it
    once per size, so its speed does not matter; the block bounds its
    temporaries)."""
    m = ah.shape[0]
    his, los = [], []
    for i0 in range(0, m, block):
        hi, lo = _gemv_block_df64(ah[i0 : i0 + block], al[i0 : i0 + block], xh, xl)
        his.append(hi)
        los.append(lo)
    return dfm.DF(torch.cat(his), torch.cat(los))


def trsv_df64(ah, al, bh, bl, uplo: str = "upper", unit: bool = True,
              iters: int = 3) -> dfm.DF:
    """df64 triangular solve by iterative refinement over split-f64 storage.

    (ah, al) must be the split of the *solved triangle itself*, masked to
    `uplo` with a materialized unit diagonal when `unit`, because the
    refinement residual streams the whole carrier through the oracle GEMV
    (the off-triangle half of an LU-factor carrier would poison it).

    An f32 base solve and `iters` rounds of (df64 residual through the split
    triangle, f32 correction solve). Each round contracts the error by
    ~eps_f32·κ(T); three rounds reach the df64 floor for well-conditioned
    triangles (the non-unit LU-factor triangles of the error driver)."""
    x = trsvops.trsv(ah, bh, uplo=uplo, unit=unit)
    x_df = dfm.df_from(x)
    for _ in range(iters):
        ax = gemv_df64(ah, al, x_df.hi, x_df.lo)
        r = dfm.df_sub(dfm.DF(bh, bl), ax)
        dx = trsvops.trsv(ah, r.hi + r.lo, uplo=uplo, unit=unit)
        x_df = dfm.df_add(x_df, dfm.df_from(dx))
    return x_df
