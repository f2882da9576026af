"""GEMV: res_out = alpha * A @ x + beta * res, in three tiers.

- ``gemv``: fixed tier, arithmetic type == storage type (f32, bf16, f16).
- ``acc_gemv``: accessor tier. Storage types come from the tensors (f32,
  bf16, f16, f8e4m3, f8e5m2; A and x may differ); the arithmetic is ``ar`` =
  'f32' | 'bf16' | 'f16' | 'df64', with ``precise=True`` selecting exact
  products and ``df_out=True`` the unrounded (hi, lo) result for df64.
- ``xla_gemv``: the vendor tier, ``torch.mv``.

The result takes the storage dtype of `res`. With beta == 0, `res` is never
read. A CUDA tensor runs the hand-written kernel of ``csrc/gemv.cu`` (which
replaces the Pallas kernels ``_gemv_kernel`` and ``_gemv_fullrow_kernel`` of
``accblas_tpu.ops.gemv``); a CPU tensor runs ``_gemv_plain``, the same
function in plain torch ops. Nothing falls back from one to the other.
Counterpart of ``accblas_tpu.ops.gemv``.
"""

from __future__ import annotations

import ctypes

import torch

from ..accessor import dtypes
from . import _build
from . import df64 as dfm
from .common import pow2_ceil, pow2_tree_sum, route

# launches of the GEMV kernel, counted where the wrapper launches it
launches = 0

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_int64,
    ctypes.c_int, ctypes.c_void_p,
]


def _block_cols(n: int) -> int:
    """Column block of the bf16/f16 tiers: each block's partial is rounded to
    the arithmetic type before the cross-block add (the reference's block
    granularity, part of those tiers' result)."""
    return min(1024, pow2_ceil(max(n, 1)))


def _res_term(res: torch.Tensor, beta: float, m: int, device) -> torch.Tensor:
    """beta * res in f32; zeros without reading res when beta == 0."""
    if beta == 0.0:
        return torch.zeros(m, dtype=torch.float32, device=device)
    return res.float() * beta


def _gemv_plain(a, x, res, alpha: float, beta: float, tier: str, df_out: bool):
    """The GEMV in plain torch ops, any device. Row sums are pairwise trees
    of elementwise adds (``pow2_tree_sum`` / ``df_tree_sum``)."""
    m, n = a.shape
    rv = _res_term(res, beta, m, a.device)
    if tier.startswith("df64"):
        av, xa = a.float(), x.float()
        p, e = dfm.two_prod(av, xa) if tier == "df64_precise" else (av * xa, None)
        out = dfm.df_add(dfm.df_mul_f32(dfm.df_tree_sum(p, e), alpha), dfm.df_from(rv))
        return out if df_out else dfm.df_to_f32(out).to(res.dtype)
    if tier == "f32":
        s = pow2_tree_sum(a.float() * x.float())
        return (s * alpha + rv).to(res.dtype)
    # bf16/f16: exact f32 products of the rounded operands, an f32 sum per
    # column block, rounded; the block partials add in the arithmetic type
    ar_dt = dtypes.torch_dtype(tier)
    p = a.float().to(ar_dt).float() * x.float().to(ar_dt).float()
    bn = _block_cols(n)
    nb = -(-n // bn)
    if nb * bn != n:
        p = torch.cat([p, p.new_zeros(m, nb * bn - n)], 1)
    part = pow2_tree_sum(p.view(m, nb, bn)).to(ar_dt)
    acc = torch.zeros(m, dtype=ar_dt, device=a.device)
    for b in range(nb):
        acc = acc + part[:, b]
    return (acc.float() * alpha + rv).to(ar_dt).to(res.dtype)


def _gemv_cuda(a, x, res, alpha: float, beta: float, df_out: bool, codes: int):
    """Launch the csrc/gemv.cu kernel on the current stream. `codes`: the
    storage codes of A, x and res and the tier code, 4 bits each from the
    lowest (the C entry's `codes`)."""
    global launches
    if not (a.is_contiguous() and x.is_contiguous() and res.is_contiguous()):
        raise ValueError("gemv kernel needs a row-major contiguous A and contiguous x, res")
    m, n = a.shape
    out = torch.empty(m, dtype=torch.float32 if df_out else res.dtype, device=a.device)
    out_lo = torch.empty(m, dtype=torch.float32, device=a.device) if df_out else None
    if m > 0:
        fn = _build.function("gemv", "accblas_gemv", _ARGTYPES)
        with _build.on_device(a):
            err = fn(a.data_ptr(), x.data_ptr(), res.data_ptr(), out.data_ptr(),
                     None if out_lo is None else out_lo.data_ptr(), m, n, alpha, beta,
                     _block_cols(n), codes, _build.stream(a))
        _build.check(err, "gemv kernel launch")
        launches += 1
    return dfm.DF(out, out_lo) if df_out else out


def _gemv_call(a, x, res, alpha, beta, ar: str, precise: bool, df_out: bool = False):
    """Validate the operands once, then run the kernel (CUDA tensors) or the
    plain version (CPU tensors)."""
    if df_out and ar != "df64":
        raise ValueError("df_out requires ar='df64'")
    if a.dim() != 2:
        raise ValueError(f"gemv expects a 2-D A, got {tuple(a.shape)}")
    m, n = a.shape
    if x.shape != (n,) or res.shape != (m,):
        raise ValueError(f"shape mismatch: A{tuple(a.shape)} x{tuple(x.shape)} "
                         f"res{tuple(res.shape)}")
    tier = _build.tier(ar, precise, "gemv")
    codes = (_build.storage_code(a, "gemv A") | _build.storage_code(x, "gemv x") << 4
             | _build.storage_code(res, "gemv res") << 8 | _build.TIER_CODE[tier] << 12)
    alpha, beta = float(alpha), float(beta)
    if route("gemv", a, x, res) == "cuda":
        return _gemv_cuda(a, x, res, alpha, beta, df_out, codes)
    return _gemv_plain(a, x, res, alpha, beta, tier, df_out)


def gemv(a, x, res, alpha=1.0, beta=1.0):
    """Fixed-precision GEMV: arithmetic == storage dtype (f32, bf16, f16)."""
    if x.dtype != a.dtype:
        raise ValueError(
            f"fixed-tier gemv needs matching storage dtypes, got A {a.dtype} "
            f"x {x.dtype} (use acc_gemv for mixed storage)"
        )
    ar = dtypes.check_arithmetic(a.dtype)  # f8 storage has no fixed tier
    return _gemv_call(a, x, res, alpha, beta, ar, precise=False)


def acc_gemv(a, x, res, alpha=1.0, beta=1.0, ar="df64", *, precise=False, df_out=False):
    """Accessor mixed-precision GEMV: storage types from the tensors,
    arithmetic per `ar` ('f32' | 'bf16' | 'f16' | 'df64').

    `df_out=True` (df64 only) returns the unrounded result as a `DF` pair of
    float32 tensors instead of casting to the storage of `res`."""
    ar = dtypes.check_arithmetic(ar)
    return _gemv_call(a, x, res, alpha, beta, ar, precise=precise, df_out=df_out)


def xla_gemv(a, x, res, alpha=1.0, beta=1.0):
    """Vendor tier: ``torch.mv`` in the promoted dtype of A and x (a
    matrix-vector product never takes TF32, so f32 is genuine f32). beta == 0
    does not read res."""
    dt = torch.promote_types(a.dtype, x.dtype)
    rv = _res_term(res, float(beta), a.shape[0], a.device)
    return (alpha * torch.mv(a.to(dt), x.to(dt)) + rv).to(res.dtype)
