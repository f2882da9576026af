"""Triangular residual r = b - T x with double-float accumulation.

T is the selected triangle of a full (LU-packed) matrix, exactly the
operand the TRSV sweep reads; the products are f32 and their sums are
carried as (hi, lo) pairs, so cancellation does not lose the low bits an
iterative refinement step needs. The result is f32.

A CUDA tensor runs the hand-written kernel of ``csrc/tri_gemv.cu`` (which
replaces the Pallas kernel ``accblas_tpu.ops.tri_gemv._tri_gemv_kernel``); a
CPU tensor runs ``_tri_gemv_plain``, the same function in plain torch ops.
Nothing falls back from one to the other. Counterpart of
``accblas_tpu.ops.tri_gemv``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import df64 as dfm
from .common import route
from .trsv import BLOCK, ieee_f32

# launches of the kernel, counted where the wrapper launches it
launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _tri_gemv_plain(a, x, b, lower: bool, unit: bool) -> torch.Tensor:
    """The residual in plain torch ops, any device, in the JAX kernel's
    arithmetic: an f32 product per BLOCK-column block of the masked
    triangle, the blocks folded with df_add in the sweep's order (from the
    left for lower, from the right for upper)."""
    n = a.shape[0]
    acc = dfm.df_zeros(n, a.device)
    r = torch.arange(n, device=a.device).view(n, 1)
    nbk = -(-n // BLOCK)
    with ieee_f32():
        for bj in range(nbk) if lower else range(nbk - 1, -1, -1):
            c0, c1 = bj * BLOCK, min(n, (bj + 1) * BLOCK)
            c = torch.arange(c0, c1, device=a.device).view(1, -1)
            blk = torch.where((c <= r) if lower else (c >= r), a[:, c0:c1].float(), 0.0)
            if unit:
                blk = torch.where(c == r, 1.0, blk)
            acc = dfm.df_add(acc, dfm.df_from(blk @ x[c0:c1]))
    return dfm.df_to_f32(dfm.df_sub(dfm.df_from(b), acc))


def _tri_gemv_cuda(a, x, b, lower: bool, unit: bool) -> torch.Tensor:
    """Launch the csrc/tri_gemv.cu kernel on the current stream."""
    global launches
    n = a.shape[0]
    sa = _build.storage_code(a, "tri_gemv A")
    if not a.is_contiguous():
        raise ValueError("tri_gemv kernel needs a row-major contiguous A")
    vec_ok = a.data_ptr() % 16 == 0 and n % (16 // a.element_size()) == 0
    x, b = x.contiguous(), b.contiguous()
    r = torch.empty(n, dtype=torch.float32, device=a.device)
    if n > 0:
        fn = _build.function("tri_gemv", "accblas_tri_gemv", _ARGTYPES)
        with _build.on_device(a):
            err = fn(a.data_ptr(), sa, n, x.data_ptr(), b.data_ptr(), r.data_ptr(), int(lower),
                     int(unit), int(vec_ok), _build.stream(a))
        _build.check(err, "tri_gemv kernel launch")
        launches += 1
    return r


def tri_gemv_df64(a, x, b, uplo: str = "upper", unit: bool = True):
    """r = b - T x, T = selected triangle of `a`; f32 result with df64-carried
    accumulation."""
    n = a.shape[0]
    if a.dim() != 2 or a.shape != (n, n) or tuple(x.shape) != (n,) or tuple(b.shape) != (n,):
        raise ValueError(f"tri_gemv needs square A and (n,) x, b, got {tuple(a.shape)}, "
                         f"{tuple(x.shape)}, {tuple(b.shape)}")
    _build.storage_code(a, "tri_gemv A")
    lower = uplo == "lower"
    x, b = x.float(), b.float()
    if route("tri_gemv", a, x, b) == "cuda":
        return _tri_gemv_cuda(a, x, b, lower, unit)
    return _tri_gemv_plain(a, x, b, lower, unit)
