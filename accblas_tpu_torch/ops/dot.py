"""DOT: fixed-precision, accessor mixed-precision and vendor tiers.

- ``dot``: fixed tier, arithmetic type == storage type (f32, bf16, f16).
- ``acc_dot``: accessor tier. Storage types come from the tensors (f32,
  bf16, f16, f8e4m3, f8e5m2, and x and y may differ); the arithmetic is
  ``ar`` = 'f32' | 'bf16' | 'f16' | 'df64', with ``precise=True`` selecting
  exact products for df64.
- ``xla_dot``: the vendor tier, ``torch.dot``.

A CUDA tensor runs the hand-written kernel of ``csrc/dot.cu`` (which
replaces the Pallas kernel ``accblas_tpu.ops.dot._dot_kernel``); a CPU tensor
runs ``_dot_plain``, the same function in plain torch ops. Nothing falls back
from one to the other. Counterpart of ``accblas_tpu.ops.dot``.
"""

from __future__ import annotations

import ctypes

import torch

from ..accessor import dtypes
from . import _build
from . import df64 as dfm
from .common import pow2_tree_sum, route

# launches of the DOT kernel, counted where the wrapper launches it
launches = 0

_THREADS = 256  # csrc/dot.cu kThreads
_MAX_BLOCKS = 1024  # one wave of 256-thread blocks on the card, fixed so results repeat
# lanes of the plain bf16/f16 tiers: the reference kernel's (16, 128)
# accumulator tile, element i summing into lane i % 2048
_NARROW_LANES = 2048

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_void_p,
]


def _dot_plain(x: torch.Tensor, y: torch.Tensor, tier: str, init: float):
    """The DOT in plain torch ops, any device: (hi, lo) float32 scalars.
    Sums are pairwise trees of elementwise adds (``pow2_tree_sum``)."""
    if tier.startswith("df64"):
        xa, ya = x.float(), y.float()
        p, e = dfm.two_prod(xa, ya) if tier == "df64_precise" else (xa * ya, None)
        tot = dfm.df_add(dfm.df_tree_sum(p, e), dfm.df_from(torch.tensor(init)))
        return tot.hi, tot.lo
    ar_dt = dtypes.torch_dtype(tier)
    # operands cast to the arithmetic type; products and each lane's
    # pairwise sum round in it; the lanes fold in f32, rounded once at the end
    p = x.float().to(ar_dt) * y.float().to(ar_dt)
    if tier == "f32":
        lanes = p
    else:
        rows = -(-p.shape[0] // _NARROW_LANES)
        p = torch.cat([p, p.new_zeros(rows * _NARROW_LANES - p.shape[0])])
        lanes = pow2_tree_sum(p.view(rows, _NARROW_LANES).t()).float()
    total = torch.tensor(init, dtype=torch.float32).to(ar_dt).float().to(x.device) \
        + pow2_tree_sum(lanes)
    return total.to(ar_dt).float(), torch.zeros((), dtype=torch.float32, device=x.device)


def _dot_cuda(x: torch.Tensor, y: torch.Tensor, tier: str, init: float):
    """Launch the csrc/dot.cu kernel on the current stream: (hi, lo)."""
    global launches
    sx = _build.storage_code(x, "dot x")
    sy = _build.storage_code(y, "dot y")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("dot kernel needs contiguous vectors")
    n = x.shape[0]
    vec = 16 // max(x.element_size(), y.element_size())
    vec_ok = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    work = n // vec if vec_ok else n
    nblocks = max(1, min(_MAX_BLOCKS, -(-work // _THREADS)))
    fn = _build.function("dot", "accblas_dot", _ARGTYPES)
    with torch.cuda.device(x.device):
        partials = torch.empty(2 * nblocks, dtype=torch.float32, device=x.device)
        out = torch.empty(2, dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), sx, y.data_ptr(), sy, n, _build.TIER_CODE[tier], int(vec_ok),
                 init, partials.data_ptr(), nblocks, out.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "dot kernel launch")
        launches += 1
    return out[0], out[1]


def _dot_call(x, y, ar: str, precise: bool, init):
    if x.dim() != 1 or x.shape != y.shape:
        raise ValueError(f"dot expects equal-length vectors, got {tuple(x.shape)} "
                         f"{tuple(y.shape)}")
    tier = _build.tier(ar, precise, "dot")
    _build.storage_code(x, "dot x")
    _build.storage_code(y, "dot y")
    init = 0.0 if init is None else float(init)
    if route("dot", x, y) == "cuda":
        return _dot_cuda(x, y, tier, init)
    return _dot_plain(x, y, tier, init)


def dot(x, y, *, init=None):
    """Fixed-precision DOT: arithmetic type == storage type (f32, bf16, f16).
    Returns a 0-d tensor of the storage dtype; `init` seeds the sum."""
    if y.dtype != x.dtype:
        raise ValueError(
            f"fixed-tier dot needs matching storage dtypes, got x {x.dtype} "
            f"y {y.dtype} (use acc_dot for mixed storage)"
        )
    ar = dtypes.check_arithmetic(x.dtype)  # f8 storage has no fixed tier
    hi, _ = _dot_call(x, y, ar, False, init)
    return hi.to(dtypes.torch_dtype(ar))


def acc_dot(x, y, ar="df64", *, precise: bool = False, res_dtype=None, init=None):
    """Accessor mixed-precision DOT.

    Storage types come from the tensors; `ar` is the arithmetic type
    ('f32' | 'bf16' | 'f16' | 'df64'). With ar='df64', `precise=True` takes
    exact two_prod products (error ~2^-48); the default keeps f32 products
    (error at the f32 storage floor). Returns a DF of 0-d float32 tensors for
    df64, else a 0-d tensor of the arithmetic dtype; `res_dtype` requests a
    final cast ('f64' keeps the full df64 width).
    """
    ar = dtypes.check_arithmetic(ar)
    hi, lo = _dot_call(x, y, ar, precise, init)
    if ar == "df64":
        out = dfm.DF(hi, lo)
        if res_dtype is None:
            return out
        rd = dtypes.canon(res_dtype)
        if rd == "f64":
            return dfm.df_to_f64(out)
        return dfm.df_to_f32(out).to(dtypes.torch_dtype(rd))
    out = hi.to(dtypes.torch_dtype(ar))
    if res_dtype is not None:
        out = out.to(dtypes.torch_dtype(res_dtype))
    return out


def xla_dot(x, y):
    """Vendor tier: ``torch.dot`` in the promoted dtype of x and y (a vector
    dot product never takes TF32, so f32 is genuine f32)."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.dot(x.to(dt), y.to(dt))
