"""DOT: fixed-precision, accessor mixed-precision and vendor tiers.

- ``dot``: fixed tier, arithmetic type == storage type (f32, bf16, f16).
- ``acc_dot``: accessor tier. Storage types come from the tensors (f32,
  bf16, f16, f8e4m3, f8e5m2, and x and y may differ); the arithmetic is
  ``ar`` = 'f32' | 'bf16' | 'f16' | 'df64', with ``precise=True`` selecting
  exact products for df64.
- ``xla_dot``: the vendor tier, ``torch.dot``.

A CUDA tensor runs the hand-written kernel of ``csrc/dot.cu`` (which
replaces the Pallas kernel ``accblas_tpu.ops.dot._dot_kernel``), one launch a
call: each check is taken once, one ctypes call launches it, and its one
allocation is the result it returns, hi alone for the tiers whose lo is 0
(the block partials and the ticket live in the stream's scratch,
``_build.scratch``). A CPU tensor runs
``_dot_plain``, the same function in plain torch ops. Nothing falls back
from one to the other. Counterpart of ``accblas_tpu.ops.dot``.
"""

from __future__ import annotations

import ctypes

import torch

from ..accessor import dtypes
from ..accessor.range import make_range
from . import _build
from . import df64 as dfm
from .common import pow2_tree_sum, route

# launches of the DOT kernel, counted where the wrapper launches it
launches = 0

# the arithmetic types of the tiers, by their canonical names
_TIER_AR = ("f32", "bf16", "f16", "df64")
# lanes of the plain bf16/f16 tiers: the reference kernel's (16, 128)
# accumulator tile, element i summing into lane i % 2048
_NARROW_LANES = 2048

# x, y, n, codes (x's storage | y's << 4 | tier << 8 | 16-byte aligned << 12),
# init, scratch, hi, lo, stream (csrc/dot.cu accblas_dot)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _dot_plain(x: torch.Tensor, y: torch.Tensor, tier: str, init: float):
    """The DOT in plain torch ops, any device: (hi, lo) float32 scalars.
    x and y are read through const Ranges of the tier's arithmetic, as the
    JAX kernel reads them (``_dot_kernel``). Sums are pairwise trees of
    elementwise adds (``pow2_tree_sum``)."""
    ar = "df64" if tier.startswith("df64") else tier
    rx = make_range(ar, dtypes.canon(x.dtype), x, const=True)
    ry = make_range(ar, dtypes.canon(y.dtype), y, const=True)
    if ar == "df64":
        # the accessor's cast-on-load to the f32 carriers of the df64 values
        xa, ya = rx.load_raw().float(), ry.load_raw().float()
        p, e = dfm.two_prod(xa, ya) if tier == "df64_precise" else (xa * ya, None)
        tot = dfm.df_add(dfm.df_tree_sum(p, e), dfm.df_from(torch.tensor(init)))
        return tot.hi, tot.lo
    ar_dt = dtypes.torch_dtype(ar)
    # operands cast to the arithmetic type on load; products and each lane's
    # pairwise sum round in it; the lanes fold in f32, rounded once at the end
    p = rx.load() * ry.load()
    if tier == "f32":
        lanes = p
    else:
        rows = -(-p.shape[0] // _NARROW_LANES)
        p = torch.cat([p, p.new_zeros(rows * _NARROW_LANES - p.shape[0])])
        lanes = pow2_tree_sum(p.view(rows, _NARROW_LANES).t()).float()
    total = torch.tensor(init, dtype=torch.float32).to(ar_dt).float().to(x.device) \
        + pow2_tree_sum(lanes)
    return total.to(ar_dt).float(), torch.zeros((), dtype=torch.float32, device=x.device)


def _dot_cuda(x: torch.Tensor, y: torch.Tensor, codes: int, init: float, df: bool):
    """Launch the csrc/dot.cu kernel on the current stream of x's device, x
    and y checked but for contiguity; `codes` holds the storage and tier
    codes. Returns (hi, lo): for a df64 tier the two elements of one fresh
    (2,) tensor, else a fresh 0-d hi and None (lo is 0)."""
    global launches
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("dot kernel needs contiguous vectors")
    px, py = x.data_ptr(), y.data_ptr()
    out = x.new_empty(2 if df else (), dtype=torch.float32)
    hi = out.data_ptr()
    fn = _build.function("dot", "accblas_dot", _ARGTYPES)
    with _build.on_device(x):
        stream = _build.stream(x)
        err = fn(px, py, x.shape[0], codes | ((px | py) % 16 == 0) << 12, init,
                 _build.scratch(x, stream), hi, hi + 4 if df else None, stream)
    _build.check(err, "dot kernel launch")
    launches += 1
    return out.unbind() if df else (out, None)


def _dot_call(x, y, ar: str, precise: bool, init):
    if x.dim() != 1 or x.shape != y.shape:
        raise ValueError(f"dot expects equal-length vectors, got {tuple(x.shape)} "
                         f"{tuple(y.shape)}")
    tier = _build.tier(ar, precise, "dot")
    codes = (_build.storage_code(x, "dot x") | _build.storage_code(y, "dot y") << 4
             | _build.TIER_CODE[tier] << 8)
    init = 0.0 if init is None else float(init)
    if x.is_cuda and y.is_cuda and x.get_device() == y.get_device() \
            or route("dot", x, y) == "cuda":
        return _dot_cuda(x, y, codes, init, tier.startswith("df64"))
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
    return hi if ar == "f32" else hi.to(dtypes.torch_dtype(ar))


def acc_dot(x, y, ar="df64", *, precise: bool = False, res_dtype=None, init=None):
    """Accessor mixed-precision DOT.

    Storage types come from the tensors; `ar` is the arithmetic type
    ('f32' | 'bf16' | 'f16' | 'df64'). With ar='df64', `precise=True` takes
    exact two_prod products (error ~2^-48); the default keeps f32 products
    (error at the f32 storage floor). Returns a DF of 0-d float32 tensors for
    df64, else a 0-d tensor of the arithmetic dtype; `res_dtype` requests a
    final cast ('f64' keeps the full df64 width).
    """
    if ar not in _TIER_AR:  # the canonical names pass as they are
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
    out = hi if ar == "f32" else hi.to(dtypes.torch_dtype(ar))
    if res_dtype is not None:
        out = out.to(dtypes.torch_dtype(res_dtype))
    return out


def xla_dot(x, y):
    """Vendor tier: ``torch.dot`` in the promoted dtype of x and y (a vector
    dot product never takes TF32, so f32 is genuine f32)."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.dot(x.to(dt), y.to(dt))
