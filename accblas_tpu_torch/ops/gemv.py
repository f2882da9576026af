"""GEMV: res_out = alpha * A @ x + beta * res, in three tiers.

- ``gemv``: fixed tier, arithmetic type == storage type (f32, bf16, f16).
- ``acc_gemv``: accessor tier. Storage types come from the tensors (f32,
  bf16, f16, f8e4m3, f8e5m2; A and x may differ); the arithmetic is ``ar`` =
  'f32' | 'bf16' | 'f16' | 'df64', with ``precise=True`` selecting exact
  products and ``df_out=True`` the unrounded (hi, lo) result for df64.
- ``xla_gemv``: the vendor tier, ``torch.mv``.

The result takes the storage dtype of `res`. With beta == 0, `res` is never
read. A CUDA tensor runs a hand-written kernel of ``csrc/gemv.cu`` (the two
replace the Pallas kernels ``_gemv_kernel`` and ``_gemv_fullrow_kernel`` of
``accblas_tpu.ops.gemv``); a CPU tensor runs ``_gemv_plain``, the same
function in plain torch ops. Nothing falls back from one to the other.

The C entry (``accblas_gemv``) chooses the kernel by what the call is:
``gemv_staged``, whose CTAs widen x once into shared memory and then walk
the rows, for A and x both stored in f8, in the f32 and df64 tiers, with A
and x 16-byte aligned and n a multiple of 16, up to n = 46480 columns (the
widest x a CTA's shared memory stages); otherwise ``gemv_rows``, one warp a
row, which reads and widens x along each row. The width edge is a routing
by shape: past it the staged x does not fit. Both kernels give the same
bits. An x given as a DF pair (df64 only) runs ``gemv_rows_dfx`` through its
own C entry (``accblas_gemv_dfx``). A launch that fails raises; no kernel
stands in for another.
Counterpart of ``accblas_tpu.ops.gemv``.
"""

from __future__ import annotations

import ctypes

import torch

from ..accessor import dtypes
from ..accessor.range import make_range
from ..utils.spans import span
from . import _build
from . import df64 as dfm
from .common import pow2_ceil, pow2_tree_sum, route

# launches of the GEMV kernels, counted where the wrapper launches each:
# gemv_rows, gemv_staged (A and x stored in f8), and gemv_rows_dfx (x a DF
# pair)
launches = 0
staged_launches = 0
dfx_launches = 0

# the kernels a call may ask the C entry for, in bits 16-17 of its codes:
# its own choice, or one kernel forced (the tests and chip_smoke.py hold
# the two to each other); a forced gemv_staged it would not choose is an
# error
FORCE = {None: 0, "rows": 1, "staged": 2}

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_int64,
    ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
]
_DFX_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
# the C entry's report of the kernel it launched: 1 gemv_staged, 0 gemv_rows
_ran = ctypes.c_int()
_RAN = ctypes.byref(_ran)


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
    """The GEMV in plain torch ops, any device. A and x are read through
    const Ranges of the tier's arithmetic, res through an f32 one, and the
    result is written through a Range over the storage of res (f32 ones for
    the (hi, lo) words of ``df_out``), as the JAX kernels read and write
    (``_gemv_kernel``, ``_gemv_fullrow_kernel``). Row sums are pairwise
    trees of elementwise adds (``pow2_tree_sum`` / ``df_tree_sum``)."""
    m, n = a.shape
    ar = "df64" if tier.startswith("df64") else tier
    ra = make_range(ar, dtypes.canon(a.dtype), a, const=True)
    dfx = isinstance(x, dfm.DF)
    rx = [make_range("f32", "f32", w, const=True) for w in x] if dfx \
        else make_range(ar, dtypes.canon(x.dtype), x, const=True)
    rr = make_range("f32", dtypes.canon(res.dtype), res, const=True)
    rv = torch.zeros(m, dtype=torch.float32, device=a.device) if beta == 0.0 \
        else rr.load() * beta  # res is never read when beta == 0
    out = torch.empty(m, dtype=res.dtype, device=a.device)
    ro = make_range(ar, dtypes.canon(res.dtype), out)
    if ar == "df64":
        # the accessor's cast-on-load to the f32 carriers of the df64 values
        av = ra.load_raw().float()
        if dfx:  # exact products with x_hi, f32 ones with x_lo into the error words
            xh, xl = (r.load() for r in rx)
            p, e = dfm.two_prod(av, xh)
            e = e + av * xl
        else:
            xa = rx.load_raw().float()
            p, e = dfm.two_prod(av, xa) if tier == "df64_precise" else (av * xa, None)
        val = dfm.df_add(dfm.df_mul_f32(dfm.df_tree_sum(p, e), alpha), dfm.df_from(rv))
        if df_out:
            words = [torch.empty(m, dtype=torch.float32, device=a.device) for _ in "hl"]
            for w, v in zip(words, (val.hi, val.lo)):
                make_range("f32", "f32", w).store(v)
            return dfm.DF(*words)
        ro.store(val)
        return out
    if tier == "f32":
        s = pow2_tree_sum(ra.load() * rx.load())
        ro.store(s * alpha + rv)
        return out
    # bf16/f16: exact f32 products of the operands cast to the arithmetic
    # type on load, an f32 sum per column block, rounded; the block partials
    # add in the arithmetic type
    ar_dt = dtypes.torch_dtype(tier)
    p = ra.load().float() * rx.load().float()
    bn = _block_cols(n)
    nb = -(-n // bn)
    if nb * bn != n:
        p = torch.cat([p, p.new_zeros(m, nb * bn - n)], 1)
    part = pow2_tree_sum(p.view(m, nb, bn)).to(ar_dt)
    acc = torch.zeros(m, dtype=ar_dt, device=a.device)
    for b in range(nb):
        acc = acc + part[:, b]
    ro.store((acc.float() * alpha + rv).to(ar_dt))
    return out


def _launch(what: str, a, xs, res, df_out: bool, entry: str, argtypes, args, tail=()):
    """One launch through the C entry `entry` of csrc/gemv.cu on the current
    stream: checks A, the words of x in `xs` and res, allocates the result,
    and, unless A has no rows, calls the entry with the pointers of A, of
    `xs`, of res and of the result's words, then m, n, `args`, the stream
    and `tail`. Returns the result; the caller counts the launch."""
    if not (a.is_contiguous() and res.is_contiguous() and all(w.is_contiguous() for w in xs)):
        raise ValueError("gemv kernel needs a row-major contiguous A and contiguous x, res")
    m, n = a.shape
    out = torch.empty(m, dtype=torch.float32 if df_out else res.dtype, device=a.device)
    out_lo = torch.empty(m, dtype=torch.float32, device=a.device) if df_out else None
    if m > 0:
        fn = _build.function("gemv", entry, argtypes)
        with _build.on_device(a):
            err = fn(a.data_ptr(), *[w.data_ptr() for w in xs], res.data_ptr(), out.data_ptr(),
                     None if out_lo is None else out_lo.data_ptr(), m, n, *args,
                     _build.stream(a), *tail)
        _build.check(err, f"{what} launch")
    return dfm.DF(out, out_lo) if df_out else out


def _gemv_cuda(a, x, res, alpha: float, beta: float, df_out: bool, codes: int,
               force: str | None = None):
    """Launch a csrc/gemv.cu kernel on the current stream, the one the C
    entry chooses unless `force` names one (FORCE), and count the launch
    under the kernel the entry reports. `codes`: the storage codes of A, x
    and res and the tier code, 4 bits each from the lowest (`_codes`)."""
    global launches, staged_launches
    with span("accblas.gemv.launch"):
        out = _launch("gemv kernel", a, (x,), res, df_out, "accblas_gemv", _ARGTYPES,
                      (alpha, beta, _block_cols(a.shape[1]), codes | FORCE[force] << 16),
                      (_RAN,))
        if a.shape[0] > 0:
            if _ran.value:
                staged_launches += 1
            else:
                launches += 1
    return out


def _gemv_dfx_cuda(a, x: dfm.DF, res, alpha: float, beta: float, df_out: bool):
    """Launch csrc/gemv.cu `gemv_rows_dfx` (x a DF pair, the precise df64
    tier) on the current stream and count it."""
    global dfx_launches
    with span("accblas.gemv.launch"):
        out = _launch("gemv_rows_dfx kernel", a, x, res, df_out, "accblas_gemv_dfx",
                      _DFX_ARGTYPES, (alpha, beta, _build.storage_code(a, "gemv A"),
                                      _build.storage_code(res, "gemv res")))
        if a.shape[0] > 0:
            dfx_launches += 1
    return out


def _codes(a, x, res, tier: str) -> int:
    """The C entry's `codes`: the storage codes of A, x and res and the tier
    code, 4 bits each from the lowest; raises on a dtype no kernel takes."""
    return (_build.storage_code(a, "gemv A") | _build.storage_code(x, "gemv x") << 4
            | _build.storage_code(res, "gemv res") << 8 | _build.TIER_CODE[tier] << 12)


def _gemv_call(a, x, res, alpha, beta, ar: str, precise: bool, df_out: bool = False):
    """Validate the operands once, then run the kernel (CUDA tensors) or the
    plain version (CPU tensors)."""
    if df_out and ar != "df64":
        raise ValueError("df_out requires ar='df64'")
    if a.dim() != 2:
        raise ValueError(f"gemv expects a 2-D A, got {tuple(a.shape)}")
    m, n = a.shape
    dfx = isinstance(x, dfm.DF)
    if dfx:
        if ar != "df64":
            raise ValueError("a DF x requires ar='df64'")
        if any(w.dtype != torch.float32 or w.shape != (n,) for w in x):
            raise ValueError(f"a DF x needs two float32 words of shape ({n},)")
        precise = True  # x_lo below an f32 product's rounding would be lost
    if x.shape != (n,) or res.shape != (m,):
        raise ValueError(f"shape mismatch: A{tuple(a.shape)} x{tuple(x.shape)} "
                         f"res{tuple(res.shape)}")
    tier = _build.tier(ar, precise, "gemv")
    codes = _codes(a, x.hi if dfx else x, res, tier)
    alpha, beta = float(alpha), float(beta)
    if route("gemv", a, *(x if dfx else (x,)), res) == "cuda":
        if dfx:
            return _gemv_dfx_cuda(a, x, res, alpha, beta, df_out)
        return _gemv_cuda(a, x, res, alpha, beta, df_out, codes)
    return _gemv_plain(a, x, res, alpha, beta, tier, df_out)


def gemv(a, x, res, alpha=1.0, beta=1.0):
    """Fixed-precision GEMV: arithmetic == storage dtype (f32, bf16, f16)."""
    with span("accblas.gemv"):
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
    float32 tensors instead of casting to the storage of `res`.

    `x` may be a `DF` pair of float32 vectors (df64 only): each row's sum is
    then the sum of two_prod(a, x_hi) + a * x_lo, the precise tier's exact
    products whatever `precise` says, in one pass over A (kernel
    ``gemv_rows_dfx``), e.g. the residual b - A x of a refinement whose x
    carries more than an f32 holds."""
    with span("accblas.gemv"):
        ar = dtypes.check_arithmetic(ar)
        return _gemv_call(a, x, res, alpha, beta, ar, precise=precise, df_out=df_out)


def xla_gemv(a, x, res, alpha=1.0, beta=1.0):
    """Vendor tier: ``torch.mv`` in the promoted dtype of A and x (a
    matrix-vector product never takes TF32, so f32 is genuine f32). beta == 0
    does not read res."""
    dt = torch.promote_types(a.dtype, x.dtype)
    rv = _res_term(res, float(beta), a.shape[0], a.device)
    return (alpha * torch.mv(a.to(dt), x.to(dt)) + rv).to(res.dtype)
