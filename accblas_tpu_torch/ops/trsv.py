"""TRSV/TRSM: solve T X = B for the upper or lower triangle T of a full
(e.g. LU-packed) matrix, with a unit or stored diagonal.

- ``trsv`` / ``trsm``: fixed tier, f32 arithmetic, the result in the storage
  of b.
- ``acc_trsv`` / ``acc_trsm``: accessor tier. Storage of A from the tensor
  (f32, bf16, f16, f8e4m3, f8e5m2); arithmetic ``ar`` = 'f32' (solved in
  f32, then cast to b's storage) or 'df64' (x and the corrections carried as
  (hi, lo) pairs through the whole sweep, rounded hi + lo on store).
- ``xla_trsv`` / ``xla_trsm``: the vendor tier,
  ``torch.linalg.solve_triangular`` in genuine f32.

Every solve is a blocked sweep in two phases, as in the JAX package:

1. the ``LEAF`` x ``LEAF`` diagonal tiles of A are gathered as f32 and
   masked to the triangle, identity past n (``_extract_leaf_diag``), then
   inverted in a batch by ``torch.linalg.solve_triangular``
   (``_leaf_inverses``);
2. the sweep walks the block rows in dependency order, each taking off the
   solved columns' correction and then multiplying through its diagonal
   leaves' inverses (``_trsv_sweep``).

A CUDA tensor runs the hand-written kernels of ``csrc/trsv.cu`` (which
replace the Pallas kernels ``_extract_leaf_diag.kern`` and ``_trsv_kernel``
of ``accblas_tpu.ops.trsv``): the masked gather, and a sweep of one launch
whose CTAs, one per ``LEAF``-row block row, order themselves by tickets. A
CPU tensor runs ``_extract_leaf_diag_plain`` and ``_trsv_sweep_plain``, the
same functions in plain torch ops; the plain sweep keeps the JAX kernel's
``BLOCK``-row arithmetic. Nothing falls back from one to the other.
Counterpart of ``accblas_tpu.ops.trsv``.
"""

from __future__ import annotations

import contextlib
import ctypes
import warnings

import torch

from ..accessor import dtypes
from . import _build
from . import df64 as dfm
from .common import route, tri_mask

# rows of a block row of the plain sweep (the JAX kernel's), and of a
# diagonal leaf, which is also a block row of the CUDA sweep (csrc/trsv.cu
# kLeaf); the right-hand sides are padded to whole BLOCKs
BLOCK = 512
LEAF = 64

# beyond this n the bf16-storage recurrence error reaches the percent range
# on LU-factor triangles (the JAX package's measurement) — the tier is
# throughput-only there
BF16_STABLE_N = 1024

# launches of the two kernels, counted where the wrappers launch them
leaf_diag_launches = 0
sweep_launches = 0

_LEAF_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
                  ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_SWEEP_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]
_OCCUPANCY_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]

# the identity right-hand side of the batched inversion, per (device, size)
_EYE: dict = {}


@contextlib.contextmanager
def ieee_f32():
    """cuBLAS f32 products in genuine IEEE f32 for the duration: TF32 is
    switched off and the caller's setting restored on exit. (The JAX
    package's analogue is ``precision=HIGHEST``; the CPU never uses TF32.)"""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# --------------------------------------------------------------------------
# phase 1: leaf gather and batched inversion
# --------------------------------------------------------------------------

def _extract_leaf_diag_plain(a: torch.Tensor, m: int, lower: bool, unit: bool) -> torch.Tensor:
    """The m diagonal LEAF x LEAF tiles of A as (m, LEAF, LEAF) f32, masked
    to the triangle with a unit diagonal if asked, the identity past n
    (``tri_mask``): a strided view, a cast and the mask, the same bits as
    the kernel."""
    n = a.shape[0]
    d = torch.zeros(m, LEAF, LEAF, dtype=torch.float32, device=a.device)
    full = min(m, n // LEAF)
    s0, s1 = a.stride()
    if full:
        d[:full] = a.as_strided((full, LEAF, LEAF), (LEAF * (s0 + s1), s0, s1),
                                a.storage_offset()).float()
    r0 = full * LEAF
    if full < m and r0 < n:
        d[full, : n - r0, : n - r0] = a[r0:, r0:].float()
    offs = torch.arange(m, device=a.device) * LEAF
    return tri_mask(d, lower, unit, n=n, offs=offs)


def _extract_leaf_diag_cuda(a: torch.Tensor, m: int, lower: bool, unit: bool) -> torch.Tensor:
    """Launch csrc/trsv.cu `leaf_diag` (gather and mask) on the current stream."""
    global leaf_diag_launches
    n = a.shape[0]
    sa = _build.storage_code(a, "trsv A")
    if not a.is_contiguous():
        raise ValueError("trsv kernels need a row-major contiguous A")
    vec_ok = a.data_ptr() % 16 == 0 and n % (16 // a.element_size()) == 0
    d = torch.empty(m, LEAF, LEAF, dtype=torch.float32, device=a.device)
    fn = _build.function("trsv", "accblas_leaf_diag", _LEAF_ARGTYPES)
    with _build.on_device(a):
        err = fn(a.data_ptr(), sa, n, d.data_ptr(), m, int(lower), int(unit), int(vec_ok),
                 _build.stream(a))
    _build.check(err, "leaf_diag kernel launch")
    leaf_diag_launches += 1
    return d


def _extract_leaf_diag(a: torch.Tensor, m: int, lower: bool, unit: bool) -> torch.Tensor:
    if route("trsv leaf gather", a) == "cuda":
        return _extract_leaf_diag_cuda(a, m, lower, unit)
    return _extract_leaf_diag_plain(a, m, lower, unit)


def _leaf_inverses(d: torch.Tensor, lower: bool) -> torch.Tensor:
    """Phase 1: the inverses of the masked leaves `d` (m, LEAF, LEAF),
    solved against the identity by ``torch.linalg.solve_triangular`` in
    genuine f32 (``ieee_f32``). Unlike the JAX package's they are not
    transposed, and they stay in the layout the solve returns (column-major
    per leaf from cuBLAS), which the sweep kernel reads as it is."""
    s = d.shape[-1]
    eye = _EYE.get((d.device, s))
    if eye is None:
        eye = _EYE[(d.device, s)] = torch.eye(s, dtype=torch.float32, device=d.device)
    with ieee_f32():
        return torch.linalg.solve_triangular(d, eye.expand(d.shape), upper=not lower)


def _check_inverses(inv: torch.Tensor, n: int):
    """The sweep kernel reads (m, LEAF, LEAF) leaf inverses column-major per
    leaf, the layout of the batched solve's result, m * LEAF >= n."""
    if inv.dim() != 3 or inv.shape[1:] != (LEAF, LEAF) or inv.stride() != (LEAF * LEAF, 1, LEAF):
        raise ValueError(f"trsv sweep: leaf inverses of shape {tuple(inv.shape)} and strides "
                         f"{inv.stride()} are not column-major (m, {LEAF}, {LEAF}) leaves")
    if inv.shape[0] * LEAF < n:
        raise ValueError(f"trsv sweep: {inv.shape[0]} leaf inverses do not cover n={n}")


def _rhs_panels(b2: torch.Tensor, nb: int) -> torch.Tensor:
    """The (n, k) right-hand sides as (k, nb·BLOCK) f32 rows, zero past n."""
    n, k = b2.shape
    bt = torch.zeros(k, nb * BLOCK, dtype=torch.float32, device=b2.device)
    bt[:, :n] = b2.T.float()
    return bt


# --------------------------------------------------------------------------
# phase 2: the sweep
# --------------------------------------------------------------------------

def _trsv_sweep_plain(a, inv, bt, lower: bool, ar: str, out_dtype) -> torch.Tensor:
    """The sweep in plain torch ops, any device: a Python loop over the
    block rows, in the JAX kernel's arithmetic. `bt` is (k, npad) f32, zero
    past n; returns X (n, k) in `out_dtype`. Values are carried as DF pairs
    (lo = 0 in the f32 tier); f32 adds the products' hi words, df64 folds
    the hi and the lo products with df_add, as the JAX kernel's (hi, lo)
    scratch does."""
    n = a.shape[0]
    k, npad = bt.shape
    nb = npad // BLOCK
    nleaf = BLOCK // LEAF
    df = ar == "df64"

    def add(acc, t):
        """acc + t in the tier."""
        return dfm.df_add(acc, t) if df else dfm.DF(acc.hi + t.hi, acc.lo)

    def prods(x, m):
        """x·mᵀ of x's hi words, and in the df64 tier of its lo words too."""
        return [x.hi @ m.T] + ([x.lo @ m.T] if df else [])

    def blk(r0, c0):
        """A[r0:r0+BLOCK, c0:c0+BLOCK] in f32, clipped at n (the rest reads as 0)."""
        out = torch.zeros(BLOCK, BLOCK, dtype=torch.float32, device=a.device)
        rr, cc = max(0, min(BLOCK, n - r0)), max(0, min(BLOCK, n - c0))
        out[:rr, :cc] = a[r0 : r0 + rr, c0 : c0 + cc].float()
        return out

    x = dfm.df_zeros(bt.shape, a.device)
    with ieee_f32():
        for bi in range(nb) if lower else range(nb - 1, -1, -1):
            r0 = bi * BLOCK
            corr = dfm.df_zeros((k, BLOCK), a.device)
            for bj in range(bi) if lower else range(nb - 1, bi, -1):
                c0 = bj * BLOCK
                xb = dfm.DF(x.hi[:, c0 : c0 + BLOCK], x.lo[:, c0 : c0 + BLOCK])
                for t in prods(xb, blk(r0, c0)):
                    corr = add(corr, dfm.df_from(t))
            rhs = add(dfm.df_from(bt[:, r0 : r0 + BLOCK]), dfm.df_neg(corr))
            dblk = blk(r0, r0)
            xs: list = [None] * nleaf
            for s in range(nleaf) if lower else range(nleaf - 1, -1, -1):
                sl = slice(s * LEAF, (s + 1) * LEAF)
                r_s = dfm.DF(rhs.hi[:, sl], rhs.lo[:, sl])
                for t in range(s) if lower else range(s + 1, nleaf):
                    for p in prods(xs[t], dblk[sl, t * LEAF : (t + 1) * LEAF]):
                        r_s = add(r_s, dfm.df_from(-p))
                v = [dfm.df_from(p) for p in prods(r_s, inv[bi * nleaf + s])]
                xs[s] = add(v[0], v[1]) if df else v[0]
            x.hi[:, r0 : r0 + BLOCK] = torch.cat([v.hi for v in xs], 1)
            x.lo[:, r0 : r0 + BLOCK] = torch.cat([v.lo for v in xs], 1)
    return dfm.df_to_f32(x)[:, :n].T.to(out_dtype).contiguous()


def _trsv_sweep_cuda(a, inv, bt, lower: bool, ar: str, out_dtype) -> torch.Tensor:
    """Launch the csrc/trsv.cu sweep (one counter memset and one kernel) on
    the current stream; X (n, k) in `out_dtype`."""
    global sweep_launches
    n = a.shape[0]
    k, npad = bt.shape
    sa = _build.storage_code(a, "trsv A")
    so = _build.STORAGE_CODE[dtypes.canon(out_dtype)]
    if not a.is_contiguous():
        raise ValueError("trsv kernels need a row-major contiguous A")
    if not bt.is_contiguous() or npad < n:
        raise ValueError("trsv sweep needs contiguous right-hand sides padded to whole LEAFs")
    _check_inverses(inv, n)
    vec_ok = a.data_ptr() % 16 == 0 and n % (16 // a.element_size()) == 0
    df = ar == "df64"
    # one scratch buffer: the published x (hi, and lo for df64), then room
    # for two 32-bit counters per panel of right-hand sides
    nx = (2 if df else 1) * k * npad
    scratch = torch.empty(nx + 2 * k, dtype=torch.float32, device=a.device)
    out = torch.empty(n, k, dtype=out_dtype, device=a.device)
    x_hi = scratch.data_ptr()
    fn = _build.function("trsv", "accblas_trsv_sweep", _SWEEP_ARGTYPES)
    with _build.on_device(a):
        err = fn(a.data_ptr(), sa, n, npad, inv.data_ptr(), bt.data_ptr(), k, x_hi,
                 x_hi + 4 * k * npad if df else None, x_hi + 4 * nx, out.data_ptr(), so,
                 int(lower), int(df), int(vec_ok), _build.stream(a))
    _build.check(err, "trsv sweep launch")
    sweep_launches += 1
    return out


def sweep_occupancy(a_dtype=torch.float32, ar: str = "f32", k: int = 1) -> int:
    """CTAs of the CUDA sweep that one SM of the current card holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); times the SM count,
    the most block rows of LEAF that run at once."""
    blocks = ctypes.c_int(0)
    fn = _build.function("trsv", "accblas_trsv_sweep_occupancy", _OCCUPANCY_ARGTYPES)
    err = fn(_build.STORAGE_CODE[dtypes.canon(a_dtype)], int(ar == "df64"), k,
             ctypes.byref(blocks))
    _build.check(err, "trsv sweep occupancy")
    return blocks.value


def _trsv_sweep(a, inv, bt, lower: bool, ar: str, out_dtype) -> torch.Tensor:
    if route("trsv sweep", a, inv, bt) == "cuda":
        return _trsv_sweep_cuda(a, inv, bt, lower, ar, out_dtype)
    return _trsv_sweep_plain(a, inv, bt, lower, ar, out_dtype)


def _trsm_impl(a, b, uplo: str, unit: bool, st_out: str, resident=None, ar: str = "f32"):
    """Solve T X = B for B of shape (n, k); returns X (n, k) in `st_out`."""
    n = a.shape[0]
    if a.dim() != 2 or a.shape != (n, n) or b.dim() != 2 or b.shape[0] != n:
        raise ValueError(f"trsm needs square A and (n, k) B, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if resident is True:
        raise NotImplementedError(
            "resident=True selects the blocked torch composition (_trsv_small), which "
            "the port does not have yet (ROADMAP.md queue A, A2)"
        )
    _build.storage_code(a, "trsv A")
    if st_out not in _build.STORAGE_CODE:
        raise ValueError(f"trsv result: {st_out} is not a kernel storage type "
                         f"({', '.join(_build.STORAGE_CODE)})")
    out_dtype = dtypes.torch_dtype(st_out)
    route("trsv", a, b)
    k = b.shape[1]
    if n == 0 or k == 0:
        return torch.empty(n, k, dtype=out_dtype, device=a.device)
    lower = uplo == "lower"
    nb = -(-n // BLOCK)
    inv = _leaf_inverses(_extract_leaf_diag(a, nb * BLOCK // LEAF, lower, unit), lower)
    return _trsv_sweep(a, inv, _rhs_panels(b, nb), lower, ar, out_dtype)


def _trsv_impl(a, b, uplo: str, unit: bool, st_out: str, resident=None, ar: str = "f32"):
    n = a.shape[0]
    if a.dim() != 2 or a.shape != (n, n) or tuple(b.shape) != (n,):
        raise ValueError(f"trsv needs square A and matching b, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    return _trsm_impl(a, b.reshape(n, 1), uplo, unit, st_out, resident=resident,
                      ar=ar).reshape(n)


def _check_bf16_envelope(a, n: int, ar: str, unstable_ok: bool, op: str):
    """The bf16-storage tier's recurrence error reaches O(1) on LU-factor
    triangles beyond ~1024 rows, a property of the storage, not the kernel.
    Warn unless the caller opted in or asked for df64 arithmetic."""
    if unstable_ok or ar == "df64":
        return
    if dtypes.canon(a.dtype) == "bf16" and n > BF16_STABLE_N:
        warnings.warn(
            f"{op} on a bf16-storage triangle with n={n} > {BF16_STABLE_N}: "
            "the substitution recurrence amplifies the bf16 storage rounding "
            "(measured up to O(1) relative error on LU factors at n=24576). "
            "Pass unstable_ok=True to silence, or use ar='df64'/f32 storage "
            "for accuracy.",
            stacklevel=3,
        )


def _df64_resident(resident, op: str):
    if resident is True:
        raise ValueError(
            f"{op} ar='df64' runs the fused one-pass sweep; there is no "
            "composed resident df64 mode (resident=True unsupported)"
        )


def trsv(a, b, uplo: str = "upper", unit: bool = True, *, resident=None,
         unstable_ok: bool = False):
    """Fixed-precision TRSV: f32 arithmetic, the result in the storage of b.
    A holds a full (e.g. LU-packed) matrix; only the selected triangle is
    read. `resident=True` (the JAX package's blocked composition) is not
    ported yet and raises. bf16 storage beyond n=1024 warns."""
    _check_bf16_envelope(a, a.shape[0], "f32", unstable_ok, "trsv")
    return _trsv_impl(a, b, uplo, unit, dtypes.canon(b.dtype), resident=resident)


def acc_trsv(a, b, uplo: str = "upper", unit: bool = True, ar: str = "f32", *,
             resident=None, unstable_ok: bool = False):
    """Accessor mixed-precision TRSV: storage from the tensors, arithmetic
    per `ar`. 'f32' solves in f32 and casts to b's storage; 'df64' carries x
    and the corrections as (hi, lo) pairs through the one-pass sweep.
    bf16 storage beyond n=1024 warns unless `unstable_ok`."""
    ar = dtypes.check_arithmetic(ar)
    st_out = dtypes.canon(b.dtype)
    _check_bf16_envelope(a, a.shape[0], ar, unstable_ok, "acc_trsv")
    if ar == "f32":
        x0 = _trsv_impl(a, b, uplo, unit, "f32", resident=resident)
        return x0.to(dtypes.torch_dtype(st_out))
    if ar != "df64":
        raise NotImplementedError(f"acc_trsv arithmetic {ar!r}")
    _df64_resident(resident, "acc_trsv")
    return _trsv_impl(a, b, uplo, unit, st_out, ar="df64")


def trsm(a, b, uplo: str = "upper", unit: bool = True, *, resident=None,
         unstable_ok: bool = False):
    """Fixed-precision multi-RHS triangular solve: T X = B, B of shape
    (n, k), the same sweep with k right-hand sides."""
    _check_bf16_envelope(a, a.shape[0], "f32", unstable_ok, "trsm")
    return _trsm_impl(a, b, uplo, unit, dtypes.canon(b.dtype), resident=resident)


def acc_trsm(a, b, uplo: str = "upper", unit: bool = True, ar: str = "f32", *,
             resident=None, unstable_ok: bool = False):
    """Accessor mixed-precision TRSM: storage from the tensors, arithmetic
    per `ar` ('f32' or 'df64'), as acc_trsv."""
    ar = dtypes.check_arithmetic(ar)
    st_out = dtypes.canon(b.dtype)
    _check_bf16_envelope(a, a.shape[0], ar, unstable_ok, "acc_trsm")
    if ar == "f32":
        x0 = _trsm_impl(a, b, uplo, unit, "f32", resident=resident)
        return x0.to(dtypes.torch_dtype(st_out))
    if ar != "df64":
        raise NotImplementedError(f"acc_trsm arithmetic {ar!r}")
    _df64_resident(resident, "acc_trsm")
    return _trsm_impl(a, b, uplo, unit, st_out, ar="df64")


def xla_trsm(a, b, uplo: str = "upper", unit: bool = True):
    """Vendor multi-RHS tier: ``torch.linalg.solve_triangular`` in genuine
    f32 on the wanted triangle of the full matrix, cast back to b's dtype."""
    with ieee_f32():
        x = torch.linalg.solve_triangular(a.float(), b.float(), upper=uplo != "lower",
                                          unitriangular=unit)
    return x.to(b.dtype)


def xla_trsv(a, b, uplo: str = "upper", unit: bool = True):
    """Vendor tier (the cublas_trsv analogue): ``xla_trsm`` of one column."""
    return xla_trsm(a, b.reshape(-1, 1), uplo, unit).reshape(-1)
