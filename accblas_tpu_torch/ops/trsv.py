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

A solve takes one of two routes, as in the JAX package.

**The sweep**, in two phases:

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

**The blocked compositions** (``_trsv_small``, f32 arithmetic, and
``_trsm_small_df64``, the solved panels carried as (hi, lo) pairs): the
JAX package's XLA compositions, here torch ops over cuBLAS in genuine f32
(``ieee_f32``). The diagonal blocks of ``_block_for(n)`` rows are inverted
in one batch (``_masked_tri_inverse``); each block step then takes one
product with the solved panel and one with its block's inverse, so every
block of A is read once for all k right-hand sides. On either device they
are the same torch ops.

``resident=True`` forces the composition (f32 arithmetic), ``False`` the
sweep; ``None`` routes by ``_route``: on a CPU tensor as the JAX package
routes off a TPU, on a CUDA tensor by a gate measured on an H100.
Counterpart of ``accblas_tpu.ops.trsv``.
"""

from __future__ import annotations

import contextlib
import ctypes
import warnings

import torch

from ..accessor import dtypes
from ..accessor.range import make_range
from ..utils.spans import span
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
    """The inverses of a (g, s, s) stack of triangular blocks `d`, already
    masked, any s: solved against the identity by
    ``torch.linalg.solve_triangular`` in genuine f32 (``ieee_f32``). For the
    sweep's leaves (phase 1) they are not transposed, unlike the JAX
    package's, and stay in the layout the solve returns (column-major per
    leaf from cuBLAS), which the sweep kernel reads as it is."""
    s = d.shape[-1]
    eye = _EYE.get((d.device, s))
    if eye is None:
        eye = _EYE[(d.device, s)] = torch.eye(s, dtype=torch.float32, device=d.device)
    with ieee_f32():
        return torch.linalg.solve_triangular(d, eye.expand(d.shape), upper=not lower)


def _masked_tri_inverse(d: torch.Tensor, lower: bool, unit: bool, *, n=None,
                        offs=None) -> torch.Tensor:
    """Inverse of a (g, s, s) f32 stack of triangular blocks: the dead
    triangle zeroed and the diagonal forced to 1 if `unit`, lanes past a
    logical size `n` continued as the identity when `offs` gives each
    block's global row offset (``tri_mask``), then solved against the
    identity (``_leaf_inverses``). Counterpart of the JAX package's
    ``_masked_tri_inverse``."""
    return _leaf_inverses(tri_mask(d, lower, unit, n=n, offs=offs), lower)


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

    ra = make_range("f32", dtypes.canon(a.dtype), a, const=True)

    def blk(r0, c0):
        """A[r0:r0+BLOCK, c0:c0+BLOCK] in f32 through a window of A's const
        Range, clipped at n (the rest reads as 0)."""
        out = torch.zeros(BLOCK, BLOCK, dtype=torch.float32, device=a.device)
        rr, cc = max(0, min(BLOCK, n - r0)), max(0, min(BLOCK, n - c0))
        out[:rr, :cc] = ra.window(r0, c0, rr, cc).load()
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
    # the result through a Range over its storage: df64 rounds hi + lo once
    out = torch.empty(n, k, dtype=out_dtype, device=a.device)
    xs = dfm.DF(x.hi[:, :n].T, x.lo[:, :n].T)
    make_range(ar, dtypes.canon(out_dtype), out).store(xs if df else dfm.df_to_f32(xs))
    return out


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


# --------------------------------------------------------------------------
# the blocked compositions
# --------------------------------------------------------------------------

def _block_for(n: int) -> int:
    """Block rows of the blocked compositions: 512 from n = 1024, smaller
    below so the ragged last block stays bounded (the JAX package's)."""
    if n >= 1024:
        return BLOCK
    if n >= 512:
        return 256
    return 128


def _diag_blocks(a: torch.Tensor, block: int) -> list:
    """A's diagonal blocks of `block` rows, as views: a (nfull, block,
    block) stack of the full ones, then the ragged last one as (1, s, s)."""
    n = a.shape[0]
    nfull = n // block
    s0, s1 = a.stride()
    out = []
    if nfull:
        out.append(a.as_strided((nfull, block, block), (block * (s0 + s1), s0, s1),
                                a.storage_offset()))
    if nfull * block < n:
        r0 = nfull * block
        out.append(a[None, r0:, r0:])
    return out


def _block_inverses(a, block: int, lower: bool, unit: bool, masked: bool):
    """The inverses of f32 A's masked diagonal blocks, a list in block order
    (``_masked_tri_inverse``, one batched solve for the full blocks); with
    `masked`, also the masked blocks themselves (the refinement's T_bb),
    else None."""
    stacks = _diag_blocks(a, block)
    inv = [v for d in stacks for v in _masked_tri_inverse(d, lower, unit)]
    tri = [v for d in stacks for v in tri_mask(d, lower, unit)] if masked else None
    return inv, tri


def _steps(n: int, block: int, lower: bool):
    """The block steps in dependency order: (r0, r1), the block's rows, and
    (c0, c1), the columns already solved (c0 == c1 for the first)."""
    nb = -(-n // block)
    for bi in range(nb) if lower else range(nb - 1, -1, -1):
        r0, r1 = bi * block, min(n, (bi + 1) * block)
        yield bi, (r0, r1), ((0, r0) if lower else (r1, n))


def _trsv_small(a, b, uplo: str, unit: bool, st_out: str, block=None, *, refine=None):
    """The blocked TRSV/TRSM composition in f32 arithmetic (the JAX
    package's ``_trsv_small``): `b` (n,) or (n, k). Block by block in
    dependency order, rhs = b_b - A[b, solved] @ x[solved], then
    x_b = inv(T_bb) @ rhs with the inverses from one batched solve. The
    solved blocks are written into one (n, k) f32 buffer, whose solved rows
    are then a view; the panel A[b, solved] is a strided view too, which
    cuBLAS reads in place. The last block is simply smaller when `block`
    does not divide n.

    `refine` (None: k < 32, f32 storage and n >= 512) takes one residual
    step on each block, x_b += inv @ (rhs - T_bb @ x_b), which lifts the
    inverse's forward error back to substitution class.

    Narrow storage is cast to f32 once, upfront. The JAX package casts each
    panel where it is read for k < 32 above n = 2048, which XLA fuses into
    the product; in eager torch that is one more op per block step. On an
    NVIDIA H100 (700 W; bf16 storage, k = 1, 8, 16 at n = 4096, 8192 and
    16384; scripts/torch_trsm_routes.py) the upfront cast took less time
    per call at 6 of 9 points, e.g. 3.01 against 5.18 ms at 16384 and
    k = 16, 1.35 against 2.42 ms at 8192 and k = 8, and lost by 0.38 ms at
    most, though per-slice read up to 21% less device time at k = 1. The
    cast is exact, so the bits are the same either way.
    """
    n = a.shape[0]
    vec = b.dim() == 1
    b2 = (b.reshape(n, 1) if vec else b).float()
    k = b2.shape[1]
    lower = uplo == "lower"
    f32_storage = a.dtype == torch.float32
    block = _block_for(n) if block is None else block
    if refine is None:
        refine = k < 32 and f32_storage and n >= 512
    a = a.float()
    x = torch.empty(n, k, dtype=torch.float32, device=a.device)
    with ieee_f32():
        inv, tri = _block_inverses(a, block, lower, unit, refine)
        for bi, (r0, r1), (c0, c1) in _steps(n, block, lower):
            rhs = b2[r0:r1]
            if c1 > c0:
                rhs = torch.addmm(rhs, a[r0:r1, c0:c1], x[c0:c1], alpha=-1)
            xb = x[r0:r1]
            torch.mm(inv[bi], rhs, out=xb)
            if refine:
                xb.addmm_(inv[bi], torch.addmm(rhs, tri[bi], xb, alpha=-1))
    x = x.to(dtypes.torch_dtype(st_out))
    return x[:, 0] if vec else x


def _trsm_small_df64(a, b, uplo: str, unit: bool, st_out: str, refine: bool = True,
                     block=None):
    """The blocked composition with the solved panels and the correction
    carried as (hi, lo) pairs (the JAX package's ``_trsm_small_df64``):
    each block step takes the products of the panel with the solved hi and
    lo words and folds them into the right-hand side with ``df_add``, then
    applies the block's inverse to both words. `refine` adds one DF
    residual step per block, x_b += inv @ (rhs - T_bb @ x_b) evaluated in
    DF; the term inv @ r.lo is dropped, as in the JAX package (r is already
    O(eps) of rhs). Every product is genuine f32; the JAX package runs the
    lo products at its default precision. Returns the hi words in
    `st_out`."""
    n = a.shape[0]
    vec = b.dim() == 1
    b2 = (b.reshape(n, 1) if vec else b).float()
    k = b2.shape[1]
    lower = uplo == "lower"
    block = _block_for(n) if block is None else block
    a = a.float()
    x_hi = torch.empty(n, k, dtype=torch.float32, device=a.device)
    x_lo = torch.empty(n, k, dtype=torch.float32, device=a.device)
    with ieee_f32():
        inv, tri = _block_inverses(a, block, lower, unit, refine)
        for bi, (r0, r1), (c0, c1) in _steps(n, block, lower):
            rhs = dfm.df_from(b2[r0:r1])
            if c1 > c0:
                panel = a[r0:r1, c0:c1]
                th, tl = panel @ x_hi[c0:c1], panel @ x_lo[c0:c1]
                rhs = dfm.df_add(rhs, dfm.df_from(-th))
                rhs = dfm.df_add(rhs, dfm.df_from(-tl))
            xb = dfm.df_add(dfm.df_from(inv[bi] @ rhs.hi), dfm.df_from(inv[bi] @ rhs.lo))
            if refine:
                t = dfm.df_add(dfm.df_from(tri[bi] @ xb.hi), dfm.df_from(tri[bi] @ xb.lo))
                r = dfm.df_sub(rhs, t)
                xb = dfm.df_add(xb, dfm.df_from(inv[bi] @ r.hi))
            x_hi[r0:r1], x_lo[r0:r1] = xb.hi, xb.lo
    x = x_hi.to(dtypes.torch_dtype(st_out))
    return x[:, 0] if vec else x


# --------------------------------------------------------------------------
# the route
# --------------------------------------------------------------------------

# The CUDA gate, from chip_smoke.py's "trsm routes" lines on an NVIDIA H100
# 80GB HBM3 at 700 W (upper non-unit LU factor, CUDA-event ms, sweep against
# composition, f32 storage then bf16). The composition is host-bound (~100
# to ~250 torch ops a call, 1.3-3 ms whatever k, up to twice that on a busy
# host), while the sweep's time grows with n²·k:
# - n = 16384: k = 16 1.70 against 3.71; k = 32 2.83 against 2.64 (bf16
#   2.89 against 2.69; another run 3.02 against 3.15: a tie, so the sweep);
#   k = 64 5.13 against 2.04 (bf16 4.98 against 3.34); k = 128 9.65 against
#   3.04;
# - n = 8192: k = 32 1.01 against 1.74; k = 64 1.70 against 1.25 (bf16
#   1.63 against 1.92); k = 128 3.04 against 1.27 (bf16 2.67 against 1.52);
# - n = 4096: k = 128 0.89 against 1.74.
# So the f32 tier takes the composition for k >= COMPOSITION_K once n²·k
# reaches COMPOSITION_WORK: 8192 at k = 128, 16384 at k = 64, the points it
# wins in every run. Its accuracy differs from the sweep's: on that factor
# at 16384 the composition errs 2.1e-4 (512-row block inverses, unrefined
# for k >= 32) where the sweep errs 6.0e-5, at 8192 1.0e-4 against 2.1e-5,
# so the default route's error changes at this boundary. The df64
# composition (~3000 launches at 16384, 24-43 ms) loses to the df64 sweep
# (0.8-16.6 ms) at every point, so df64 stays on the sweep.
COMPOSITION_K = 64
COMPOSITION_WORK = 128 * 8192**2


def _route(n: int, k: int, st: str, ar: str, device_type: str) -> str:
    """Where ``resident=None`` sends a solve of n rows and k right-hand
    sides on A of storage `st` in arithmetic `ar`: "composition" or
    "sweep".

    - CPU: as the JAX package routes off a TPU (its ``_use_small`` is
      False there): the sweep, but df64 panels of k >= 32 take the DF
      composition.
    - CUDA: the gate measured on the H100 (above), the same for every
      storage: the f32 tier's wide panels at large n take the composition,
      everything else the sweep.
    """
    if device_type != "cuda":
        return "composition" if ar == "df64" and k >= 32 else "sweep"
    if ar == "f32" and k >= COMPOSITION_K and n * n * k >= COMPOSITION_WORK:
        return "composition"
    return "sweep"


def _trsm_impl(a, b, uplo: str, unit: bool, st_out: str, resident=None, ar: str = "f32"):
    """Solve T X = B for B of shape (n, k); returns X (n, k) in `st_out`.
    `resident`: True the composition, False the sweep, None ``_route``."""
    n = a.shape[0]
    if a.dim() != 2 or a.shape != (n, n) or b.dim() != 2 or b.shape[0] != n:
        raise ValueError(f"trsm needs square A and (n, k) B, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    _build.storage_code(a, "trsv A")
    if st_out not in _build.STORAGE_CODE:
        raise ValueError(f"trsv result: {st_out} is not a kernel storage type "
                         f"({', '.join(_build.STORAGE_CODE)})")
    out_dtype = dtypes.torch_dtype(st_out)
    route("trsv", a, b)
    k = b.shape[1]
    if n == 0 or k == 0:
        return torch.empty(n, k, dtype=out_dtype, device=a.device)
    if resident is None:
        resident = _route(n, k, dtypes.canon(a.dtype), ar, a.device.type) == "composition"
    if resident:
        small = _trsm_small_df64 if ar == "df64" else _trsv_small
        return small(a, b, uplo, unit, st_out)
    lower = uplo == "lower"
    nb = -(-n // BLOCK)
    # a span for each phase here, not in the helpers: the composition above
    # inverts its blocks by _leaf_inverses too, under the public call's span
    with span("accblas.trsv.leaf_gather"):
        d = _extract_leaf_diag(a, nb * BLOCK // LEAF, lower, unit)
    with span("accblas.trsv.leaf_inverse"):
        inv = _leaf_inverses(d, lower)
    with span("accblas.trsv.panels"):
        bt = _rhs_panels(b, nb)
    with span("accblas.trsv.sweep"):
        return _trsv_sweep(a, inv, bt, lower, ar, out_dtype)


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
    read. `resident=True` takes the blocked composition, False the sweep,
    None the route ``_route`` picks. bf16 storage beyond n=1024 warns."""
    with span("accblas.trsv"):
        _check_bf16_envelope(a, a.shape[0], "f32", unstable_ok, "trsv")
        return _trsv_impl(a, b, uplo, unit, dtypes.canon(b.dtype), resident=resident)


def acc_trsv(a, b, uplo: str = "upper", unit: bool = True, ar: str = "f32", *,
             resident=None, unstable_ok: bool = False):
    """Accessor mixed-precision TRSV: storage from the tensors, arithmetic
    per `ar`. 'f32' solves in f32 and casts to b's storage; 'df64' carries x
    and the corrections as (hi, lo) pairs through the one-pass sweep.
    bf16 storage beyond n=1024 warns unless `unstable_ok`."""
    with span("accblas.trsv"):
        ar = dtypes.check_arithmetic(ar)
        st_out = dtypes.canon(b.dtype)
        _check_bf16_envelope(a, a.shape[0], ar, unstable_ok, "acc_trsv")
        if ar == "f32":
            x0 = _trsv_impl(a, b, uplo, unit, "f32", resident=resident)
            return x0.to(dtypes.torch_dtype(st_out))
        if ar != "df64":
            raise NotImplementedError(f"acc_trsv arithmetic {ar!r}")
        _df64_resident(resident, "acc_trsv")
        return _trsv_impl(a, b, uplo, unit, st_out, resident=False, ar="df64")


def trsm(a, b, uplo: str = "upper", unit: bool = True, *, resident=None,
         unstable_ok: bool = False):
    """Fixed-precision multi-RHS triangular solve: T X = B, B of shape
    (n, k), the same sweep with k right-hand sides."""
    with span("accblas.trsv"):
        _check_bf16_envelope(a, a.shape[0], "f32", unstable_ok, "trsm")
        return _trsm_impl(a, b, uplo, unit, dtypes.canon(b.dtype), resident=resident)


def acc_trsm(a, b, uplo: str = "upper", unit: bool = True, ar: str = "f32", *,
             resident=None, unstable_ok: bool = False):
    """Accessor mixed-precision TRSM: storage from the tensors, arithmetic
    per `ar` ('f32' or 'df64'), as acc_trsv. In df64, wide panels may take
    the DF composition (``_trsm_small_df64``, see ``_route``);
    resident=False forces the sweep and resident=True raises."""
    with span("accblas.trsv"):
        ar = dtypes.check_arithmetic(ar)
        st_out = dtypes.canon(b.dtype)
        _check_bf16_envelope(a, a.shape[0], ar, unstable_ok, "acc_trsm")
        if ar == "f32":
            x0 = _trsm_impl(a, b, uplo, unit, "f32", resident=resident)
            return x0.to(dtypes.torch_dtype(st_out))
        if ar != "df64":
            raise NotImplementedError(f"acc_trsm arithmetic {ar!r}")
        _df64_resident(resident, "acc_trsm")
        return _trsm_impl(a, b, uplo, unit, st_out, resident=resident, ar="df64")


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
