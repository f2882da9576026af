"""Three ops written once against the accessor: generic AXPY, generic GEMV
and the strided-window sum, at f32 arithmetic over any storage type and at
df64 arithmetic.

They are the counterparts of the Pallas kernels that the JAX package's tests
write against ``Range`` to show that one kernel body runs at every
(storage, arithmetic) pair (``tests/test_generic_kernel.py``: ``axpy``,
``gemv_generic``; ``tests/test_accessor.py``: the window sum). The JAX
package exports no such op, and neither does this package.

A CUDA tensor runs the kernels of ``csrc/generic.cu``, whose bodies are
written once against the device ``Range`` (``csrc/range.cuh``); a CPU tensor
runs the plain versions here, written once against ``accessor.range.Range``
and the ``DF`` operators. Nothing falls back from one to the other. The sums
run in the kernels' order:

- GEMV: ``_reduce_last``'s pairwise halving (column j meets j + w/2) over
  the products zero-padded to the next power of two. The JAX helper halves
  without padding, which drops a column at a width that is not a power of
  two; at a power of two the two agree.
- window sum: the window zero-padded to (M, N), both powers of two, read
  flat as (K, B, T) and halved over K, then T, then B (``_window_split``):
  the kernel's threads (each holding V neighbouring t), blocks and the last
  block's fold of the block sums.

All three kernels read V neighbouring stored values at once
(``vector_width``: 4 for f32, 8 for bf16, 4 under df64), and AXPY writes its
V results at once, where the operands' bases and row strides are multiples
of V elements (and, for the sums, the fold fits the vector instantiation's
counter); elsewhere they launch the V = 1 instantiation of the same body
(``axpy_vector``, ``gemv_vector``, ``window_vector``). The sums' order, and
so their bits, do not depend on V.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..accessor import dtypes
from ..accessor.range import Range, ReducedRowMajor
from . import _build
from .common import pow2_ceil, pow2_tree_sum, route, zero_pad

# launches of the kernels, counted where the wrappers launch them
axpy_launches = 0
gemv_launches = 0
window_launches = 0

# arithmetic codes (csrc/range.cuh)
AR_CODE = {"f32": 0, "df64": 1}
# the torch dtype of each kernel storage type, for an output
_OUT_DTYPE = {name: dtypes.torch_dtype(name) for name in _build.STORAGE_CODE}

_WINDOW_T = 256  # T of the window's (K, B, T): a block's threads times V
# window blocks B, whose sums the last block folds: the scratch's partials
# (csrc/reduce.cuh kScratchBlocks; the launcher refuses more)
_MAX_BLOCKS = 1024
# log2 of the steps a fold slot takes at most (csrc/generic.cu): kSteps at a
# time into a binary counter of kLevelsVec = 8 levels (the vector
# instantiation, True) or kLevelsOne = 20 (V = 1, False)
_STEPS = 16
_LOG2_MAX_PER = {True: _STEPS.bit_length() - 1 + 7, False: _STEPS.bit_length() - 1 + 19}

_AXPY_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
              ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_GEMV_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
              ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_WINDOW_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]


def _arith(ar) -> str:
    if ar in AR_CODE:  # the common case, without the lookups below
        return ar
    ar = dtypes.check_arithmetic(ar)
    if ar not in AR_CODE:
        raise ValueError(f"the generic kernels run at f32 or df64 arithmetic, not {ar}")
    return ar


def _storage(t, what: str) -> str:
    if isinstance(t, str) and t in _build.STORAGE_CODE:  # the common case
        return t
    name = dtypes.canon(t.dtype if isinstance(t, torch.Tensor) else t)
    if name not in _build.STORAGE_CODE:
        raise ValueError(f"{what}: {name} is not a kernel storage type "
                         f"({', '.join(_build.STORAGE_CODE)})")
    return name


def _rows(t, what: str):
    """Raise unless t is 2-D with unit column stride, as the device Range
    reads it (row-major rows, any row stride)."""
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(f"{what}: needs a 2-D tensor with unit column stride, "
                         f"got shape {tuple(t.shape)} strides {t.stride()}")


def _log2(v: int) -> int:
    return v.bit_length() - 1


def vector_width(dtype: torch.dtype, ar: str) -> int:
    """Stored values one vector read of the generic kernels takes for
    storage `dtype`: 16 bytes of storage, at most 32 bytes of arithmetic
    values (a fold slot each), as csrc/generic.cu's vec_of."""
    return min(16 // dtype.itemsize, 32 // (8 if ar == "df64" else 4))


def _aligned(v: int, t: torch.Tensor, offset: int = 0, stride: int = 0) -> bool:
    """Whether element `offset` of t, and every `stride` elements on, lies
    at a multiple of v elements (v elements of t's dtype)."""
    size = t.element_size()
    return stride % v == 0 and (t.data_ptr() + offset * size) % (v * size) == 0


def _rows_aligned(v: int, t: torch.Tensor) -> bool:
    """Whether every row of 2-D t starts at a multiple of v elements: its
    base, and its row stride where it has more than one row."""
    return _aligned(v, t, 0, t.stride(0) if t.shape[0] > 1 else 0)


# ---------------------------------------------------------------- AXPY

def _axpy_plain(x, y, ar: str, out_st: str, alpha: float):
    """o = x * alpha + y through Ranges (the JAX kernel's body)."""
    xr = Range(ReducedRowMajor(ar, x.dtype), x, const=True)
    yr = Range(ReducedRowMajor(ar, y.dtype), y, const=True)
    out = torch.empty(x.shape, dtype=dtypes.torch_dtype(out_st), device=x.device)
    o = Range(ReducedRowMajor(ar, out_st), out)
    o.store(xr.load() * alpha + yr.load())
    return out


def axpy_vector(x, y, out, ar: str) -> int:
    """V of the AXPY instantiation the wrapper launches for x, y and its
    output `out`: the vector width of x's storage where every row of x, y
    and out starts at a multiple of it, else 1 (the GEMV's rule for A)."""
    v = vector_width(x.dtype, ar)
    return v if all(_rows_aligned(v, t) for t in (x, y, out)) else 1


def _axpy_cuda(x, y, ar: str, st: int, out_st: str, alpha: float):
    global axpy_launches
    rows, cols = x.shape
    out = x.new_empty((rows, cols), dtype=_OUT_DTYPE[out_st])
    if rows and cols:
        fn = _build.function("generic", "accblas_generic_axpy", _AXPY_ARGS)
        with _build.on_device(x):
            err = fn(x.data_ptr(), x.stride(0), y.data_ptr(), y.stride(0), st, out.data_ptr(),
                     out.stride(0), _build.STORAGE_CODE[out_st], rows, cols, AR_CODE[ar], alpha,
                     axpy_vector(x, y, out, ar), _build.stream(x))
        _build.check(err, "generic_axpy kernel launch")
        axpy_launches += 1
    return out


def axpy(x, y, ar, out_st, alpha=2.0):
    """x * alpha + y over 2-D x and y of one storage type, in arithmetic
    `ar` ('f32' or 'df64'), stored as `out_st`."""
    ar, out_st = _arith(ar), _storage(out_st, "axpy out_st")
    st = _build.STORAGE_CODE[_storage(x, "axpy x")]
    if x.dtype != y.dtype or x.shape != y.shape:
        raise ValueError(f"axpy: x and y need one dtype and shape, got {x.dtype} "
                         f"{tuple(x.shape)} and {y.dtype} {tuple(y.shape)}")
    _rows(x, "axpy x")
    _rows(y, "axpy y")
    if x.is_cuda and y.is_cuda and x.get_device() == y.get_device() \
            or route("axpy", x, y) == "cuda":
        return _axpy_cuda(x, y, ar, st, out_st, float(alpha))
    return _axpy_plain(x, y, ar, out_st, float(alpha))


# ---------------------------------------------------------------- GEMV

def _gemv_generic_plain(a, x, r, ar: str, out_st: str, alpha: float, beta: float):
    """o = (A x) * alpha + r * beta through Ranges (the JAX kernel's body),
    the row sums by zero-padded halving."""
    m, n = a.shape
    ra = Range(ReducedRowMajor(ar, a.dtype), a, const=True)
    rx = Range(ReducedRowMajor(ar, x.dtype), x.reshape(1, n), const=True)
    rr = Range(ReducedRowMajor(ar, r.dtype), r.reshape(m, 1), const=True)
    out = torch.empty((m, 1), dtype=dtypes.torch_dtype(out_st), device=a.device)
    o = Range(ReducedRowMajor(ar, out_st), out)
    val = pow2_tree_sum(ra.load() * rx.load()).reshape(m, 1)
    o.store(val * alpha + rr.load() * beta)
    return out


@functools.lru_cache(maxsize=256)
def _gemv_split(n: int, v: int) -> tuple[int, int, int]:
    """(lanes, log2 of the steps a lane takes, slots) of a row of n columns
    read v at a time, one warp a row: column (k lanes + t) v + s of the
    zero-padded width is step k of lane t, slot s; `slots` of the v count
    (fewer only below v columns)."""
    width = pow2_ceil(max(n, 1))
    slots = min(v, width)
    lanes = min(32, width // slots)
    return lanes, _log2(width // (lanes * slots)), slots


def _gemv_plan(a, x, ar: str) -> tuple[int, int, int, int]:
    """(V, lanes, log2 of the steps a lane takes, slots) of the GEMV launch:
    V the vector width where A's base and row stride and x's base are
    multiples of it and a lane's steps fit its counter, else 1."""
    n = a.shape[1]
    v = vector_width(a.dtype, ar)
    split = _gemv_split(n, v)
    if not (split[1] <= _LOG2_MAX_PER[True] and _aligned(v, x) and _rows_aligned(v, a)):
        v, split = 1, _gemv_split(n, 1)
        if split[1] > _LOG2_MAX_PER[False] or n >= 2**30:
            raise ValueError(f"gemv_generic: n = {n} is past the kernel's fold")
    return (v, *split)


def gemv_vector(a, x, ar: str) -> int:
    """V of the GEMV instantiation the wrapper launches for A and x (x as
    the wrapper passes it, contiguous)."""
    return _gemv_plan(a, x, ar)[0]


def _gemv_generic_cuda(a, x, r, ar: str, out_st: str, alpha: float, beta: float, st: int):
    global gemv_launches
    m, n = a.shape
    out = a.new_empty((m, 1), dtype=r.dtype)
    x, r = x.contiguous(), r.contiguous()
    v, lanes, log2_per, slots = _gemv_plan(a, x, ar)
    if m:
        fn = _build.function("generic", "accblas_generic_gemv", _GEMV_ARGS)
        with _build.on_device(a):
            err = fn(a.data_ptr(), a.stride(0), x.data_ptr(), r.data_ptr(), out.data_ptr(),
                     st, _build.STORAGE_CODE[out_st], m, n, AR_CODE[ar], alpha, beta, lanes,
                     log2_per, slots, v, _build.stream(a))
        _build.check(err, "generic_gemv kernel launch")
        gemv_launches += 1
    return out


def gemv_generic(a, x, r, ar, out_st, alpha=1.5, beta=-0.5):
    """(A x) * alpha + r * beta as an (m, 1) tensor of `out_st`, in
    arithmetic `ar` ('f32' or 'df64'). x (n elements) takes A's storage type,
    r (m elements) the output's."""
    ar, out_st = _arith(ar), _storage(out_st, "gemv_generic out_st")
    st = _build.storage_code(a, "gemv_generic a")
    _rows(a, "gemv_generic a")
    m, n = a.shape
    if x.numel() != n or r.numel() != m:
        raise ValueError(f"gemv_generic: A {tuple(a.shape)} needs {n} x and {m} r "
                         f"elements, got {x.numel()} and {r.numel()}")
    if x.dtype != a.dtype or r.dtype != dtypes.torch_dtype(out_st):
        raise ValueError(f"gemv_generic: x takes A's dtype and r the output's, got "
                         f"A {a.dtype}, x {x.dtype}, r {r.dtype}, out {out_st}")
    if route("gemv_generic", a, x, r) == "cuda":
        return _gemv_generic_cuda(a, x, r, ar, out_st, float(alpha), float(beta), st)
    return _gemv_generic_plain(a, x, r, ar, out_st, float(alpha), float(beta))


# ---------------------------------------------------------------- window sum

@functools.lru_cache(maxsize=256)
def _window_split(m: int, n: int) -> tuple[int, int, int, int]:
    """The kernel's reading of the zero-padded (M, N) window: (log2 N,
    blocks B, T, log2 of K), M N = K B T. T is the threads of a block times
    the V neighbouring t each holds, whatever V."""
    cols = pow2_ceil(n)
    total = pow2_ceil(m) * cols
    threads = min(_WINDOW_T, total)
    blocks = min(_MAX_BLOCKS, total // threads)
    return _log2(cols), blocks, threads, _log2(total // (threads * blocks))


def window_vector(parent, row0: int, col0: int, m: int, n: int, ar: str) -> int:
    """V of the window-sum instantiation the wrapper launches: the vector
    width where the window's base and the parent's row stride are multiples
    of it and a slot's steps fit its counter, else 1."""
    v = vector_width(parent.dtype, ar)
    log2_per = _window_split(m, n)[3]
    stride = parent.stride(0)
    if log2_per <= _LOG2_MAX_PER[True] and _aligned(v, parent, row0 * stride + col0,
                                                      stride if m > 1 else 0):
        return v
    if log2_per > _LOG2_MAX_PER[False]:
        raise ValueError(f"window_sum: a ({m}, {n}) window is past the kernel's fold")
    return 1


def _window_sum_plain(parent, row0: int, col0: int, m: int, n: int, ar: str):
    """The sum of the window through a Range, folded in the kernel's order;
    stored through a (1, 1) f32 Range."""
    w = Range(ReducedRowMajor(ar, parent.dtype), parent[row0:row0 + m, col0:col0 + n],
              const=True)
    log2_n, blocks, threads, log2_per = _window_split(m, n)
    v = zero_pad(zero_pad(w.load(), 0, pow2_ceil(m)), 1, 1 << log2_n)
    v = v.reshape(1 << log2_per, blocks, threads)
    total = pow2_tree_sum(pow2_tree_sum(pow2_tree_sum(v, 0)), 0)
    out = torch.empty((1, 1), dtype=torch.float32, device=parent.device)
    Range(ReducedRowMajor(ar, "f32"), out).store(total)
    return out


def _window_sum_cuda(parent, row0: int, col0: int, m: int, n: int, ar: str, st: int):
    global window_launches
    log2_n, blocks, threads, log2_per = _window_split(m, n)
    v = window_vector(parent, row0, col0, m, n, ar)
    out = parent.new_empty((1, 1), dtype=torch.float32)
    fn = _build.function("generic", "accblas_window_sum", _WINDOW_ARGS)
    with _build.on_device(parent):
        stream = _build.stream(parent)
        err = fn(parent.data_ptr(), st, parent.stride(0), row0, col0, m, n, AR_CODE[ar],
                 out.data_ptr(), _build.scratch(parent, stream), log2_n, blocks,
                 _log2(threads), log2_per, v, stream)
    _build.check(err, "window_sum kernel launch")
    window_launches += 1
    return out


def window_sum(parent, row0, col0, m, n, ar="f32"):
    """The sum, in arithmetic `ar` ('f32' or 'df64'), of the (m, n) window at
    (row0, col0) of a 2-D parent, as a (1, 1) float32 tensor."""
    ar = _arith(ar)
    st = _build.storage_code(parent, "window_sum parent")
    _rows(parent, "window_sum parent")
    row0, col0, m, n = (int(v) for v in (row0, col0, m, n))
    if min(row0, col0, m, n) < 0 or row0 + m > parent.shape[0] or col0 + n > parent.shape[1]:
        raise ValueError(f"window_sum: the ({m}, {n}) window at ({row0}, {col0}) is not "
                         f"inside the parent {tuple(parent.shape)}")
    if m == 0 or n == 0:
        return torch.zeros((1, 1), dtype=torch.float32, device=parent.device)
    if route("window_sum", parent) == "cuda":
        return _window_sum_cuda(parent, row0, col0, m, n, ar, st)
    return _window_sum_plain(parent, row0, col0, m, n, ar)
