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
  the kernel's threads, blocks and second launch.
"""

from __future__ import annotations

import ctypes

import torch

from ..accessor import dtypes
from ..accessor.range import Range, ReducedRowMajor
from . import _build
from .common import pow2_ceil, pow2_tree_sum, route, zero_pad

# launches of the kernels, counted where the wrappers launch them (a
# window sum is two: window_sum_blocks, then window_sum_final)
axpy_launches = 0
gemv_launches = 0
window_launches = 0

# arithmetic codes (csrc/range.cuh)
AR_CODE = {"f32": 0, "df64": 1}

_THREADS = 256  # threads of an AXPY, GEMV or window block
_GEMV_ROWS = _THREADS // 32  # GEMV rows a block, one a warp
_MAX_BLOCKS = 1024  # window blocks: the second launch folds them in one block
_MAX_PER_THREAD = 2**19  # values one thread folds (csrc/generic.cu kLevels)
_AXPY_UNROLL = 4  # AXPY columns a thread has in flight (csrc/generic.cu kUnroll)

_AXPY_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
              ctypes.c_int, ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
_GEMV_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
              ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
              ctypes.c_uint, ctypes.c_void_p]
_WINDOW_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _arith(ar) -> str:
    ar = dtypes.check_arithmetic(ar)
    if ar not in AR_CODE:
        raise ValueError(f"the generic kernels run at f32 or df64 arithmetic, not {ar}")
    return ar


def _storage(t, what: str) -> str:
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


# ---------------------------------------------------------------- AXPY

def _axpy_plain(x, y, ar: str, out_st: str, alpha: float):
    """o = x * alpha + y through Ranges (the JAX kernel's body)."""
    xr = Range(ReducedRowMajor(ar, x.dtype), x, const=True)
    yr = Range(ReducedRowMajor(ar, y.dtype), y, const=True)
    out = torch.empty(x.shape, dtype=dtypes.torch_dtype(out_st), device=x.device)
    o = Range(ReducedRowMajor(ar, out_st), out)
    o.store(xr.load() * alpha + yr.load())
    return out


def _axpy_cuda(x, y, ar: str, out_st: str, alpha: float):
    global axpy_launches
    rows, cols = x.shape
    out = torch.empty((rows, cols), dtype=dtypes.torch_dtype(out_st), device=x.device)
    if rows and cols:
        grid_x = min(-(-cols // (_THREADS * _AXPY_UNROLL)), 2048)
        grid_y = min(rows, max(1, 2048 // grid_x), 65535)
        fn = _build.function("generic", "accblas_generic_axpy", _AXPY_ARGS)
        with _build.on_device(x):
            err = fn(x.data_ptr(), x.stride(0), y.data_ptr(), y.stride(0),
                     _build.STORAGE_CODE[_storage(x, "axpy x")], out.data_ptr(), out.stride(0),
                     _build.STORAGE_CODE[out_st], rows, cols, AR_CODE[ar], alpha, grid_x,
                     grid_y, _build.stream(x))
        _build.check(err, "generic_axpy kernel launch")
        axpy_launches += 1
    return out


def axpy(x, y, ar, out_st, alpha=2.0):
    """x * alpha + y over 2-D x and y of one storage type, in arithmetic
    `ar` ('f32' or 'df64'), stored as `out_st`."""
    ar, out_st = _arith(ar), _storage(out_st, "axpy out_st")
    _storage(x, "axpy x")
    if x.dtype != y.dtype or x.shape != y.shape:
        raise ValueError(f"axpy: x and y need one dtype and shape, got {x.dtype} "
                         f"{tuple(x.shape)} and {y.dtype} {tuple(y.shape)}")
    _rows(x, "axpy x")
    _rows(y, "axpy y")
    if route("axpy", x, y) == "cuda":
        return _axpy_cuda(x, y, ar, out_st, float(alpha))
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


def _gemv_split(n: int) -> tuple[int, int]:
    """(lanes, log2 of the values per lane) of a row of n columns: one warp
    a row."""
    width = pow2_ceil(max(n, 1))
    lanes = min(32, width)
    if width // lanes > _MAX_PER_THREAD:
        raise ValueError(f"gemv_generic: n = {n} is past the kernel's fold "
                         f"({32 * _MAX_PER_THREAD} columns)")
    return lanes, _log2(width // lanes)


def _gemv_generic_cuda(a, x, r, ar: str, out_st: str, alpha: float, beta: float):
    global gemv_launches
    m, n = a.shape
    out = torch.empty((m, 1), dtype=dtypes.torch_dtype(out_st), device=a.device)
    lanes, log2_per = _gemv_split(n)
    x, r = x.contiguous(), r.contiguous()
    if m:
        fn = _build.function("generic", "accblas_generic_gemv", _GEMV_ARGS)
        with _build.on_device(a):
            err = fn(a.data_ptr(), a.stride(0), x.data_ptr(), r.data_ptr(), out.data_ptr(),
                     _build.STORAGE_CODE[_storage(a, "gemv_generic a")],
                     _build.STORAGE_CODE[out_st], m, n, AR_CODE[ar], alpha, beta, lanes,
                     log2_per, min(-(-m // _GEMV_ROWS), 2**20), _build.stream(a))
        _build.check(err, "generic_gemv kernel launch")
        gemv_launches += 1
    return out


def gemv_generic(a, x, r, ar, out_st, alpha=1.5, beta=-0.5):
    """(A x) * alpha + r * beta as an (m, 1) tensor of `out_st`, in
    arithmetic `ar` ('f32' or 'df64'). x (n elements) takes A's storage type,
    r (m elements) the output's."""
    ar, out_st = _arith(ar), _storage(out_st, "gemv_generic out_st")
    _storage(a, "gemv_generic a")
    _rows(a, "gemv_generic a")
    m, n = a.shape
    if x.numel() != n or r.numel() != m:
        raise ValueError(f"gemv_generic: A {tuple(a.shape)} needs {n} x and {m} r "
                         f"elements, got {x.numel()} and {r.numel()}")
    if x.dtype != a.dtype or dtypes.canon(r.dtype) != out_st:
        raise ValueError(f"gemv_generic: x takes A's dtype and r the output's, got "
                         f"A {a.dtype}, x {x.dtype}, r {r.dtype}, out {out_st}")
    if route("gemv_generic", a, x, r) == "cuda":
        return _gemv_generic_cuda(a, x, r, ar, out_st, float(alpha), float(beta))
    return _gemv_generic_plain(a, x, r, ar, out_st, float(alpha), float(beta))


# ---------------------------------------------------------------- window sum

def _window_split(m: int, n: int) -> tuple[int, int, int, int]:
    """The kernel's reading of the zero-padded (M, N) window: (log2 N,
    blocks B, threads T, log2 of K), M N = K B T."""
    cols = pow2_ceil(n)
    total = pow2_ceil(m) * cols
    threads = min(_THREADS, total)
    blocks = min(_MAX_BLOCKS, total // threads)
    per = total // (threads * blocks)
    if per > _MAX_PER_THREAD:
        raise ValueError(f"window_sum: a ({m}, {n}) window is past the kernel's fold")
    return _log2(cols), blocks, threads, _log2(per)


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


def _window_sum_cuda(parent, row0: int, col0: int, m: int, n: int, ar: str):
    global window_launches
    log2_n, blocks, threads, log2_per = _window_split(m, n)
    out = torch.empty((1, 1), dtype=torch.float32, device=parent.device)
    partial = torch.empty(blocks * (2 if ar == "df64" else 1), dtype=torch.float32,
                          device=parent.device)
    fn = _build.function("generic", "accblas_window_sum", _WINDOW_ARGS)
    with _build.on_device(parent):
        err = fn(parent.data_ptr(), _build.STORAGE_CODE[_storage(parent, "window_sum parent")],
                 parent.stride(0), row0, col0, m, n, AR_CODE[ar], out.data_ptr(),
                 partial.data_ptr(), log2_n, blocks, threads, log2_per, _build.stream(parent))
    _build.check(err, "window_sum kernel launch")
    window_launches += 2
    return out


def window_sum(parent, row0, col0, m, n, ar="f32"):
    """The sum, in arithmetic `ar` ('f32' or 'df64'), of the (m, n) window at
    (row0, col0) of a 2-D parent, as a (1, 1) float32 tensor."""
    ar = _arith(ar)
    _storage(parent, "window_sum parent")
    _rows(parent, "window_sum parent")
    row0, col0, m, n = (int(v) for v in (row0, col0, m, n))
    if min(row0, col0, m, n) < 0 or row0 + m > parent.shape[0] or col0 + n > parent.shape[1]:
        raise ValueError(f"window_sum: the ({m}, {n}) window at ({row0}, {col0}) is not "
                         f"inside the parent {tuple(parent.shape)}")
    if m == 0 or n == 0:
        return torch.zeros((1, 1), dtype=torch.float32, device=parent.device)
    if route("window_sum", parent) == "cuda":
        return _window_sum_cuda(parent, row0, col0, m, n, ar)
    return _window_sum_plain(parent, row0, col0, m, n, ar)
