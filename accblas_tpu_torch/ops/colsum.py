"""Column sums of a matrix in f32: the f8 convert stream of the TPU probe.

``col_sums(a)`` returns the (1, n) float32 row ``out[0, j] = sum_i a[i, j]``
of a contiguous (m, n) matrix of any kernel storage type (f32, bf16, f16,
f8e4m3, f8e5m2), each value cast exactly to f32 on load. It is the
counterpart of ``conv_kernel`` in ``scripts/probe_r4a.py``, which the JAX
package runs only as a probe of how fast the TPU converts f8 in a stream;
neither package exports it.

A CUDA tensor runs the two launches of ``csrc/colsum.cu``; a CPU tensor
runs ``_col_sums_plain``, the same sums in the same order in plain torch
ops, so the two agree bit for bit. Nothing falls back from one to the
other. The order: the rows split into chunks of `rows_per_block`; each
chunk sums its rows in order from +0, then the chunk sums add in chunk
order from +0.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .common import route, zero_pad

# launches of the kernels, counted where the wrapper launches them (a call
# is two: colsum_partial, then colsum_fold)
launches = 0

ROWS_PER_BLOCK = 256  # rows a CTA sums before the fold (the default chunk)
_MAX_CHUNKS = 65535  # the partial launch's grid y
_VEC_BYTES = 16  # the kernel's vector load

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _check(a, rows_per_block):
    """Raise unless `a` is a 2-D contiguous matrix of a kernel storage type;
    returns the rows a chunk."""
    if a.dim() != 2 or not a.is_contiguous():
        raise ValueError(f"col_sums needs a contiguous 2-D tensor, got shape "
                         f"{tuple(a.shape)} strides {a.stride()}")
    _build.storage_code(a, "col_sums a")
    rows = ROWS_PER_BLOCK if rows_per_block is None else int(rows_per_block)
    if rows < 1:
        raise ValueError(f"col_sums: rows_per_block must be positive, got {rows}")
    if -(-a.shape[0] // rows) > _MAX_CHUNKS:
        raise ValueError(f"col_sums: {a.shape[0]} rows in chunks of {rows} is more than "
                         f"{_MAX_CHUNKS} chunks; take larger chunks")
    return rows


def vector_path(a) -> bool:
    """Whether the kernel takes its 16-byte loads for `a`: every row starts
    on a 16-byte boundary. Otherwise it loads element by element."""
    return (a.data_ptr() % _VEC_BYTES == 0
            and a.shape[1] * a.element_size() % _VEC_BYTES == 0)


def _col_sums_plain(a, rows_per_block=None):
    """The column sums in the kernel's order: rows in order within each
    chunk, then the chunk sums in order, each from +0."""
    rows = _check(a, rows_per_block)
    m, n = a.shape
    out = torch.zeros((1, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    chunks = -(-m // rows)
    v = zero_pad(a.float(), 0, chunks * rows).view(chunks, rows, n)
    s = torch.zeros((chunks, n), dtype=torch.float32, device=a.device)
    for i in range(min(rows, m)):
        s = s + v[:, i]
    for c in range(chunks):
        out = out + s[c]
    return out


def _col_sums_cuda(a, rows: int):
    global launches
    m, n = a.shape
    if m == 0 or n == 0:
        return torch.zeros((1, n), dtype=torch.float32, device=a.device)
    out = torch.empty((1, n), dtype=torch.float32, device=a.device)
    partial = torch.empty((-(-m // rows), n), dtype=torch.float32, device=a.device)
    fn = _build.function("colsum", "accblas_col_sums", _ARGS)
    with _build.on_device(a):
        err = fn(a.data_ptr(), _build.storage_code(a, "col_sums a"), m, n, rows,
                 int(vector_path(a)), partial.data_ptr(), out.data_ptr(), _build.stream(a))
    _build.check(err, "col_sums kernel launch")
    launches += 2
    return out


def col_sums(a, rows_per_block=None):
    """The (1, n) float32 column sums of a contiguous (m, n) matrix `a`,
    summed in chunks of `rows_per_block` rows (default ``ROWS_PER_BLOCK``).
    A non-contiguous `a` raises: it is never copied."""
    rows = _check(a, rows_per_block)
    if route("col_sums", a) == "cuda":
        return _col_sums_cuda(a, rows)
    return _col_sums_plain(a, rows)
