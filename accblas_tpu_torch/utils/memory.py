"""Host/device data managers: the reference's memory layer on torch tensors
(counterpart of ``accblas_tpu.utils.memory``).

- ``Memory<T>`` (``cuda/memory.cuh:14-139``): the host mirror is a numpy
  float64 *master* array, the device side a tensor in a storage dtype on an
  explicit device; H→D is ``to_device``, D→H ``to_host``.
- ``DotMemory<T>`` (``cuda/dot_memory.cuh``): x/y vectors.
- ``GemvMemory<T>`` (``cuda/gemv_memory.cuh``): a max-size matrix with
  per-size leading views, x, res.
- ``TrsvMemory<T>`` (``cuda/trsv_memory.cuh``): the matrix LU-factorized in
  fp64 (the cuSOLVER getrf role, ``torch.linalg.lu_factor`` on the
  manager's device) so its triangles are realistic factors, and the rhs with
  a pristine ``x_init`` copy for resets.

``*_in(dtype)`` / ``view(n, dtype)`` return the device copy in any storage
dtype, cached per canonical dtype name: the conversion-constructor semantics
(``cuda/dot_memory.cuh:62-75``) without a class per type.
"""

from __future__ import annotations

import numpy as np
import torch

from ..accessor import dtypes
from .matrix import MatrixInfo, gen_mtx


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    return dtypes.torch_dtype(dtypes.canon(name))


# storage types numpy casts itself: one rounding from f64, where torch's f64
# -> f16 cast rounds through f32 first
_NUMPY_CAST = {torch.float64: np.float64, torch.float32: np.float32,
               torch.float16: np.float16}


def to_device(host: np.ndarray, dtype, device="cuda") -> torch.Tensor:
    """H→D in a storage dtype (Memory<T>::copy_from, cpu→gpu). The cast
    happens on the host, so only the narrow payload crosses: numpy's for
    f64/f32/f16, torch's for bf16 and f8 (the same bits as numpy's
    ml_dtypes casts)."""
    dt = _torch_dtype(dtype)
    host = np.ascontiguousarray(host)
    if dt in _NUMPY_CAST:
        return torch.from_numpy(host.astype(_NUMPY_CAST[dt])).to(device)
    return torch.from_numpy(host).to(dt).to(device)


def to_host(dev: torch.Tensor) -> np.ndarray:
    """D→H as float64 (the error-measurement direction)."""
    return dev.detach().to(torch.float64).cpu().numpy()


def lead(a: torch.Tensor, n: int) -> torch.Tensor:
    """The leading n (x n) block of a vector or square matrix, contiguous,
    as the kernels take it: `a` itself at full size, else a copy for a
    matrix (a view for a vector)."""
    if a.shape[0] == n:
        return a
    return a[:n] if a.dim() == 1 else a[:n, :n].contiguous()


class _Base:
    def __init__(self, device):
        self.device = torch.device(device)
        self._device_cache: dict = {}

    @staticmethod
    def _dtype_key(dtype) -> str:
        # one cache slot per canonical spelling: 'bf16', torch.bfloat16 and
        # 'bfloat16' must not hold three copies of one buffer
        return dtypes.canon(_torch_dtype(dtype))

    def _dev(self, name: str, dtype) -> torch.Tensor:
        key = (name, self._dtype_key(dtype))
        if key not in self._device_cache:
            self._device_cache[key] = to_device(getattr(self, name), dtype, self.device)
        return self._device_cache[key]

    def invalidate(self, name: str | None = None):
        """Drop cached device copies: all of them, or one buffer's (reset_x
        keeps the unchanged LU matrix on the device)."""
        if name is None:
            self._device_cache.clear()
        else:
            for k in [k for k in self._device_cache if k[0] == name]:
                del self._device_cache[k]


class DotData(_Base):
    """x/y vectors (reference ``DotMemory``, ``cuda/dot_memory.cuh:18-162``)."""

    def __init__(self, n: int, seed: int = 42, device="cuda"):
        super().__init__(device)
        self.n = n
        self.x = gen_mtx(MatrixInfo(1, n), seed=seed)[0]
        self.y = gen_mtx(MatrixInfo(1, n), seed=seed + 1)[0]

    def x_in(self, dtype) -> torch.Tensor:
        return self._dev("x", dtype)

    def y_in(self, dtype) -> torch.Tensor:
        return self._dev("y", dtype)

    def randomize(self, seed: int):
        """Fresh randoms for error re-runs (``write_random`` + ``convert_from``,
        ``cuda/dot_benchmark.cu:195-200``)."""
        self.x = gen_mtx(MatrixInfo(1, self.n), seed=seed)[0]
        self.y = gen_mtx(MatrixInfo(1, self.n), seed=seed + 1)[0]
        self.invalidate()

    def reference(self) -> float:
        """fp64 oracle on the master data."""
        return float(self.x @ self.y)


class GemvData(_Base):
    """A max-size matrix and vectors with per-size leading views (reference
    ``GemvMemory``, ``cuda/gemv_memory.cuh:18-165``; view trick
    ``cuda/gemv_benchmark.cu:215``)."""

    def __init__(self, max_size: int, seed: int = 42, device="cuda"):
        super().__init__(device)
        self.max_size = max_size
        self.a = gen_mtx(MatrixInfo(max_size, max_size), seed=seed)
        self.x = gen_mtx(MatrixInfo(1, max_size), seed=seed + 1)[0]
        self.res = gen_mtx(MatrixInfo(1, max_size), seed=seed + 2)[0]

    def view(self, n: int, dtype):
        """(A[:n,:n], x[:n], res[:n]) on the device in a storage dtype. The
        kernels take a row-major contiguous A, so a smaller A is a copy of
        the leading block (the full-size copy is cached); hold the result
        for a size's runs rather than calling again per rep."""
        return lead(self._dev("a", dtype), n), self._dev("x", dtype)[:n], \
            self._dev("res", dtype)[:n]

    def reference(self, n: int, alpha=1.0, beta=1.0) -> np.ndarray:
        return alpha * (self.a[:n, :n] @ self.x[:n]) + beta * self.res[:n]


class TrsvData(_Base):
    """LU-factorized matrix + rhs with a pristine reset copy (reference
    ``TrsvMemory``, ``cuda/trsv_memory.cuh:87-285``; getrf at
    ``cuda/trsv_memory.cuh:150-163``)."""

    def __init__(self, max_size: int, seed: int = 42, diag_boost: float = 0.0, device="cuda"):
        super().__init__(device)
        self.max_size = max_size
        a = gen_mtx(MatrixInfo(max_size, max_size), seed=seed)
        if diag_boost:
            a += np.eye(max_size) * diag_boost
        self.a = lu_factor64(a, self.device)  # packed LU, pivots unused (as in ref)
        self.b = gen_mtx(MatrixInfo(1, max_size), seed=seed + 1)[0]
        self.x_init = self.b.copy()  # pristine copy (trsv_memory.cuh:208-212)

    def view(self, n: int, dtype):
        return lead(self._dev("a", dtype), n), self._dev("b", dtype)[:n]

    def reset_x(self):
        self.b = self.x_init.copy()
        self.invalidate("b")  # 'a' is unchanged: keep its device copy

    def reference(self, n: int, uplo="upper", unit=True) -> np.ndarray:
        import scipy.linalg

        t = np.triu(self.a[:n, :n]) if uplo == "upper" else np.tril(self.a[:n, :n])
        if unit:
            np.fill_diagonal(t, 1.0)
        return scipy.linalg.solve_triangular(t, self.b[:n], lower=(uplo == "lower"))


def lu_factor64(a: np.ndarray, device) -> np.ndarray:
    """The packed LU factor (partial pivoting, pivots dropped) of float64
    `a`, factorized on `device` by ``torch.linalg.lu_factor`` (cuSOLVER
    getrf on a card, LAPACK on the CPU), returned to the host row-major
    (getrf leaves it column-major)."""
    lu = torch.linalg.lu_factor(torch.from_numpy(np.ascontiguousarray(a)).to(device)).LU
    return lu.contiguous().cpu().numpy()
