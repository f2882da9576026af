"""ctypes binding of the native host runtime (``native/src/accblas_host.cpp``).

Built with g++ (std::thread, no OpenMP) at first use into ``build/accblas_tpu_torch/`` at
the root of the checkout, under a name that carries a hash of the source and
the flags, and never into the package directory. Every entry point has a
numpy equivalent in ``accblas_tpu_torch.utils``, and the two are
bit-identical for generation (tests/test_torch_native.py). Set
ACCBLAS_NO_NATIVE=1 to force the numpy paths. Counterpart of
``accblas_tpu.native.host``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "src" / "accblas_host.cpp"
# -ffp-contract=off: no multiply-add contraction, so each operation rounds
# as the numpy paths' do
CXX_FLAGS = ("-O3", "-pthread", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off",
             "-Wall", "-Wextra")

_lib = None
_tried = False
_why = ""  # why the library could not be built or loaded

_D = ctypes.POINTER(ctypes.c_double)


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"libaccblas_host-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, str(_SRC)],
                       check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    global _lib, _tried, _why
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(_build()))
    except subprocess.CalledProcessError as e:
        _why = f"g++ failed: {e.stderr.strip()[-300:]}"
        return None
    except (OSError, subprocess.SubprocessError) as e:
        _why = f"{type(e).__name__}: {e}"
        return None
    lib.ab_gen_mtx.argtypes = [_D, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_uint64, ctypes.c_double, ctypes.c_double]
    lib.ab_gen_mtx.restype = None
    lib.ab_master_f64.argtypes = [_D, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64]
    lib.ab_master_f64.restype = None
    lib.ab_abs_diff_norm1.argtypes = [_D, _D, ctypes.c_int64]
    lib.ab_abs_diff_norm1.restype = ctypes.c_double
    lib.ab_norm1.argtypes = [_D, ctypes.c_int64]
    lib.ab_norm1.restype = ctypes.c_double
    lib.ab_convert_f64_f32.argtypes = [_D, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.ab_convert_f64_f32.restype = None
    lib.ab_convert_f64_bf16.argtypes = [_D, ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64]
    lib.ab_convert_f64_bf16.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native paths run: built and loaded, and not switched off
    by ACCBLAS_NO_NATIVE (read on every call)."""
    return not os.environ.get("ACCBLAS_NO_NATIVE") and _load() is not None


def describe() -> str:
    """Which path generates host data, for a driver's stderr."""
    if os.environ.get("ACCBLAS_NO_NATIVE"):
        return "numpy (ACCBLAS_NO_NATIVE is set)"
    if available():
        return f"native ({lib_path().name}, g++ -pthread)"
    return f"numpy (no native library: {_why})"


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(_D)


def gen_mtx(rows: int, cols: int, stride: int, seed: int, lo: float, hi: float) -> np.ndarray:
    out = np.empty((rows, stride), np.float64)
    _load().ab_gen_mtx(_dptr(out), rows, cols, stride, seed, lo, hi)
    return out


def master_f64(start: int, n: int, stream: int) -> np.ndarray:
    """fp64 masters of elements [start, start + n) of a devgen stream."""
    out = np.empty(n, np.float64)
    _load().ab_master_f64(_dptr(out), start, n, stream)
    return out


def abs_diff_norm1(a: np.ndarray, b: np.ndarray) -> float:
    a = np.ascontiguousarray(a, np.float64).ravel()
    b = np.ascontiguousarray(b, np.float64).ravel()
    if a.size != b.size:
        raise ValueError(f"abs_diff_norm1: sizes {a.size} and {b.size} differ")
    return _load().ab_abs_diff_norm1(_dptr(a), _dptr(b), a.size)


def norm1(a: np.ndarray) -> float:
    a = np.ascontiguousarray(a, np.float64).ravel()
    return _load().ab_norm1(_dptr(a), a.size)


def convert_f64_f32(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float64)
    out = np.empty(a.shape, np.float32)
    _load().ab_convert_f64_f32(_dptr(a), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               a.size)
    return out


def convert_f64_bf16(a: np.ndarray) -> np.ndarray:
    """float64 -> bfloat16 (an ml_dtypes.bfloat16 numpy array)."""
    import ml_dtypes

    a = np.ascontiguousarray(a, np.float64)
    out = np.empty(a.shape, np.uint16)
    _load().ab_convert_f64_bf16(_dptr(a), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                                a.size)
    return out.view(ml_dtypes.bfloat16)
