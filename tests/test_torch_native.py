"""The port's native host library (accblas_tpu_torch.native.host) against
its numpy paths and the JAX package's, mirroring tests/test_native.py:
generation is bit-identical (the threefry master too, against the JAX
package's), the long-double reductions agree with the fp64 tree reduce to
fp64 precision."""

import ml_dtypes
import numpy as np
import pytest

from accblas_tpu.utils import devgen as jdevgen
from accblas_tpu.utils import matrix as jmatrix
from accblas_tpu_torch.native import host as native
from accblas_tpu_torch.ops._build import BUILD_DIR
from accblas_tpu_torch.utils import MatrixInfo, devgen, gen_mtx, threefry
from accblas_tpu_torch.utils.compare import tree_reduce


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip(f"native library unavailable: {native.describe()}")
    return native


def test_gen_mtx_bit_identical(lib, monkeypatch):
    got = lib.gen_mtx(37, 53, 64, 42, -1.0, 1.0)
    monkeypatch.setenv("ACCBLAS_NO_NATIVE", "1")
    assert not native.available() and native.describe().startswith("numpy")
    ref = gen_mtx(MatrixInfo(37, 53, 64), seed=42)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(ref, jmatrix.gen_mtx(jmatrix.MatrixInfo(37, 53, 64), seed=42))


def test_master_f64_bit_identical(lib, monkeypatch):
    """The native replay of devgen's master, against the numpy one, across
    chunk boundaries of the numpy path, and against the JAX package's."""
    monkeypatch.setattr(threefry, "CHUNK", 1000)
    got = devgen.master_f64((33, 101), 9, "gemv_a", 2)
    ka, kb = threefry.split(devgen.key(9, "gemv_a", 2))
    np.testing.assert_array_equal(lib.master_f64(0, 33 * 101, ka, kb), got.reshape(-1))
    np.testing.assert_array_equal(lib.master_f64(1500, 7, ka, kb), got.reshape(-1)[1500:1507])
    np.testing.assert_array_equal(got, jdevgen.master_f64((33, 101), 9, "gemv_a", 2))
    monkeypatch.setenv("ACCBLAS_NO_NATIVE", "1")
    np.testing.assert_array_equal(devgen.master_f64((33, 101), 9, "gemv_a", 2), got)


def test_master_f64_carries_counters_past_2_32(lib):
    """Flat ranges that cross 2^32 (a master of 2^32 elements and more,
    such as a 65536^2 draw): the native replay against the numpy one."""
    ka, kb = threefry.split(devgen.key(3, "gemv_a", 0))
    start = 2**32 - 4096
    a = threefry.uniform_np(ka, start, start + 8192, -1.0, 1.0).astype(np.float64)
    b = threefry.uniform_np(kb, start, start + 8192, -1.0, 1.0).astype(np.float64)
    np.testing.assert_array_equal(lib.master_f64(start, 8192, ka, kb), a + 2.0**-24 * b)


def test_norms_match_tree_reduce(lib, rng):
    a = rng.uniform(-1, 1, 100_001)
    b = rng.uniform(-1, 1, 100_001)
    ref = tree_reduce(np.abs(a - b))
    assert abs(lib.abs_diff_norm1(a, b) - ref) / ref < 1e-14
    assert abs(lib.norm1(a) - tree_reduce(np.abs(a))) / lib.norm1(a) < 1e-14
    with pytest.raises(ValueError):
        lib.abs_diff_norm1(a, b[:-1])


def test_convert_bf16_rne(lib):
    a = np.array([1.0, 1.0039062500001, -0.3007812, 3.0e38, 1e-40], np.float64)
    got = lib.convert_f64_bf16(a)
    ref = a.astype(np.float32).astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(got.view(np.uint16), ref.view(np.uint16))


def test_convert_f32(lib):
    a = np.linspace(-2, 2, 1000)
    np.testing.assert_array_equal(lib.convert_f64_f32(a), a.astype(np.float32))


def test_library_lives_in_the_build_directory(lib):
    path = lib.lib_path()
    assert path.parent == BUILD_DIR and path.exists()
    assert "native" not in {p.name for p in path.parents}


def test_gen_mtx_subnormal_filter_and_stride():
    m = gen_mtx(MatrixInfo(16, 10, 12), seed=7)
    assert m.shape == (16, 12)
    view = m[:, :10]
    assert np.all(np.abs(view) >= np.finfo(np.float32).tiny)
    assert np.all(np.abs(view) <= 1.0)
    np.testing.assert_array_equal(m[:, 10:], 0.0)
    np.testing.assert_array_equal(m, gen_mtx(MatrixInfo(16, 10, 12), seed=7))
