"""The port's numpy helpers (prng, matrix, compare) are bit-identical copies
of the JAX package's; its torch helpers (interop, devgen, common, bench,
tolerance, build) behave as documented on the CPU."""

import importlib

import ml_dtypes
import numpy as np
import pytest
import torch

from accblas_tpu_torch.accessor.dtypes import torch_dtype
from accblas_tpu_torch.ops import _build, common
from accblas_tpu_torch.utils import devgen, interop, matrix, prng, tolerance
from accblas_tpu_torch.utils.bench import benchmark_function

# the packages export functions named like these modules: import the modules
compare = importlib.import_module("accblas_tpu_torch.utils.compare")
jcommon = importlib.import_module("accblas_tpu.ops.common")
jcompare = importlib.import_module("accblas_tpu.utils.compare")
jmatrix = importlib.import_module("accblas_tpu.utils.matrix")
jprng = importlib.import_module("accblas_tpu.utils.prng")

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 42, 2**40 + 3])
def test_prng_streams_bit_identical(seed):
    idx = np.arange(5000, dtype=np.uint64)
    for rnd in (0, 3):
        np.testing.assert_array_equal(prng.uniform(idx, seed, rnd),
                                      jprng.uniform(idx, seed, rnd))
    np.testing.assert_array_equal(prng.uniform_filtered(7777, seed, -2.0, 3.0),
                                  jprng.uniform_filtered(7777, seed, -2.0, 3.0))


@pytest.mark.parametrize("rows,cols,stride", [(1, 1000, None), (37, 53, None), (16, 10, 13)])
def test_gen_mtx_and_write_random_bit_identical(rows, cols, stride):
    info_t = matrix.MatrixInfo(rows, cols, stride)
    info_j = jmatrix.MatrixInfo(rows, cols, stride)
    assert (info_t.size, info_t.get_1d_size(), info_t.get_num_elems()) == \
        (info_j.size, info_j.get_1d_size(), info_j.get_num_elems())
    got, want = matrix.gen_mtx(info_t, seed=9), jmatrix.gen_mtx(info_j, seed=9)
    np.testing.assert_array_equal(got, want)
    matrix.write_random(got, info_t, seed=10)
    jmatrix.write_random(want, info_j, seed=10)
    np.testing.assert_array_equal(got, want)
    assert matrix.format_mtx(got) == jmatrix.format_mtx(want)
    with pytest.raises(ValueError):
        matrix.MatrixInfo(4, 8, 7)


def test_compare_bit_identical_to_numpy_path():
    rng = np.random.default_rng(1)
    for n in (0, 1, 2, 7, 1000, 4097):
        a, b = rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)
        assert compare.tree_reduce(a) == jcompare.tree_reduce(a)
        assert compare.tree_reduce(a, np.maximum) == jcompare.tree_reduce(a, np.maximum)
        # the JAX package takes a long-double native path when it is built;
        # its numpy path is the tree_reduce the port copies
        assert compare.compare(a, b) == jcompare.tree_reduce(np.abs(a - b))
        assert compare.norm1(a) == jcompare.tree_reduce(np.abs(a))
        if n:
            assert compare.compare(a, b) == pytest.approx(jcompare.compare(a, b), rel=1e-13)
            assert compare.relative_error(a, b) == pytest.approx(
                jcompare.relative_error(a, b), rel=1e-13)
    assert np.isnan(compare.relative_error(np.ones(3), np.zeros(3)))


@pytest.mark.parametrize("st,np_dtype", [
    ("bf16", ml_dtypes.bfloat16), ("f8e4m3", ml_dtypes.float8_e4m3fn),
    ("f8e5m2", ml_dtypes.float8_e5m2), ("f16", np.float16), ("f32", np.float32),
    ("f64", np.float64),
])
def test_interop_keeps_bits(st, np_dtype):
    rng = np.random.default_rng(2)
    arr = rng.uniform(-2, 2, (5, 7)).astype(np.float32).astype(np_dtype)
    t = interop.from_numpy(arr)
    assert t.dtype == torch_dtype(st)
    width = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[arr.itemsize]
    tw = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[arr.itemsize]
    np.testing.assert_array_equal(t.view(tw).numpy().view(width), arr.view(width))
    np.testing.assert_array_equal(t.double().numpy(), arr.astype(np.float64))
    # non-contiguous input and a cast on the way in
    np.testing.assert_array_equal(interop.from_numpy(arr[:, ::2], "f32").numpy(),
                                  arr[:, ::2].astype(np.float32))


def test_devgen_seeded_uniform():
    a = devgen.gen_f32((4096,), 42, "dot_x", device="cpu")
    assert a.dtype == torch.float32 and a.shape == (4096,)
    assert torch.equal(a, devgen.gen_f32((4096,), 42, "dot_x", device="cpu"))
    assert not torch.equal(a, devgen.gen_f32((4096,), 42, "dot_y", device="cpu"))
    assert not torch.equal(a, devgen.gen_f32((4096,), 43, "dot_x", device="cpu"))
    assert not torch.equal(a, devgen.gen_f32((4096,), 42, "a probe role", device="cpu"))
    assert float(a.min()) >= -1.0 and float(a.max()) < 1.0
    assert abs(float(a.mean())) < 0.05 and abs(float(a.std()) - 3**-0.5) < 0.02


@pytest.mark.parametrize("lower,unit", [(True, False), (False, True), (True, True)])
def test_tri_mask_and_pow2_ceil_match_jax(lower, unit):
    rng = np.random.default_rng(3)
    d = rng.uniform(-1, 1, (3, 8, 8)).astype(np.float32)
    offs = np.array([0, 8, 16], np.int32)
    got = common.tri_mask(torch.from_numpy(d), lower, unit)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcommon.tri_mask(d, lower, unit)))
    # past n = 20, the last block continues as identity
    got = common.tri_mask(torch.from_numpy(d), lower, unit, n=20, offs=torch.from_numpy(offs))
    want = jcommon.tri_mask(d, lower, unit, n=20, offs=offs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for v in (1, 2, 3, 127, 128, 129, 10**6):
        assert common.pow2_ceil(v) == jcommon.pow2_ceil(v)


def test_pow2_tree_sum_is_pairwise():
    x = torch.tensor([1.0, 2.0**-24, 2.0**-24, 0.0, 3.0])
    # ((1 + 2^-24) + (2^-24 + 0)) + ((3 + 0) + 0) in f32
    want = (torch.tensor(1.0) + torch.tensor(2.0**-24)) + torch.tensor(2.0**-24) + 3.0
    assert common.pow2_tree_sum(x) == want
    assert common.pow2_tree_sum(torch.zeros(0)) == 0.0
    assert common.pow2_tree_sum(torch.ones(3, 5)).tolist() == [5.0, 5.0, 5.0]


def test_route_rejects_mixed_and_unknown_devices():
    assert common.route("op", torch.zeros(2), torch.zeros(3)) == "cpu"
    with pytest.raises(ValueError, match="no route"):
        common.route("op", torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        common.route("op", torch.zeros(2), torch.zeros(2, device="meta"))


def test_gemv_row_err_nets_out_storage_rounding():
    ref = torch.tensor([1.0, -2.0, 4.0], dtype=torch.float64)
    scale = torch.tensor([2.0, 2.0, 8.0], dtype=torch.float64)
    got = ref + torch.tensor([2.0**-24, 0.0, -8e-6], dtype=torch.float64)
    assert tolerance.gemv_row_err(got, ref, scale) == pytest.approx(1e-6)
    assert tolerance.gemv_row_err(got, ref, scale, torch.float32) == pytest.approx(
        (8e-6 - 4 * 2.0**-24) / 8)
    assert tolerance.narrow_bound(0.0) == 4 * 2.0**-8


def test_cpu_has_no_device_timer_and_no_kernel_build(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA device"):
        benchmark_function(lambda: None)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "_NVCC_DEFAULT", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_build_key_and_storage_codes():
    p1 = _build._lib_path("dot")
    assert p1 == _build._lib_path("dot") and p1.parent == _build.BUILD_DIR
    assert p1 != _build._lib_path("gemv")
    assert _build.storage_code(torch.zeros(1, dtype=torch.float8_e5m2), "x") == 4
    with pytest.raises(ValueError, match="kernel storage type"):
        _build.storage_code(torch.zeros(1, dtype=torch.int8), "x")
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _build.check(1, "launch")
