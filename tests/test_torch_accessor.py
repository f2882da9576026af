"""The port's accessor (dtypes lattice, ReducedRowMajor, Range) against the
JAX package's accessor, on identical bits."""

import itertools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from accblas_tpu.accessor import dtypes as jdt
from accblas_tpu.accessor import range as jrange
from accblas_tpu_torch.accessor import dtypes as tdt
from accblas_tpu_torch.accessor import range as trange
from accblas_tpu_torch.ops.df64 import DF
from accblas_tpu_torch.utils.interop import from_numpy

torch.set_num_threads(1)

NAMES = ("f8e5m2", "f8e4m3", "bf16", "f16", "f32", "df64", "f64")
STORAGE = ("f8e5m2", "f8e4m3", "bf16", "f16", "f32")
ARITH = ("bf16", "f16", "f32", "df64")
_NP = {"f8e4m3": ml_dtypes.float8_e4m3fn, "f8e5m2": ml_dtypes.float8_e5m2,
       "bf16": ml_dtypes.bfloat16, "f16": np.float16, "f32": np.float32, "f64": np.float64}


def _np(v) -> np.ndarray:
    """A result of either package as a numpy array, bf16/f8 widened to f32."""
    if isinstance(v, torch.Tensor):
        wide = v.dtype in (torch.float16, torch.float32, torch.float64)
        return v.numpy() if wide else v.float().numpy()
    a = np.asarray(v)
    return a if a.dtype in (np.float16, np.float32, np.float64) else a.astype(np.float32)


def _stored(rng, shape, st):
    return rng.uniform(-1, 1, shape).astype(np.float32).astype(_NP[st])


@pytest.mark.parametrize("a,b", list(itertools.combinations_with_replacement(NAMES, 2)))
def test_promote_all_pairs_match_jax(a, b):
    assert tdt.promote(a, b) == jdt.promote(a, b)
    assert tdt.promote(b, a) == jdt.promote(b, a)


def test_canon_names_aliases_and_dtypes():
    for spec in NAMES + ("float32", "fp64", "bfloat16", "df", "fp8", "float8_e5m2", "FP32"):
        assert tdt.canon(spec) == jdt.canon(spec)
    for name in ("f8e4m3", "f8e5m2", "bf16", "f16", "f32", "f64"):
        assert tdt.canon(tdt.torch_dtype(name)) == name == jdt.canon(jdt.jnp_dtype(name))
        assert tdt.storage_bytes(name) == jdt.storage_bytes(name)
    assert tdt.STORAGE_ONLY == jdt.STORAGE_ONLY
    assert tdt.promote(torch.float32, torch.bfloat16) == "f32"
    for bad in ("f128", torch.int32):
        with pytest.raises(ValueError):
            tdt.canon(bad)
    with pytest.raises(ValueError):
        tdt.torch_dtype("df64")


@pytest.mark.parametrize("name", NAMES)
def test_check_arithmetic_matches_jax(name):
    if name in jdt.STORAGE_ONLY:
        with pytest.raises(ValueError, match="storage-only"):
            tdt.check_arithmetic(name)
        with pytest.raises(ValueError):
            trange.ReducedRowMajor(name, "f32")
    else:
        assert tdt.check_arithmetic(name) == jdt.check_arithmetic(name)


@pytest.mark.parametrize("ar,st", list(itertools.product(ARITH, STORAGE)))
def test_load_and_store_cast_match_jax(ar, st):
    rng = np.random.default_rng(10 * ARITH.index(ar) + STORAGE.index(st))
    raw = _stored(rng, (6, 10), st)
    tspec, jspec = trange.ReducedRowMajor(ar, st), jrange.ReducedRowMajor(ar, st)
    got, want = tspec.load_cast(from_numpy(raw)), jspec.load_cast(jnp.asarray(raw))
    if ar == "df64":
        np.testing.assert_array_equal(got.hi.numpy(), np.asarray(want.hi))
        np.testing.assert_array_equal(got.lo.numpy(), np.asarray(want.lo))
        value_t, value_j = got, want
    else:
        assert got.dtype == tdt.torch_dtype(ar)
        np.testing.assert_array_equal(_np(got), _np(want))
        value_t, value_j = got.float() * 1.5, jnp.asarray(want, jnp.float32) * 1.5
    back_t, back_j = tspec.store_cast(value_t), jspec.store_cast(value_j)
    assert back_t.dtype == tdt.torch_dtype(st)
    np.testing.assert_array_equal(_np(back_t), _np(back_j))


def test_df64_over_f64_split_and_store_match_jax():
    rng = np.random.default_rng(3)
    raw = np.concatenate([rng.uniform(-1, 1, 14), [1e39, -1e39]])
    tspec = trange.ReducedRowMajor("df64", "f64")
    got = tspec.load_cast(torch.from_numpy(raw))
    with jax.enable_x64():
        want = jrange.ReducedRowMajor("df64", "f64").load_cast(jnp.asarray(raw))
        np.testing.assert_array_equal(got.hi.numpy(), np.asarray(want.hi))
        np.testing.assert_array_equal(got.lo.numpy(), np.asarray(want.lo))
        v = DF(torch.tensor(1.0), torch.tensor(2.0**-30))
        assert float(tspec.store_cast(v)) == 1.0 + 2.0**-30


@pytest.mark.parametrize("carrier", ["2d", "flat"])
def test_strided_window_load_set_store_match_jax(carrier):
    rng = np.random.default_rng(5)
    parent = rng.uniform(-1, 1, (8, 10)).astype(np.float32)
    data = parent if carrier == "2d" else parent.reshape(-1)
    t = torch.from_numpy(data.copy())
    j = data.copy()
    rt = trange.make_range("f32", "f32", t, size=(4, 6), stride=10)
    rj = jrange.make_range("f32", "f32", j, size=(4, 6), stride=10)
    assert rt.shape == rj.shape == (4, 6) and rt.length(1) == rj.length(1) == 6
    np.testing.assert_array_equal(rt.load().numpy(), np.asarray(rj.load()))
    assert float(rt[2, 3]) == float(rj[2, 3])
    rt.set((1, 5), 7.0)
    rj.set((1, 5), 7.0)
    rt.store(-1.0)
    rj.store(-1.0)
    np.testing.assert_array_equal(t.numpy(), j)  # the out-of-window part untouched


def test_strided_cast_on_load_bf16_window():
    rng = np.random.default_rng(9)
    parent = _stored(rng, (6, 8), "bf16")
    rt = trange.make_range("f32", "bf16", from_numpy(parent), size=(3, 4), stride=8, const=True)
    rj = jrange.make_range("f32", "bf16", jnp.asarray(parent), size=(3, 4), stride=8, const=True)
    got = rt.load()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(rj.load()))
    with pytest.raises(TypeError):
        rt.store(0.0)
    with pytest.raises(TypeError):
        rt.as_const().set((0, 0), 1.0)


@pytest.mark.parametrize(
    "st,shape,size,stride",
    [
        ("f32", (4, 8), (4, 6), 5),  # stride < n
        ("f32", (4, 8), (4, 6), 10),  # carrier row length != stride
        ("f32", (30,), (4, 6), 10),  # flat carrier too small
        ("f32", (80,), None, 10),  # stride without an explicit (m, n)
        ("f32", (8, 8), (4, 4), None),  # dense size != carrier shape
        ("df64", (8,), None, None),  # df64 is no storage type
    ],
)
def test_range_validation_matches_jax(st, shape, size, stride):
    with pytest.raises(ValueError):
        jrange.make_range("f32", st, np.zeros(shape, np.float32), size=size, stride=stride)
    with pytest.raises(ValueError):
        trange.make_range("f32", st, torch.zeros(shape), size=size, stride=stride)


def test_range_repr_and_queries():
    r = trange.make_range("df64", "bf16", torch.zeros(3, 5, dtype=torch.bfloat16))
    assert (r.ar, r.st, r.shape) == ("df64", "bf16", (3, 5))
    assert "ar=df64" in repr(r) and "st=bf16" in repr(r)
    v = r[1, 2]
    assert isinstance(v, DF) and float(v.hi) == 0.0
