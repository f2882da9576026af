"""The port's stochastic-rounding converters (accblas_tpu_torch.utils.sr),
mirroring tests/test_sr.py: the numpy ``sr_round`` and ``convert_mtx`` equal
the JAX package's bit for bit on the same inputs and seeds; the torch
``sr_round_device`` and ``sr_round_device_chunked`` equal the JAX package's
bit for bit under the same key, replay on the host with the same uniforms
and keep the SR statistics."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from accblas_tpu.utils import devgen as jdevgen
from accblas_tpu.utils import matrix as jmatrix
from accblas_tpu.utils import sr as jsr
from accblas_tpu_torch.accessor.dtypes import torch_dtype
from accblas_tpu_torch.utils import devgen, matrix, sr, threefry

torch.set_num_threads(1)

ST = ["f8e4m3", "f8e5m2", "bf16", "f16"]


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({1: np.uint8, 2: np.uint16}[a.itemsize])


KEY = threefry.key(3)


@pytest.mark.parametrize("st", ST)
def test_sr_outputs_are_neighbors_and_match_jax(st, rng):
    x = rng.uniform(-1, 1, 20000)
    got = sr.sr_round(x, st, seed=7)
    np.testing.assert_array_equal(_bits(got), _bits(jsr.sr_round(x, st, seed=7)))
    out = got.astype(np.float64)
    rn = x.astype(sr.np_dtype(st)).astype(np.float64)
    gap_bound = np.abs(out - rn)
    assert np.all((out <= np.maximum(x, rn) + gap_bound) & (out >= np.minimum(x, rn) - gap_bound))
    assert np.array_equal(out.astype(sr.np_dtype(st)).astype(np.float64), out)


def test_sr_exact_probability():
    """30% of the way between two e4m3 neighbours rounds up ~30% of the time."""
    c, up = 0.5, 0.5 + 0.0625
    x = np.full(40000, c + 0.3 * (up - c))
    out = sr.sr_round(x, "f8e4m3", seed=3).astype(np.float64)
    assert np.all((out == up) | (out == c))
    assert abs(np.mean(out == up) - 0.3) < 0.012  # 5 sigma of binomial(40000, 0.3)


def test_sr_unbiased_vs_rn_biased():
    c, up = 1.0, 1.125  # e4m3 gap at 1.0 is 2^-3
    x = np.full(40000, c + 0.2 * (up - c))
    rn = x.astype(ml_dtypes.float8_e4m3fn).astype(np.float64)
    assert np.all(rn == c)  # RN truncates every one of them
    out = sr.sr_round(x, "f8e4m3", seed=5).astype(np.float64)
    assert abs(out.mean() - x[0]) < 0.05 * (up - c)


def test_sr_exact_values_fixed():
    vals = np.array([0.5, -0.25, 1.0, 0.0, 448.0], np.float64)  # e4m3-exact
    out = sr.sr_round(vals, "f8e4m3", seed=1).astype(np.float64)
    assert np.array_equal(out, vals)


@pytest.mark.parametrize("st", ST)
def test_sr_device_replays_on_the_host(st, rng):
    """The torch SR under a threefry key against the numpy sr_round given
    the same uniforms: equal but for elements within ~1 f32 ulp of the
    threshold (f32 against f64 probabilities)."""
    x = rng.uniform(-1, 1, 20000).astype(np.float32)
    got = sr.sr_round_device(torch.from_numpy(x), st, KEY)
    assert got.dtype == torch_dtype(st)
    u = threefry.uniform_np(KEY, 0, x.size).astype(np.float64)
    want = sr.sr_round(x, st, u=u).astype(np.float64)
    assert np.mean(got.double().numpy() != want) < 1e-3


def test_sr_device_statistics():
    x = torch.full((40000,), 0.5 + 0.3 * 0.0625)
    out = sr.sr_round_device(x, "f8e4m3", threefry.key(11)).double()
    assert bool(((out == 0.5) | (out == 0.5625)).all())
    assert abs(float((out == 0.5625).double().mean()) - 0.3) < 0.012


def test_convert_mtx_stochastic_route(rng):
    x = rng.uniform(-1, 1, 1000)
    out = matrix.convert_mtx(x, "f8e4m3", rounding="stochastic", seed=2)
    assert out.dtype == np.dtype(ml_dtypes.float8_e4m3fn)
    np.testing.assert_array_equal(
        _bits(out), _bits(jmatrix.convert_mtx(x, "f8e4m3", rounding="stochastic", seed=2)))
    rn = matrix.convert_mtx(x, "f8e4m3")
    np.testing.assert_array_equal(_bits(rn), _bits(jmatrix.convert_mtx(x, "f8e4m3")))
    np.testing.assert_array_equal(matrix.convert_mtx(x, np.float32), x.astype(np.float32))


def test_convert_mtx_stochastic_wide_target_rejected(rng):
    with pytest.raises(ValueError):
        matrix.convert_mtx(rng.uniform(-1, 1, 16), "f32", rounding="stochastic")


def test_sr_round_device_chunked_2d(rng):
    x = torch.from_numpy(rng.uniform(-1, 1, (64, 32)).astype(np.float32))
    k = threefry.key(0)
    out = sr.sr_round_device_chunked(x, "f8e4m3", k, chunk=512)
    assert out.shape == x.shape and out.dtype == torch.float8_e4m3fn
    # chunked 2-D == the flat chunked reference, reshaped
    flat = sr.sr_round_device_chunked(x.reshape(-1), "f8e4m3", k, chunk=512)
    assert torch.equal(out.view(torch.uint8), flat.view(torch.uint8).reshape(64, 32))
    # under the chunk size the call is one sr_round_device
    one = sr.sr_round_device(x, "f8e4m3", k)
    small = sr.sr_round_device_chunked(x, "f8e4m3", k)
    assert torch.equal(one.view(torch.uint8), small.view(torch.uint8))


@pytest.mark.parametrize("st", ["f8e4m3", "f8e5m2"])
@pytest.mark.parametrize("shape,chunk", [((5000,), 1024), ((96, 50), 1000), ((3000,), 2**26)])
def test_sr_round_device_chunked_equals_jax(st, shape, chunk):
    """The port's chunked SR against the JAX package's, bit for bit, on
    the driver's data under the driver's key: with several chunks (each
    under fold_in(key, chunk index)) and with one (the key itself)."""
    x = np.array(jdevgen.gen_f32(shape, 42, "dot_x", 1))
    jk = jax.random.split(jdevgen._key(42, "sr", 1))[0]
    want = np.asarray(jsr.sr_round_device_chunked(jnp.asarray(x), st, jk, chunk=chunk))
    k = threefry.split(devgen.key(42, "sr", 1))[0]
    got = sr.sr_round_device_chunked(torch.from_numpy(x), st, k, chunk=chunk)
    assert got.shape == shape
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(), _bits(want))


@pytest.mark.parametrize("st", ["bf16", "f16"])
def test_sr_round_device_equals_jax_wide(st, rng):
    """The 16-bit targets under the same key, bit for bit."""
    x = rng.uniform(-1, 1, 3000).astype(np.float32)
    want = np.asarray(jsr.sr_round_device(jnp.asarray(x), st, jax.random.key(5)))
    got = sr.sr_round_device(torch.from_numpy(x), st, threefry.key(5))
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), _bits(want))
