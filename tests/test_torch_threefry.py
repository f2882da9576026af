"""The port's threefry draw (accblas_tpu_torch.utils.threefry) and its kernel
wrapper's CPU path (accblas_tpu_torch.ops.draw) against JAX's own
jax.random on the CPU, bit for bit: keys, fold_in, split, the raw
threefry2x32 block with counters past 2^32, uniform over 1-D and 2-D
shapes in both the torch and the numpy form, and ``normal``, which runs
XLA:CPU's float32 erf_inv and log1p in float32 steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from accblas_tpu_torch.ops import draw
from accblas_tpu_torch.utils import threefry

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2**31 - 1, 2**32 - 1, 2**32 + 5, -1, 2**40 + 3]


def _data(k) -> tuple:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)).tolist())


def _u32(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_and_split_equal_jax(seed):
    k = jax.random.key(seed)
    assert threefry.key(seed) == _data(k)
    assert threefry.key(seed) == tuple(np.asarray(jax.random.PRNGKey(seed)).tolist())
    for d in (0, 1, 6, 2**31 - 1, 2**32 - 1):
        assert threefry.fold_in(threefry.key(seed), d) == _data(jax.random.fold_in(k, d))
    for num in (2, 3, 5):
        got = threefry.split(threefry.key(seed), num)
        assert got == [_data(s) for s in jax.random.split(k, num)]


def test_block_carries_counters_past_2_32():
    """threefry2x32 with explicit hi counter words, against JAX's primitive:
    the numpy form, the torch int64 form, and random_bits over a flat
    range that crosses 2^32."""
    k = threefry.key(7)
    hi = np.array([0, 0, 1, 1, 2, 0xFFFFFFFF], np.uint32)
    lo = np.array([0, 0xFFFFFFFF, 0, 5, 0x80000000, 0xFFFFFFFF], np.uint32)
    w0, w1 = (np.asarray(w) for w in jprng.threefry2x32_p.bind(
        jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.asarray(hi), jnp.asarray(lo)))
    n0, n1 = threefry.block((np.uint32(k[0]), np.uint32(k[1])), hi, lo, wrap=lambda v: v)
    np.testing.assert_array_equal(n0, w0)
    np.testing.assert_array_equal(n1, w1)
    t0, t1 = threefry.block(k, torch.from_numpy(hi.astype(np.int64)),
                            torch.from_numpy(lo.astype(np.int64)))
    np.testing.assert_array_equal(t0.numpy(), w0.astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), w1.astype(np.int64))
    start = 2**32 - 3
    idx = np.arange(start, start + 7, dtype=np.uint64)
    b0, b1 = (np.asarray(w) for w in jprng.threefry2x32_p.bind(
        jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.asarray((idx >> 32).astype(np.uint32)),
        jnp.asarray(idx.astype(np.uint32))))
    want = b0 ^ b1
    np.testing.assert_array_equal(threefry.random_bits_np(k, start, start + 7), want)
    np.testing.assert_array_equal(threefry.random_bits(k, start, start + 7).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("shape", [(1,), (1000,), (4097,), (37, 53), (3, 4, 5)])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.0, 1.0), (threefry.NORMAL_LO, 1.0)])
def test_uniform_bits_equal_jax(shape, lo, hi):
    k = jax.random.fold_in(jax.random.key(11), 4)
    want = _u32(jax.random.uniform(k, shape, jnp.float32, lo, hi))
    got = threefry.uniform(_data(k), shape, lo, hi, device="cpu")
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    n = int(np.prod(shape))
    np.testing.assert_array_equal(_u32(threefry.uniform_np(_data(k), 0, n, lo, hi)),
                                  want.reshape(-1))
    # any flat range alone, and every step-th element
    a, b = n // 3, n - n // 4
    np.testing.assert_array_equal(_u32(threefry.uniform_np(_data(k), a, b, lo, hi)),
                                  want.reshape(-1)[a:b])
    np.testing.assert_array_equal(_u32(threefry.uniform_np(_data(k), 0, n, lo, hi, step=3)),
                                  want.reshape(-1)[::3])


def test_two_d_draw_depends_on_its_shape():
    """Element (i, j) of an (m, n) draw has counter i·n + j: the leading
    block of a wider draw is other data, a leading 1-D slice is not."""
    k = threefry.key(3)
    wide = threefry.uniform(k, (8, 16), device="cpu")
    assert not torch.equal(wide[:4, :4], threefry.uniform(k, (4, 4), device="cpu"))
    assert torch.equal(threefry.uniform(k, (128,), device="cpu")[:50],
                       threefry.uniform(k, (50,), device="cpu"))


def test_uniform_chunks_and_draw_modes(monkeypatch):
    """The CPU path in passes across chunk boundaries, each mode against
    its numpy replay bit for bit, from an offset past 2^32."""
    monkeypatch.setattr(threefry, "CHUNK", 1000)
    ka, kb = threefry.split(threefry.key(9))
    start = 2**32 - 1500
    for mode in draw.MODES:
        got = draw.draw(mode, ka, kb, (3, 1001), 0.25, 2.0, device="cpu", start=start)
        want = draw.replay_np(mode, ka, kb, start, start + 3003, 0.25, 2.0)
        for g, w in zip(got if mode == "df64" else (got,), want if mode == "df64" else (want,)):
            np.testing.assert_array_equal(g.numpy().reshape(-1).view(np.uint32), _u32(w))
    with pytest.raises(ValueError):
        draw.draw("f64", ka, kb, (4,), device="cpu")


def test_draw_on_cuda_needs_the_card():
    """A draw for the card never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    k = threefry.key(1)
    with pytest.raises((RuntimeError, AssertionError)):
        threefry.uniform(k, (16,))
    with pytest.raises((RuntimeError, AssertionError)):
        threefry.normal(k, (16,))


@pytest.mark.parametrize("seed,n", [(0, 65536), (3, 65536), (42, 4096)])
def test_normal_within_3_ulp_of_jax(seed, n):
    """Bit for bit since log1p and the tail branch's sqrt follow XLA:CPU's
    (the name dates from the 3-ulp bound that torch's log1p left)."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n,), jnp.float32))
    k = threefry.key(seed)
    for got in (threefry.normal(k, (n,), device="cpu").numpy(), threefry.normal_np(k, 0, n)):
        np.testing.assert_array_equal(_u32(got), _u32(want), err_msg=str(seed))


def test_log1p_f32_is_xlas():
    """log1p_f32 against jax.lax.log1p on the CPU, bit for bit: 10^6 seeded
    inputs in (-1, 0] (the arguments -x² of erf_inv), plus the 2000 float32
    values on each side of the branch edge x = -(sqrt(2) - 1) and those next
    to -1 and 0."""
    rng = np.random.default_rng(11)
    edge = np.float32(np.sqrt(2.0) - 1.0)
    steps = np.arange(-2000, 2001)
    x = [-rng.random(1_000_000, dtype=np.float32)]
    for e in (-edge, np.float32(-1.0), np.float32(-0.0)):
        x.append((e.view(np.int32).astype(np.int64) + steps).astype(np.int32).view(np.float32))
    x = np.concatenate(x)
    x = x[np.isfinite(x) & (x > -1.0) & (x <= 0.0)]
    want = np.asarray(jax.lax.log1p(jnp.asarray(x)))
    got = threefry.log1p_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_u32(got), _u32(want))
    assert (np.abs(x) < edge).any() and (np.abs(x) >= edge).any()


def test_erfinv_f32_is_xlas_approximation():
    """erfinv_f32 follows lax.erf_inv (Giles' polynomial) bit for bit, not
    the exact inverse that torch.erfinv approximates more closely."""
    x = np.linspace(-0.999, 0.999, 20001, dtype=np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = threefry.erfinv_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_u32(got), _u32(want))
    exact = torch.erfinv(torch.from_numpy(x)).numpy()
    assert np.abs(exact.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64)).max() > 3
