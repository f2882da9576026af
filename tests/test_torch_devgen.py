"""The port's on-device data generation (accblas_tpu_torch.utils.devgen)
against the JAX package's (accblas_tpu.utils.devgen), mirroring
tests/test_devgen.py: for the same (shape, seed, role, r) the port's
gen_f32, split_df64 (hi and lo), replay_f32 and master_f64 are the JAX
package's bits; the f32 copy is the rounded fp64 master, and the df64 split
carries the master."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accblas_tpu.utils import devgen as jdevgen
from accblas_tpu_torch.utils import devgen, threefry

torch.set_num_threads(1)


def _gen(shape, seed=42, role="dot_x", r=0):
    return devgen.gen_f32(shape, seed, role, r, device="cpu").numpy()


def _u32(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


def test_f32_copy_is_rounded_master():
    g = _gen((4096,), r=0)
    m = devgen.master_f64((4096,), seed=42, role="dot_x", r=0)
    assert np.array_equal(g, m.astype(np.float32))


@pytest.mark.parametrize("shape,chunk", [((5000,), 1024), ((37, 53), 100), ((3, 4, 5), 7)])
def test_draw_equals_numpy_replay_bit_for_bit(shape, chunk, monkeypatch):
    """The torch int64 draw (chunked, any shape) against the numpy uint32
    replay, whole and in ranges that straddle chunk boundaries."""
    monkeypatch.setattr(threefry, "CHUNK", chunk)
    g = _gen(shape, seed=7, role="gemv_a", r=3).reshape(-1)
    want = devgen.replay_f32(shape, 7, "gemv_a", 3)
    np.testing.assert_array_equal(g.view(np.uint32), want.view(np.uint32))
    n = g.size
    for lo, hi in ((0, min(n, 3)), (chunk - 2, min(n, chunk + 3)), (n - 5, n)):
        np.testing.assert_array_equal(
            devgen.replay_f32(shape, 7, "gemv_a", 3, lo, hi).view(np.uint32),
            g[lo:hi].view(np.uint32))


@pytest.mark.parametrize("seed", [0, 7, 42, 2**31 - 1])
@pytest.mark.parametrize("role", ["dot_x", "sr", "trsv_b", "p4a_a"])
@pytest.mark.parametrize("r", [0, 1, 9])
def test_key_equals_jax(seed, role, r):
    """The key of (seed, role, r), a role id or a CRC32 role, is the JAX
    package's ``_key``."""
    want = tuple(int(v) for v in np.asarray(jax.random.key_data(jdevgen._key(seed, role, r))))
    assert devgen.key(seed, role, r) == want


@pytest.mark.parametrize("shape", [(5000,), (64, 128), (3, 7, 11)])
@pytest.mark.parametrize("role,r", [("dot_y", 1), ("gemv_a", 0), ("a probe role", 2)])
def test_gen_and_split_equal_jax(shape, role, r):
    """gen_f32, split_df64 (hi and lo) and replay_f32 against the JAX
    package's, bit for bit."""
    want = _u32(jdevgen.gen_f32(shape, 42, role, r))
    np.testing.assert_array_equal(_u32(_gen(shape, 42, role, r)), want)
    np.testing.assert_array_equal(_u32(devgen.replay_f32(shape, 42, role, r)),
                                  want.reshape(-1))
    jh, jl = jdevgen.split_df64(jnp.zeros(shape, jnp.float32), None, 42, role, r)
    hi, lo = devgen.split_df64(None, shape, 42, role, r, device="cpu")
    np.testing.assert_array_equal(_u32(hi.numpy()), _u32(jh))
    np.testing.assert_array_equal(_u32(lo.numpy()), _u32(jl))


@pytest.mark.parametrize("native", [True, False])
def test_master_equals_jax(native, monkeypatch):
    """master_f64 through the native replay and through numpy (in chunks)
    against the JAX package's master, bit for bit."""
    if native:
        from accblas_tpu_torch.native import host

        if not host.available():
            pytest.skip(f"native library unavailable: {host.describe()}")
    else:
        monkeypatch.setenv("ACCBLAS_NO_NATIVE", "1")
        monkeypatch.setattr(threefry, "CHUNK", 1000)
    want = jdevgen.master_f64((33, 101), 9, "gemv_a", 2)
    np.testing.assert_array_equal(devgen.master_f64((33, 101), 9, "gemv_a", 2), want)


def test_master_distribution_and_entropy():
    m = devgen.master_f64((20000,), seed=42, role="dot_y", r=1)
    assert np.all(np.abs(m) < 1.0 + 2.0**-24)
    assert abs(m.mean()) < 0.02 and abs(m.std() - 1 / np.sqrt(3)) < 0.01
    # the master must NOT be f32-representable (that would zero the storage-
    # rounding error the accessor tiers measure)
    frac_exact = np.mean(m.astype(np.float32).astype(np.float64) == m)
    assert frac_exact < 0.01
    # storage-rounding error with the ±0.5 ulp statistics of a full-entropy
    # master: mean |err| over the ulp ≈ 0.25
    f32 = m.astype(np.float32).astype(np.float64)
    err = np.abs(m - f32)
    ulp = np.abs(np.nextafter(f32.astype(np.float32), np.float32(np.inf)).astype(np.float64) - f32)
    assert 0.2 < np.mean(err / ulp) < 0.3


def test_split_recovers_master_exactly_enough():
    hi, lo = devgen.split_df64(None, master_shape=(8192,), seed=42, role="gemv_x", r=0,
                               device="cpu")
    m = devgen.master_f64((8192,), seed=42, role="gemv_x", r=0)
    rec = hi.double().numpy() + lo.double().numpy()
    # (hi, lo) carries the master to df64 precision (~2^-48 relative)
    assert np.max(np.abs(rec - m) / np.maximum(np.abs(m), 1e-6)) < 2.0**-45
    assert np.array_equal(hi.numpy(), m.astype(np.float32))
    # given an f32 copy, the split takes its shape and device
    x32 = devgen.gen_f32((8192,), 42, "gemv_x", 0, device="cpu")
    h2, l2 = devgen.split_df64(x32, seed=42, role="gemv_x", r=0)
    assert torch.equal(h2, x32) and torch.equal(l2, lo)


def test_roles_and_randomizations_are_disjoint_streams():
    a = devgen.master_f64((1000,), seed=42, role="dot_x", r=0)
    b = devgen.master_f64((1000,), seed=42, role="dot_y", r=0)
    c = devgen.master_f64((1000,), seed=42, role="dot_x", r=1)
    d = devgen.master_f64((1000,), seed=43, role="dot_x", r=0)
    assert not np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert not np.array_equal(a, d)


def test_gen_2d_shape():
    g = _gen((64, 128), role="gemv_a")
    m = devgen.master_f64((64, 128), seed=42, role="gemv_a", r=0)
    assert g.shape == (64, 128)
    assert np.array_equal(g, m.astype(np.float32))


def test_adhoc_roles_stable_and_disjoint():
    a1 = _gen((512,), role="p4a_a")
    a2 = _gen((512,), role="p4a_a")
    b = _gen((512,), role="p4a_x")
    assert np.array_equal(a1, a2)
    assert not np.array_equal(a1, b)
    for role in devgen.ROLES:
        assert not np.array_equal(a1, _gen((512,), role=role))
    m = devgen.master_f64((512,), seed=42, role="p4a_a")
    assert np.array_equal(a1, m.astype(np.float32))


def test_gen_f32_runs_on_the_card_unless_asked():
    """The device defaults to the card: without one the call fails rather
    than drawing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        devgen.gen_f32((16,))
    with pytest.raises((RuntimeError, AssertionError)):
        devgen.split_df64(None, (16,))
