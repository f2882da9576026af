"""The port's on-device data generation (accblas_tpu_torch.utils.devgen),
mirroring tests/test_devgen.py: the draw in torch int64 equals its numpy
replay bit for bit, the f32 copy is the rounded fp64 master, and the df64
split carries the master. The draw is the port's own (splitmix64, not
threefry), so the values differ from the JAX package's; the master's
construction and its statistics are the same."""

import numpy as np
import pytest
import torch

from accblas_tpu_torch.utils import devgen, prng

torch.set_num_threads(1)


def _gen(shape, seed=42, role="dot_x", r=0):
    return devgen.gen_f32(shape, seed, role, r, device="cpu").numpy()


def test_f32_copy_is_rounded_master():
    g = _gen((4096,), r=0)
    m = devgen.master_f64((4096,), seed=42, role="dot_x", r=0)
    assert np.array_equal(g, m.astype(np.float32))


@pytest.mark.parametrize("shape,chunk", [((5000,), 1024), ((37, 53), 100), ((3, 4, 5), 7)])
def test_draw_equals_numpy_replay_bit_for_bit(shape, chunk, monkeypatch):
    """The torch int64 draw (chunked, any shape) against the numpy uint64
    replay, whole and in ranges that straddle chunk boundaries."""
    monkeypatch.setattr(devgen, "CHUNK", chunk)
    g = _gen(shape, seed=7, role="gemv_a", r=3).reshape(-1)
    want = devgen.replay_f32(shape, 7, "gemv_a", 3)
    np.testing.assert_array_equal(g.view(np.uint32), want.view(np.uint32))
    n = g.size
    for lo, hi in ((0, min(n, 3)), (chunk - 2, min(n, chunk + 3)), (n - 5, n)):
        np.testing.assert_array_equal(
            devgen.replay_f32(shape, 7, "gemv_a", 3, lo, hi).view(np.uint32),
            g[lo:hi].view(np.uint32))


def test_draw_keys_wrap_like_uint64():
    """Seeds at the top of the uint64 range, and the round offsets, wrap mod
    2^64 in int64 exactly as in the numpy replay; the stream is splitmix64
    folds of prng's own mixer."""
    for seed in (0, 2**63 - 1, 2**63, 2**64 - 1):
        g = devgen.gen_f32((300,), seed, "trsv_b", 5, device="cpu").numpy()
        np.testing.assert_array_equal(g, devgen.replay_f32((300,), seed, "trsv_b", 5))
    z = prng._splitmix64(np.array([5], np.uint64))
    z = prng._splitmix64(z ^ np.uint64(devgen.ROLES["trsv_b"]))
    assert devgen.stream(5, "trsv_b", 0) == int(prng._splitmix64(z ^ np.uint64(0))[0])


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


def test_generator_streams():
    g1 = devgen.generator(42, "sr", 0, 0, "cpu")
    g2 = devgen.generator(42, "sr", 0, 0, "cpu")
    g3 = devgen.generator(42, "sr", 0, 1, "cpu")
    u1, u2, u3 = (torch.rand(64, generator=g) for g in (g1, g2, g3))
    assert torch.equal(u1, u2) and not torch.equal(u1, u3)
