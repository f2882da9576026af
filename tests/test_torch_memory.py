"""The port's data managers (accblas_tpu_torch.utils.memory) against the JAX
package's on the same seeds, mirroring tests/test_memory.py: the same fp64
masters and references, device copies with the bits of the JAX package's
host casts, caches keyed by the canonical dtype."""

import ml_dtypes
import numpy as np
import pytest
import torch

from accblas_tpu.utils import memory as jmemory
from accblas_tpu_torch.ops import dot as dotops
from accblas_tpu_torch.utils.memory import DotData, GemvData, TrsvData, to_device, to_host

torch.set_num_threads(1)
CPU = "cpu"


def test_dot_data_roundtrip_and_randomize():
    d = DotData(4096, seed=42, device=CPU)
    j = jmemory.DotData(4096, seed=42)
    np.testing.assert_array_equal(d.x, j.x)
    np.testing.assert_array_equal(d.y, j.y)
    assert d.reference() == j.reference()
    x32 = d.x_in(np.float32)
    assert x32.dtype == torch.float32 and x32.device.type == CPU
    np.testing.assert_array_equal(to_host(x32), jmemory.to_host(j.x_in(np.float32)))
    ref0 = d.reference()
    d.randomize(seed=99)
    j.randomize(seed=99)
    assert d.reference() != ref0 and d.reference() == j.reference()
    # caches invalidated
    np.testing.assert_allclose(to_host(d.x_in(np.float32)), d.x, rtol=1e-7)


def test_gemv_data_views_share_master():
    g = GemvData(512, seed=1, device=CPU)
    j = jmemory.GemvData(512, seed=1)
    a, x, r = g.view(256, "bfloat16")
    assert a.shape == (256, 256) and a.dtype == torch.bfloat16 and a.is_contiguous()
    ja, jx, jr = j.view(256, "bfloat16")
    for t, u in ((a, ja), (x, jx), (r, jr)):
        np.testing.assert_array_equal(to_host(t), jmemory.to_host(u))
    ref = g.reference(256)
    np.testing.assert_array_equal(ref, j.reference(256))
    got = to_host(a) @ to_host(x) + to_host(r)
    assert np.linalg.norm(got - ref, 1) / np.linalg.norm(ref, 1) < 0.02  # bf16 floor
    full, _, _ = g.view(512, "f32")
    assert full is g.view(512, "f32")[0]  # the full size is the cached copy itself


def test_trsv_data_factorized_and_reset():
    t = TrsvData(512, seed=3, diag_boost=128.0, device=CPU)
    j = jmemory.TrsvData(512, seed=3, diag_boost=128.0)
    # torch's LAPACK getrf against scipy's: the same pivots, rounding apart
    np.testing.assert_allclose(t.a, j.a, rtol=0, atol=1e-10 * np.abs(j.a).max())
    assert t.a.flags["C_CONTIGUOUS"]  # row-major, as the kernels read it
    a, b = t.view(512, np.float32)
    assert a.shape == (512, 512) and b.shape == (512,)
    ref = t.reference(512, uplo="upper", unit=False)
    assert np.all(np.isfinite(ref))
    jref = j.reference(512, uplo="upper", unit=False)
    assert np.abs(ref - jref).max() / np.abs(jref).max() < 1e-10
    t.b[:10] = 0.0
    t.reset_x()
    np.testing.assert_array_equal(t.b, t.x_init)


def test_fp16_storage_through_accessor():
    d = DotData(65536, seed=7, device=CPU)
    xh = d.x_in(np.float16)
    yh = d.y_in(np.float16)
    assert xh.dtype == torch.float16
    ref_stored = float(xh.double() @ yh.double())
    got = float(dotops.acc_dot(xh, yh, ar="f32"))
    assert abs(got - ref_stored) / abs(ref_stored) < 1e-4


def test_dev_cache_key_canonical():
    d = DotData(64, device=CPU)
    a1 = d.x_in("bf16")
    assert a1 is d.x_in(torch.bfloat16) and a1 is d.x_in("bfloat16")
    assert a1 is d.x_in(np.dtype(ml_dtypes.bfloat16))


def test_reset_x_keeps_matrix_cached():
    t = TrsvData(64, device=CPU)
    a1, b1 = t.view(64, "f32")
    t.reset_x()
    a2, b2 = t.view(64, "f32")
    assert a1 is a2, "reset_x must not drop the unchanged LU matrix"
    assert b1 is not b2


@pytest.mark.parametrize("st", ["bf16", "f16", "f8e4m3", "f8e5m2", "f32"])
def test_to_device_narrow_payload_host_cast(st):
    x = np.random.default_rng(0).uniform(-1, 1, 4096)
    d = to_device(x, st, CPU)
    want = jmemory.to_host(jmemory.to_device(x, st))
    np.testing.assert_array_equal(to_host(d), want)
