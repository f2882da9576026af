"""The port's CUDA kernels against their plain torch versions, on a card.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is False: a CUDA kernel has no CPU mode. The file imports no JAX, so it also
runs on a GPU machine without it (``--noconftest`` skips the JAX set-up of
tests/conftest.py):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import accblas_tpu_torch
from accblas_tpu_torch.ops import df64 as tdf
from accblas_tpu_torch.ops import dot as tdot
from accblas_tpu_torch.ops import gemv as tgemv
from accblas_tpu_torch.utils import MatrixInfo, devgen, gen_mtx, interop, tolerance

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16,
           "f8e4m3": torch.float8_e4m3fn, "f8e5m2": torch.float8_e5m2}
TIERS = ("f32", "bf16", "f16", "df64_fast", "df64_precise")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ar(tier):
    return ("df64", tier == "df64_precise") if tier.startswith("df64") else (tier, False)


def _value(out) -> torch.Tensor:
    return tdf.df_to_f64(out) if isinstance(out, tdf.DF) else out.double()


def _dot_check(tier, got, plain, ref):
    den = float(ref.abs())
    err, perr = float((got - ref).abs()) / den, float((plain - ref).abs()) / den
    if tier in tolerance.TOL:
        tol = tolerance.TOL[tier]
        assert err <= tol and perr <= tol, (err, perr, tol)
        assert float((got - plain).abs()) / den <= 2 * tol
    else:
        assert err <= tolerance.narrow_bound(perr), (err, perr)


def _run_dot(x, y, tier, init=0.5):
    ar, precise = _ar(tier)
    before = tdot.launches
    got = _value(tdot.acc_dot(x, y, ar, precise=precise, init=init))
    assert tdot.launches == before + 1
    hi, lo = tdot._dot_plain(x, y, tier, init)
    ref = torch.dot(x.double(), y.double()) + init
    _dot_check(tier, got, hi.double() + lo.double(), ref)
    return got


@pytest.mark.parametrize("st", list(STORAGE))
@pytest.mark.parametrize("tier", TIERS)
def test_dot_kernel_every_tier_and_storage(cuda, tier, st):
    x = devgen.gen_f32((100_003,), 1, "dot_x", cuda).to(STORAGE[st])
    y = devgen.gen_f32((100_003,), 1, "dot_y", cuda).to(STORAGE[st])
    _run_dot(x, y, tier)


@pytest.mark.parametrize("n", [0, 1, 7, 33, 4096 + 5])
@pytest.mark.parametrize("tier", ["f32", "bf16", "df64_precise"])
def test_dot_kernel_small_and_unaligned(cuda, tier, n):
    base = devgen.gen_f32((n + 1,), 2, "dot_x", cuda).to(torch.bfloat16)
    y = devgen.gen_f32((n,), 2, "dot_y", cuda).to(torch.bfloat16)
    x = base[1:]  # 2 bytes past a 16-byte boundary: the element-wise path
    if n:
        _run_dot(x, y, tier)
    else:
        assert float(_value(tdot.acc_dot(x, y, "f32", init=0.5))) == 0.5


def test_dot_kernel_repeats_its_bits(cuda):
    x = devgen.gen_f32((3_000_001,), 3, "dot_x", cuda)
    y = devgen.gen_f32((3_000_001,), 3, "dot_y", cuda)
    first = tdot.acc_dot(x, y, "df64")
    for _ in range(3):
        again = tdot.acc_dot(x, y, "df64")
        assert torch.equal(first.hi, again.hi) and torch.equal(first.lo, again.lo)


def _gemv_check(tier, got, plain, ref, scale, out_dtype):
    err = tolerance.gemv_row_err(got, ref, scale, out_dtype)
    perr = tolerance.gemv_row_err(plain, ref, scale, out_dtype)
    if tier in tolerance.TOL:
        tol = tolerance.TOL[tier]
        assert err <= tol and perr <= tol, (err, perr, tol)
        assert tolerance.gemv_row_err(got, plain, scale, out_dtype) <= 2 * tol
    else:
        assert err <= tolerance.narrow_bound(perr), (err, perr)


def _run_gemv(a, x, r, tier, alpha, beta, df_out=False):
    ar, precise = _ar(tier)
    before = tgemv.launches
    got = tgemv.acc_gemv(a, x, r, alpha, beta, ar, precise=precise, df_out=df_out)
    assert tgemv.launches == before + 1
    plain = tgemv._gemv_plain(a, x, r, alpha, beta, tier, df_out)
    a64, x64 = a.double(), x.double()
    ref = alpha * (a64 @ x64) + (0.0 if beta == 0 else beta * r.double())
    scale = abs(alpha) * (a64.abs() @ x64.abs())
    if beta != 0:
        scale = scale + abs(beta) * r.double().abs()
    out_dtype = None if df_out else r.dtype
    g = _value(got)
    assert torch.isfinite(g).all()
    _gemv_check(tier, g, _value(plain), ref, scale, out_dtype)
    return got


@pytest.mark.parametrize("st", list(STORAGE))
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("m,n", [(300, 1234), (64, 4096)])
def test_gemv_kernel_every_tier_and_storage(cuda, tier, st, m, n):
    a = devgen.gen_f32((m, n), 4, "gemv_a", cuda).to(STORAGE[st])
    x = devgen.gen_f32((n,), 4, "gemv_x", cuda).to(STORAGE[st])
    r = devgen.gen_f32((m,), 4, "gemv_res", cuda)
    _run_gemv(a, x, r, tier, 1.5, 0.5)


@pytest.mark.parametrize("tier", TIERS)
def test_gemv_kernel_beta0_nan_res_and_bf16_out(cuda, tier):
    a = devgen.gen_f32((96, 2048), 5, "gemv_a", cuda).to(torch.bfloat16)
    x = devgen.gen_f32((2048,), 5, "gemv_x", cuda).to(torch.bfloat16)
    nan = torch.full((96,), float("nan"), device=cuda)
    _run_gemv(a, x, nan, tier, 1.0, 0.0)
    rb = devgen.gen_f32((96,), 5, "gemv_res", cuda).to(torch.bfloat16)
    assert _run_gemv(a, x, rb, tier, 1.0, 1.0).dtype == torch.bfloat16


@pytest.mark.parametrize("tier", ["df64_fast", "df64_precise"])
@pytest.mark.parametrize("m,n", [(40, 777), (4, 140_000)])
def test_gemv_kernel_df_out(cuda, tier, m, n):
    a = devgen.gen_f32((m, n), 6, "gemv_a", cuda)
    x = devgen.gen_f32((n,), 6, "gemv_x", cuda)
    r = devgen.gen_f32((m,), 6, "gemv_res", cuda)
    out = _run_gemv(a, x, r, tier, 2.0, 0.5, df_out=True)
    assert isinstance(out, tdf.DF) and out.hi.dtype == torch.float32


def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tdot.acc_dot(x[::2], x[::2], "f32")
    with pytest.raises(ValueError, match="different devices"):
        tdot.acc_dot(x, x.cpu(), "f32")
    a = torch.zeros(8, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tgemv.acc_gemv(a.t(), x[:8], x[:8], ar="f32")
    with pytest.raises(ValueError, match="kernel storage type"):
        tgemv.acc_gemv(a.double(), x[:8].double(), x[:8], ar="df64")


def test_flagship_slice_on_cuda(cuda):
    """The entry() operands (seeded host data) through the public API."""
    m, n = 1024, 2048
    a = interop.from_numpy(gen_mtx(MatrixInfo(m, n), seed=42).astype(np.float32), "bf16", cuda)
    x = interop.from_numpy(gen_mtx(MatrixInfo(1, n), seed=43)[0].astype(np.float32), "bf16", cuda)
    r = interop.from_numpy(gen_mtx(MatrixInfo(1, m), seed=44)[0].astype(np.float32), device=cuda)
    before = (tdot.launches, tgemv.launches)
    out = accblas_tpu_torch.acc_gemv(a, x, r, 1.0, 1.0, ar="f32")
    d = accblas_tpu_torch.acc_dot(x, x, ar="f32")
    assert (tdot.launches, tgemv.launches) == (before[0] + 1, before[1] + 1)
    a64, x64 = a.double(), x.double()
    err = tolerance.gemv_row_err(out, a64 @ x64 + r.double(), a64.abs() @ x64.abs()
                                 + r.double().abs(), torch.float32)
    assert err <= tolerance.TOL["f32"]
    ref = float(x64 @ x64)
    assert abs(float(d) - ref) / ref <= tolerance.TOL["f32"]
