"""GEMV of the port against the JAX package's GEMV on identical stored bits.

On the CPU the port runs its plain torch version; the JAX side runs as its
own tests run it here, through the Pallas kernels in interpret mode. Errors
are per row, against |alpha|·(|A|·|x|)_i + |beta|·|res_i|, net of the
result's rounding to the storage of res (accblas_tpu_torch.utils.tolerance).
The CUDA kernel is held against the plain version on a card in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from accblas_tpu.ops import df64 as jdf
from accblas_tpu.ops import gemv as jgemv
from accblas_tpu_torch.ops import df64 as tdf
from accblas_tpu_torch.ops import gemv as tgemv
from accblas_tpu_torch.utils import MatrixInfo, gen_mtx, interop, tolerance

torch.set_num_threads(1)

STORAGE = ("f32", "bf16", "f16", "f8e4m3", "f8e5m2")
TIERS = ("f32", "bf16", "f16", "df64_fast", "df64_precise")
_NP = {"f8e4m3": ml_dtypes.float8_e4m3fn, "f8e5m2": ml_dtypes.float8_e5m2,
       "bf16": ml_dtypes.bfloat16, "f16": np.float16, "f32": np.float32}


def _data(m, n, st, seed, res_st="f32"):
    a = gen_mtx(MatrixInfo(m, n), seed=seed).astype(np.float32).astype(_NP[st])
    x = gen_mtx(MatrixInfo(1, n), seed=seed + 1)[0].astype(np.float32).astype(_NP[st])
    r = gen_mtx(MatrixInfo(1, m), seed=seed + 2)[0].astype(np.float32).astype(_NP[res_st])
    return a, x, r


def _ar(tier):
    return ("df64", tier == "df64_precise") if tier.startswith("df64") else (tier, False)


def _f64(out) -> np.ndarray:
    if isinstance(out, tdf.DF):
        return tdf.df_to_f64(out).numpy()
    if isinstance(out, jdf.DF):
        return np.asarray(jdf.df_to_f64(out))
    if isinstance(out, torch.Tensor):
        return out.double().numpy()
    return np.asarray(jnp.asarray(out, jnp.float32), np.float64)


def _oracle(a, x, r, alpha, beta):
    a64, x64, r64 = a.astype(np.float64), x.astype(np.float64), r.astype(np.float64)
    rterm = 0.0 if beta == 0 else beta * r64
    rscale = 0.0 if beta == 0 else abs(beta) * np.abs(r64)
    return alpha * (a64 @ x64) + rterm, abs(alpha) * (np.abs(a64) @ np.abs(x64)) + rscale


def _both(a, x, r, tier, alpha=1.0, beta=1.0, df_out=False, fixed=False):
    """Port and JAX results of one GEMV tier on the same bits."""
    ta, tx, tr = (interop.from_numpy(v) for v in (a, x, r))
    ja, jx, jr = (jnp.asarray(v) for v in (a, x, r))
    if fixed:
        return tgemv.gemv(ta, tx, tr, alpha, beta), jgemv.gemv(ja, jx, jr, alpha, beta)
    ar, precise = _ar(tier)
    got = tgemv.acc_gemv(ta, tx, tr, alpha, beta, ar, precise=precise, df_out=df_out)
    want = jgemv.acc_gemv(ja, jx, jr, alpha, beta, ar, precise=precise, df_out=df_out)
    return got, want


def _check(tier, got, want, a, x, r, alpha, beta, out_dtype):
    ref, scale = (torch.from_numpy(v) for v in _oracle(a, x, r, alpha, beta))
    g, w = torch.from_numpy(_f64(got)), torch.from_numpy(_f64(want))
    assert torch.isfinite(g).all()
    err = tolerance.gemv_row_err(g, ref, scale, out_dtype)
    jerr = tolerance.gemv_row_err(w, ref, scale, out_dtype)
    if tier in tolerance.TOL:
        tol = tolerance.TOL[tier]
        assert err <= tol, (err, tol)
        assert tolerance.gemv_row_err(g, w, scale, out_dtype) <= 2 * tol
    else:
        assert err <= tolerance.narrow_bound(jerr), (err, jerr)


@pytest.mark.parametrize("st", STORAGE)
@pytest.mark.parametrize("tier", TIERS)
def test_acc_gemv_every_tier_and_storage(tier, st):
    a, x, r = _data(96, 777, st, 42)
    got, want = _both(a, x, r, tier)
    assert got.dtype == torch.float32 and got.shape == (96,)
    _check(tier, got, want, a, x, r, 1.0, 1.0, torch.float32)


@pytest.mark.parametrize("m,n", [(512, 1536), (300, 700), (33, 128), (8, 2100)])
@pytest.mark.parametrize("tier,st", [("f32", "bf16"), ("df64_precise", "f32"),
                                     ("bf16", "bf16"), ("f32", "f32")])
def test_acc_gemv_shapes(tier, st, m, n):
    a, x, r = _data(m, n, st, 7)
    got, want = _both(a, x, r, tier)
    _check(tier, got, want, a, x, r, 1.0, 1.0, torch.float32)


@pytest.mark.parametrize("st", ["f32", "bf16", "f16"])
def test_fixed_gemv_alpha_beta(st):
    a, x, r = _data(256, 384, st, 13, res_st=st)
    got, want = _both(a, x, r, st, alpha=2.5, beta=-0.5, fixed=True)
    assert got.dtype == interop.from_numpy(r).dtype
    _check(st, got, want, a, x, r, 2.5, -0.5, got.dtype)


@pytest.mark.parametrize("tier", ["f32", "bf16", "df64_fast", "df64_precise"])
def test_beta_zero_never_reads_res(tier):
    a, x, r = _data(128, 640, "bf16", 17)
    r = np.full_like(r, np.nan)
    got, want = _both(a, x, r, tier, alpha=1.5, beta=0.0)
    _check(tier, got, want, a, x, r, 1.5, 0.0, torch.float32)


@pytest.mark.parametrize("tier", ["f32", "df64_precise"])
def test_res_storage_sets_the_output(tier):
    a, x, r = _data(64, 512, "bf16", 19, res_st="bf16")
    got, want = _both(a, x, r, tier)
    assert got.dtype == torch.bfloat16
    _check(tier, got, want, a, x, r, 1.0, 1.0, torch.bfloat16)


@pytest.mark.parametrize("tier", ["df64_fast", "df64_precise"])
@pytest.mark.parametrize("st,n", [("f32", 640), ("bf16", 1000)])
def test_df_out_unrounded(tier, st, n):
    a, x, r = _data(32, n, st, 23)
    got, want = _both(a, x, r, tier, alpha=2.0, beta=0.5, df_out=True)
    assert isinstance(got, tdf.DF) and got.hi.dtype == torch.float32
    _check(tier, got, want, a, x, r, 2.0, 0.5, None)


def test_df_out_wide_rows():
    """df_out holds at any width: the kernel has no panel budget, so the
    reference's column-chunked fallback has no separate route here."""
    a, x, r = _data(4, 140_000, "f32", 29)
    ta, tx, tr = (interop.from_numpy(v) for v in (a, x, r))
    got = tgemv.acc_gemv(ta, tx, tr, 2.0, 0.5, "df64", precise=True, df_out=True)
    ref, scale = (torch.from_numpy(v) for v in _oracle(a, x, r, 2.0, 0.5))
    assert tolerance.gemv_row_err(tdf.df_to_f64(got), ref, scale) <= tolerance.TOL["df64_precise"]


@pytest.mark.parametrize("st", ["f32", "bf16"])
def test_xla_gemv_matches_jax(st):
    a, x, r = _data(128, 256, st, 31)
    ta, tx, tr = (interop.from_numpy(v) for v in (a, x, r))
    got = tgemv.xla_gemv(ta, tx, tr, 1.5, 0.5)
    want = jgemv.xla_gemv(jnp.asarray(a), jnp.asarray(x), jnp.asarray(r), 1.5, 0.5)
    assert got.dtype == torch.float32
    ref, scale = (torch.from_numpy(v) for v in _oracle(a, x, r, 1.5, 0.5))
    tol = 1e-5 if st == "f32" else 2.0**-7
    g = torch.from_numpy(_f64(got))
    assert tolerance.gemv_row_err(g, ref, scale) <= tol
    assert tolerance.gemv_row_err(g, torch.from_numpy(_f64(want)), scale) <= 2 * tol
    nan = torch.full_like(tr, float("nan"))
    assert torch.isfinite(tgemv.xla_gemv(ta, tx, nan, 1.0, 0.0)).all()


def test_rejections_match_jax():
    a8 = np.zeros((4, 8), ml_dtypes.float8_e4m3fn)
    x8 = np.zeros(8, ml_dtypes.float8_e4m3fn)
    r = np.zeros(4, np.float32)
    for pkg, conv in ((jgemv, jnp.asarray), (tgemv, interop.from_numpy)):
        with pytest.raises(ValueError, match="storage-only"):
            pkg.gemv(conv(a8), conv(x8), conv(r))
        with pytest.raises(ValueError, match="matching storage dtypes"):
            pkg.gemv(conv(a8.astype(np.float32)), conv(x8.astype(ml_dtypes.bfloat16)), conv(r))
        with pytest.raises(ValueError, match="df_out requires"):
            pkg.acc_gemv(conv(a8), conv(x8), conv(r), ar="f32", df_out=True)
        with pytest.raises(ValueError, match="shape mismatch"):
            pkg.acc_gemv(conv(a8), conv(x8[:7]), conv(r), ar="f32")


def test_block_cols_is_the_pow2_ceil_loop():
    """The bf16/f16 tiers' column block, now from int.bit_length, against
    the loop form it replaced."""
    def loop_pow2_ceil(v):
        p = 1
        while p < v:
            p <<= 1
        return p

    for n in range(1, 70001):
        assert tgemv._block_cols(n) == min(1024, loop_pow2_ceil(n))


@pytest.mark.parametrize("st", ["bf16", "f8e4m3"])
def test_cpu_tensors_never_launch_the_kernel(st):
    before = (tgemv.launches, tgemv.staged_launches)
    a, x, r = (interop.from_numpy(v) for v in _data(16, 300, st, 37))
    for tier in TIERS:
        ar, precise = _ar(tier)
        tgemv.acc_gemv(a, x, r, ar=ar, precise=precise)
    assert (tgemv.launches, tgemv.staged_launches) == before
