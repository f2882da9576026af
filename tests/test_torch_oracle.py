"""The port's device df64 oracle (accblas_tpu_torch.ops.oracle), mirroring
tests/test_oracle.py: each of its three functions lands at the df64 floor
against the numpy fp64 result, and within 1e-13 of the JAX package's oracle
given the same (hi, lo) split."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from accblas_tpu.ops import oracle as joracle
from accblas_tpu_torch.ops import df64 as dfm
from accblas_tpu_torch.ops import oracle
from accblas_tpu_torch.utils import MatrixInfo, devgen, gen_mtx

torch.set_num_threads(1)


def _split(shape, role):
    return devgen.split_df64(None, shape, 42, role, 0, device="cpu")


def _j(*ts):
    return [jnp.asarray(t.numpy()) for t in ts]


def _val(out) -> np.ndarray:
    return np.asarray(out.hi, np.float64) + np.asarray(out.lo, np.float64)


@pytest.mark.parametrize("n", [1024, 8192])
def test_oracle_dot_at_df64_floor(n):
    xh, xl = _split((n,), "dot_x")
    yh, yl = _split((n,), "dot_y")
    ref = devgen.master_f64((n,), 42, "dot_x") @ devgen.master_f64((n,), 42, "dot_y")
    got = float(dfm.df_to_f64(oracle.dot_df64(xh, xl, yh, yl)))
    assert abs(got - ref) / abs(ref) < 1e-12  # ~2^-48 plus cancellation
    if n <= 1024:  # the JAX oracle runs its Pallas DOT in interpret mode here
        want = float(_val(joracle.dot_df64(*_j(xh, xl, yh, yl))))
        assert abs(got - want) / abs(ref) < 1e-13


def test_oracle_gemv_at_df64_floor():
    m, n = 192, 2048
    ah, al = _split((m, n), "gemv_a")
    xh, xl = _split((n,), "gemv_x")
    ref = devgen.master_f64((m, n), 42, "gemv_a") @ devgen.master_f64((n,), 42, "gemv_x")
    g = _val(oracle.gemv_df64(ah, al, xh, xl, block=64))
    assert np.max(np.abs(g - ref)) / np.max(np.abs(ref)) < 1e-12
    want = _val(joracle.gemv_df64(*_j(ah, al, xh, xl), block=64))
    assert np.max(np.abs(g - want)) / np.max(np.abs(ref)) < 1e-13
    # the row block only bounds the temporaries
    g2 = _val(oracle.gemv_df64(ah, al, xh, xl, block=50))
    np.testing.assert_array_equal(g, g2)


@pytest.mark.parametrize("uplo", ["upper", "lower"])
def test_oracle_trsv_refines_to_df64(uplo):
    n = 512
    lu64, _ = scipy.linalg.lu_factor(gen_mtx(MatrixInfo(n, n), seed=42))
    b64 = gen_mtx(MatrixInfo(1, n), seed=43)[0]
    t = np.triu(lu64) if uplo == "upper" else np.tril(lu64)
    ref = scipy.linalg.solve_triangular(t, b64, lower=(uplo == "lower"))
    th = t.astype(np.float32)
    tl = (t - th.astype(np.float64)).astype(np.float32)
    bh = b64.astype(np.float32)
    bl = (b64 - bh.astype(np.float64)).astype(np.float32)
    ops = [torch.from_numpy(v) for v in (th, tl, bh, bl)]
    x64 = _val(oracle.trsv_df64(*ops, uplo, False))
    assert np.max(np.abs(x64 - ref)) / np.max(np.abs(ref)) < 1e-11  # κ(T)·2^-48
    want = _val(joracle.trsv_df64(*_j(*ops), uplo, False))
    # both refinements stop at their own df64 floor, κ(T)·2^-48 in scale
    # (upper: κ ≈ 2500, each ~1.5e-13 from the fp64 solve), with rounding
    # that differs between the two f32 correction solves: they agree as
    # closely as the JAX oracle agrees with the fp64 solve
    scale = np.max(np.abs(ref))
    jax_err = np.max(np.abs(want - ref)) / scale
    assert np.max(np.abs(x64 - want)) / scale < 1e-13 + 2 * jax_err
