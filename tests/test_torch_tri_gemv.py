"""The triangular residual r = b - T x of the port against the JAX package.

Inputs as in tests/test_trsv.py: the packed LU factor of a diagonally
dominant seeded matrix, x and b from seeds, all made with numpy. On the CPU
the port runs its plain torch version; the JAX side runs its Pallas kernel
in interpret mode. The bound is the JAX test's own: the 1-norm error against
a float64 residual of the stored values is below 1e-6 of ||T x||_1, and the
two packages agree within twice that. The CUDA kernel is held against the
plain version on a card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.linalg
import torch

from accblas_tpu.ops import tri_gemv as jtri
from accblas_tpu_torch.ops import tri_gemv as ttri
from accblas_tpu_torch.utils import MatrixInfo, gen_mtx, interop

torch.set_num_threads(1)

TOL = 1e-6
_NP = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}


def _inputs(n, seed, st="f32"):
    a64 = gen_mtx(MatrixInfo(n, n), seed=seed) + np.eye(n) * (0.25 * n)
    lu, _ = scipy.linalg.lu_factor(a64)
    a = lu.astype(np.float32).astype(_NP[st])
    x = gen_mtx(MatrixInfo(1, n), seed=seed + 6)[0].astype(np.float32)
    b = gen_mtx(MatrixInfo(1, n), seed=seed + 1)[0].astype(np.float32)
    return a, x, b


def _oracle(a, x, b, uplo, unit):
    a64 = a.astype(np.float64)
    t = np.tril(a64) if uplo == "lower" else np.triu(a64)
    if unit:
        np.fill_diagonal(t, 1.0)
    tx = t @ x.astype(np.float64)
    return b.astype(np.float64) - tx, np.linalg.norm(tx, 1)


def _check(a, x, b, uplo, unit):
    got = ttri.tri_gemv_df64(*(interop.from_numpy(v) for v in (a, x, b)), uplo, unit)
    want = np.asarray(jtri.tri_gemv_df64(*(jnp.asarray(v) for v in (a, x, b)), uplo, unit),
                      np.float64)
    assert got.dtype == torch.float32 and got.shape == (a.shape[0],)
    ref, den = _oracle(a, x, b, uplo, unit)
    g = got.double().numpy()
    assert np.linalg.norm(g - ref, 1) / den < TOL
    assert np.linalg.norm(want - ref, 1) / den < TOL
    assert np.linalg.norm(g - want, 1) / den < 2 * TOL


@pytest.mark.parametrize("n,uplo,unit", [(700, "upper", False), (1024, "lower", True),
                                         (512, "upper", True), (512, "lower", False)])
def test_tri_gemv_df64_matches_jax(n, uplo, unit):
    _check(*_inputs(n, 83), uplo, unit)


def test_tri_gemv_df64_bf16_storage():
    _check(*_inputs(640, 89, "bf16"), "upper", False)


def test_tri_gemv_reads_only_the_triangle():
    """Entries outside the triangle, and the diagonal of a unit triangle,
    may hold anything: NaN there does not reach the result."""
    a, x, b = _inputs(300, 97)
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    want = ttri.tri_gemv_df64(torch.from_numpy(a), tx, tb, "upper", True)
    poisoned = np.where(np.triu(np.ones_like(a, bool), 1), a, np.float32("nan"))
    got = ttri.tri_gemv_df64(torch.from_numpy(poisoned), tx, tb, "upper", True)
    assert torch.equal(got, want)
    ref, den = _oracle(a, x, b, "upper", True)
    assert np.linalg.norm(got.double().numpy() - ref, 1) / den < TOL


def test_rejections_and_no_launch_on_cpu():
    before = ttri.launches
    a, x, b = (interop.from_numpy(v) for v in _inputs(64, 3))
    ttri.tri_gemv_df64(a, x, b)
    assert ttri.launches == before
    with pytest.raises(ValueError, match="square"):
        ttri.tri_gemv_df64(a[:, :63], x, b)
    with pytest.raises(ValueError, match="kernel storage type"):
        ttri.tri_gemv_df64(a.double(), x, b)
