"""The plain references against float64 NumPy at tiny sizes."""

import numpy as np
import pytest
import torch

from blasbench.reference import blas, cg
from blasbench.reference.tf32 import round_tf32


def _uniform(shape, seed):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed)) * 2 - 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dot(dtype):
    x, y = _uniform(5000, 1).to(dtype), _uniform(5000, 2).to(dtype)
    v, mag = blas.dot(x, y, chunk=777)
    xn, yn = x.double().numpy(), y.double().numpy()
    assert v == pytest.approx(float(np.dot(xn, yn)), rel=1e-14, abs=1e-12)
    assert mag == pytest.approx(float(np.abs(xn * yn).sum()), rel=1e-14)


@pytest.mark.parametrize("n, k", [(300, 1), (257, 3)])
def test_unit_upper_solve(n, k):
    a = _uniform((n, n), 3) / n
    b = _uniform((n, k), 4)
    t = np.triu(a.double().numpy(), 1) + np.eye(n)
    want = np.linalg.solve(t, b.double().numpy())
    got = blas.unit_upper_solve(a, b if k > 1 else b[:, 0], block=64)
    assert np.allclose(got.reshape(n, k).numpy(), want, rtol=0, atol=1e-13)
    # the TF32 control is near, and not as near
    ctl = blas.unit_upper_solve(a, b, block=64, prec="tf32").double().numpy()
    err = np.abs(ctl - want).sum() / np.abs(want).sum()
    assert 1e-6 < err < 2e-3


def test_round_tf32():
    one = 1.0
    vals = torch.tensor([one, one + 2**-11, one + 3 * 2**-11, -(one + 2**-12), 3.0e-39, 0.0,
                         one + 2**-10 + 2**-13], dtype=torch.float32)
    want = [one, one, one + 2**-9, -one, None, 0.0, one + 2**-10]
    got = round_tf32(vals).tolist()
    for g, w in zip(got, want):
        if w is not None:
            assert g == w
    # every result has its low 13 mantissa bits clear, and is within half a TF32 ulp
    x = _uniform(10000, 5) * 1e3
    r = round_tf32(x)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((r - x).abs() <= x.abs() * 2**-11).all()


def test_cg_converges_to_the_solution():
    n = 200
    c = _uniform((n, n), 6).double()
    a = c.T @ c / n + 0.01 * torch.eye(n, dtype=torch.float64)
    b = _uniform((n, 2), 7).double()
    x, it = cg.solve(a, b, 1e-10, 1000, None)
    want = np.linalg.solve(a.numpy(), b.numpy())
    assert np.allclose(x.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert (it > 10).all() and (it < 1000).all()
    # each column stops on its own: a zero right-hand side takes no iteration
    x0, it0 = cg.solve(a, torch.cat([b[:, :1], torch.zeros(n, 1, dtype=torch.float64)], 1),
                       1e-10, 1000, None)
    assert it0[1] == 0 and x0[:, 1].abs().max() == 0


def test_cg_rounds_p_to_the_stated_storage():
    n = 128
    c = _uniform((n, n), 8)
    a = (c.T @ c / n + 0.01 * torch.eye(n)).to(torch.bfloat16)
    b = _uniform((n, 1), 9)
    x_r, _ = cg.solve(a, b, 1e-5, 1000, torch.bfloat16)
    x_e, _ = cg.solve(a, b, 1e-5, 1000, None)
    gap = float((x_r - x_e).norm() / x_e.norm())
    assert 1e-6 < gap < 1e-2
