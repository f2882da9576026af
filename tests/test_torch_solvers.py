"""The port's solvers (accblas_tpu_torch.models) against the JAX package's
(accblas_tpu.models) on identical inputs, mirroring tests/test_solvers.py.

The inputs are made with numpy from the JAX tests' seeds; the JAX solvers
run their Pallas DOT and GEMV in interpret mode on the CPU, as their own
tests do, and the port its plain torch versions. Port and JAX agree on x
within 1e-4 relative, on the iteration count and a breakdown's NaN exactly,
and on the power method's estimate from the same start vector within 1e-5
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from accblas_tpu import models as jmodels
from accblas_tpu_torch import models
from accblas_tpu_torch.models import solvers
from accblas_tpu_torch.utils import MatrixInfo, gen_mtx, interop

torch.set_num_threads(1)

X_TOL = 1e-4


def _spd(n, seed=42):
    m = gen_mtx(MatrixInfo(n, n), seed=seed)
    return m @ m.T / n + np.eye(n) * 2.0


def _vec(n, seed):
    return gen_mtx(MatrixInfo(1, n), seed=seed)[0]


def _rel(got, ref):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _both(a64, b64, st="f32"):
    """(port A, port b, JAX A, JAX b) holding the same stored values."""
    a32 = a64.astype(np.float32)
    ja = jnp.asarray(a32)
    if st == "bf16":
        ja = ja.astype(jnp.bfloat16)
    return (interop.from_numpy(a32, st), torch.from_numpy(b64.astype(np.float32)), ja,
            jnp.asarray(b64, jnp.float32))


def _cg_both(a64, b64, st="f32", **kw):
    ta, tb, ja, jb = _both(a64, b64, st)
    got = models.cg(ta, tb, **kw)
    want = jmodels.cg(ja, jb, **kw)
    assert int(got[2]) == int(want[2])
    return got, want


def test_cg_converges_f32():
    n = 256
    a64, b64 = _spd(n), _vec(n, 7)
    (x, rs, it), (jx, _, _) = _cg_both(a64, b64, iters=200, tol=1e-6)
    ref = np.linalg.solve(a64, b64)
    assert _rel(x, ref) < 1e-4
    assert int(it) < 200  # tol fired
    assert _rel(x, jx) < X_TOL


def test_cg_bf16_storage_df64_dots():
    n = 256
    a64, b64 = _spd(n, seed=3), _vec(n, 9)
    (x, rs, it), (jx, _, _) = _cg_both(a64, b64, "bf16", iters=100, ar="df64")
    a_st = interop.from_numpy(a64.astype(np.float32), "bf16").double().numpy()
    ref = np.linalg.solve(a_st, b64)
    assert _rel(x, ref) < 5e-2
    assert _rel(x, jx) < X_TOL


def test_richardson_refine_reduces_residual():
    n = 256
    a64 = gen_mtx(MatrixInfo(n, n), seed=5) * 0.5 / n + np.eye(n)
    ta, tb, ja, jb = _both(a64, _vec(n, 11))
    x, rhist = models.richardson_refine(ta.to(torch.bfloat16), ta, tb, iters=8)
    r = rhist.double().numpy()
    assert rhist.shape == (8,)
    assert r[-1] < r[0] * 1e-3
    jx, jr = jmodels.richardson_refine(ja.astype(jnp.bfloat16), ja, jb, iters=8)
    assert _rel(x, jx) < X_TOL
    assert abs(r[0] - float(jr[0])) <= 1e-5 * abs(float(jr[0]))


def test_power_method():
    n = 128
    a64 = _spd(n, seed=13)
    lam_ref = np.linalg.eigvalsh(a64)[-1]
    ta, _, ja, _ = _both(a64, np.zeros(n))
    _, lam = models.power_method(ta, iters=100)
    assert abs(float(lam) - lam_ref) / lam_ref < 1e-2
    # from the JAX package's own start vector, the same estimate
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (n,), jnp.float32))
    _, lam_p = models.power_iterate(ta, torch.from_numpy(x0), iters=100)
    _, lam_j = jmodels.power_method(ja, iters=100)
    assert abs(float(lam_p) - float(lam_j)) <= 1e-5 * abs(float(lam_j))
    # power_method draws that start vector itself (normal(key(seed)), within
    # a few ulp of JAX's), so its estimate is the JAX one too
    assert abs(float(lam) - float(lam_j)) <= 1e-5 * abs(float(lam_j))


class _HostReads(TorchFunctionMode):
    """Counts the tensor methods that read a value back to the host."""

    READS = {"__bool__", "__float__", "__int__", "__index__", "item", "tolist", "numpy",
             "cpu"}

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in self.READS:
            self.count += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("ar", ["f32", "df64"])
def test_cg_jits(ar):
    """The JAX test jits cg; the port's counterpart is a loop that never
    reads back to the host: no read in 20 iterations at tol == 0, through
    the default matvec and dots, and the state stays in tensors."""
    n = 128
    ta, tb, _, _ = _both(_spd(n, seed=17), np.ones(n))
    with _HostReads() as spy:
        x, rs, it = models.cg(ta, tb, iters=20, ar=ar)
    assert spy.count == 0
    assert all(isinstance(v, torch.Tensor) for v in (x, rs, it))
    assert np.all(np.isfinite(x.numpy())) and int(it) == 20


def test_cg_with_tol_reads_the_host_once_per_poll(monkeypatch):
    """With tol > 0 the loop reads its flag every POLL_EVERY iterations and
    stops there; the frozen state makes the result the same as a run that
    never stops early."""
    n = 256
    ta, tb, _, _ = _both(_spd(n), _vec(n, 7))
    with _HostReads() as spy:
        x, rs, it = models.cg(ta, tb, iters=200, tol=1e-6)
    assert 0 < spy.count <= 200 // solvers.POLL_EVERY + 1
    monkeypatch.setattr(solvers, "POLL_EVERY", 10**9)
    x2, rs2, it2 = models.cg(ta, tb, iters=200, tol=1e-6)
    assert torch.equal(x, x2) and torch.equal(rs, rs2) and int(it) == int(it2) < 200


def test_richardson_refine_streams_a_lo():
    # the preconditioner matvec must actually run through a_lo: perturbing
    # a_lo changes the iterate trajectory
    n = 128
    a64 = gen_mtx(MatrixInfo(n, n), seed=19) * 0.5 / n + np.eye(n)
    ta, tb, _, _ = _both(a64, _vec(n, 23))
    x_good, _ = models.richardson_refine(ta.to(torch.bfloat16), ta, tb, iters=4)
    x_pert, _ = models.richardson_refine((ta * 1.5).to(torch.bfloat16), ta, tb, iters=4)
    assert not np.allclose(x_good.numpy(), x_pert.numpy())


def test_richardson_refine_beats_plain_richardson():
    # the two-term Neumann step through a_lo contracts faster than a plain
    # Richardson update (a_lo = 0 degenerates to x += 2*omega*r)
    n = 128
    a64 = gen_mtx(MatrixInfo(n, n), seed=29) * 0.5 / n + np.eye(n)
    ta, tb, ja, jb = _both(a64, _vec(n, 31))
    _, r_mixed = models.richardson_refine(ta.to(torch.bfloat16), ta, tb, iters=6, omega=1.0)
    _, r_plain = models.richardson_refine(torch.zeros_like(ta), ta, tb, iters=6, omega=0.5)
    assert float(r_mixed[-1]) < float(r_plain[-1])
    _, jr_plain = jmodels.richardson_refine(jnp.zeros_like(ja), ja, jb, iters=6, omega=0.5)
    np.testing.assert_allclose(r_plain.numpy(), np.asarray(jr_plain), rtol=1e-5)


def test_cg_breakdown_surfaces_nan():
    """A non-SPD operator (den < 0) surfaces as NaN rs and stops the count,
    as the JAX loop exits: the same iteration count and the same x."""
    n = 64
    (x, rs, it), (jx, jrs, jit) = _cg_both(-_spd(n), _vec(n, 9), iters=50, tol=0.0)
    assert np.isnan(float(rs)) and np.isnan(float(jrs))
    assert int(it) < 50
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))


def test_cg_fixed_budget_stays_inert_after_convergence():
    """rs reaching 0 keeps the guarded inert path: the whole fixed budget
    runs, the result finite and converged."""
    n = 64
    a64, b64 = _spd(n), _vec(n, 9)
    (x, rs, it), (jx, _, _) = _cg_both(a64, b64, iters=300, tol=0.0)
    assert int(it) == 300
    assert np.isfinite(float(rs))
    assert _rel(x, np.linalg.solve(a64, b64)) < 1e-4
    assert _rel(x, jx) < X_TOL


def test_cg_injected_matvec_and_dot():
    """matvec= and dot= run the same recurrence: torch.mv and torch.dot give
    the default's x to f32 rounding."""
    n = 128
    ta, tb, _, _ = _both(_spd(n, seed=17), _vec(n, 3))
    x, _, it = models.cg(ta, tb, iters=30)
    xi, _, iti = models.cg(ta, tb, iters=30, matvec=lambda p: torch.mv(ta, p), dot=torch.dot)
    assert int(it) == int(iti) == 30
    assert _rel(xi, x.double().numpy()) < X_TOL
