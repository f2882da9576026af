"""LU iterative refinement (``models.solvers.lu_refine``) and the GEMV with x
a DF pair that takes its residual, on the CPU, where both run their plain
paths.

The systems are the benchmark cell's recipe at small n: uniform(-0.5, 0.5)
off the diagonal, each diagonal entry its row's sum of |off-diagonal
entries|, factored without pivoting in f32 and stored in f32 or bf16. The
solution is held to the benchmark's float64 reference
(``blasbench.reference.refine``: refinement in float64 on the same stored
factors) and to ``torch.linalg.solve`` in float64, and the scaled residual
to HPL's threshold; the f32-residual control has to miss it."""

import numpy as np
import pytest
import torch

import accblas_tpu_torch as acc
from accblas_tpu_torch import models
from accblas_tpu_torch.models import solvers
from accblas_tpu_torch.ops import df64 as dfm
from accblas_tpu_torch.ops import gemv as gemvops
from blasbench.reference import refine as ref

torch.set_num_threads(1)

STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16}

# x against the float64 solution, |x - x64|_inf / |x64|_inf. HPL's test
# bounds the backward error by 16 n 2^-53 (3.6e-12 at n = 2048), and these
# systems are well conditioned (kappa_inf(A) 4.3 to 4.7 at the sizes here,
# kappa_2 1.1 to 1.3; test_systems_are_well_conditioned), so the forward
# error stays below 2e-11; the runs read 1.3e-13 to 7.7e-13. The f32 control's x
# errs 1.5e-7 to 1.9e-7, far outside.
X_TOL = 1e-10


def _system(n: int, seed: int = 0):
    """(A, b) of the cell's recipe, f32, from a seeded CPU generator."""
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(n, n, generator=g) - 0.5
    a.diagonal().zero_()
    a.diagonal().copy_(a.abs().sum(1))
    b = torch.rand(n, generator=g) * 2 - 1
    return a, b


def _factors(a, st):
    lu, piv = torch.linalg.lu_factor(a)
    assert torch.equal(piv, torch.arange(1, a.shape[0] + 1, dtype=piv.dtype))
    return lu.to(STORAGE[st], memory_format=torch.contiguous_format)


def _value(x: dfm.DF) -> torch.Tensor:
    return dfm.df_to_f64(x)


def _gap(x, x64) -> float:
    return float((x - x64).abs().max() / x64.abs().max())


@pytest.mark.parametrize("st", list(STORAGE))
@pytest.mark.parametrize("n", [256, 1000, 2048])
def test_lu_refine_meets_hpl_and_the_references(n, st):
    """n = 1000 leaves a ragged last 64-row leaf and 512-row block; bf16
    factors take more steps than f32 ones, each contracting the error by
    about their storage precision."""
    a, b = _system(n, seed=n)
    lu = _factors(a, st)
    x, resid, steps = models.lu_refine(lu, a, b)
    assert float(resid) <= 16.0 and 1 <= steps <= (2 if st == "f32" else 6)
    got = _value(x)
    x_ref = ref.solve(a, lu, b[:, None])[:, 0]
    x_solve = torch.linalg.solve(a.double(), b.double())
    assert _gap(got, x_ref) <= X_TOL and _gap(got, x_solve) <= X_TOL
    assert float(ref.hpl_resid(a, got[:, None], b[:, None])[0]) <= 16.0


@pytest.mark.parametrize("st", list(STORAGE))
@pytest.mark.parametrize("n", [256, 1000])
def test_f32_residual_control_misses_hpl(n, st):
    """With x and the residual in f32 the scaled residual stalls far above
    16 (1e5 and more), so the control runs out its steps."""
    a, b = _system(n, seed=n + 1)
    x, resid, steps = models.lu_refine(_factors(a, st), a, b, ar="f32", max_steps=8)
    assert steps == 8 and float(resid) > 1e3
    assert torch.equal(x.lo, torch.zeros_like(x.lo))
    x_solve = torch.linalg.solve(a.double(), b.double())
    assert _gap(_value(x), x_solve) > 100 * X_TOL


@pytest.mark.parametrize("n", [256, 1000, 2048])
def test_systems_are_well_conditioned(n):
    a, _ = _system(n, seed=n)
    assert float(torch.linalg.cond(a.double(), float("inf"))) < 5.0


def test_lu_refine_given_anorm_and_exported():
    a, b = _system(300, seed=5)
    lu = _factors(a, "bf16")
    one = models.lu_refine(lu, a, b)
    two = solvers.lu_refine(lu, a, b, anorm=float(solvers.inf_norm(a)))
    assert torch.equal(one[0].hi, two[0].hi) and torch.equal(one[0].lo, two[0].lo)
    assert float(solvers.inf_norm(a)) == float(a.double().abs().sum(1).max())
    assert "lu_refine" in models.__all__
    with pytest.raises(ValueError, match="arithmetic"):
        models.lu_refine(lu, a, b, ar="bf16")


def test_lu_refine_stops_at_max_steps():
    a, b = _system(256, seed=9)
    lu = _factors(a, "bf16")
    x, resid, steps = models.lu_refine(lu, a, b, max_steps=1)
    assert steps == 1 and float(resid) > 16.0
    _, _, zero = models.lu_refine(lu, a, b, max_steps=0)
    assert zero == 0


# ---- the GEMV with x a DF pair ----

def _dfx(n, seed):
    g = torch.Generator().manual_seed(seed)
    x64 = torch.rand(n, generator=g, dtype=torch.float64) - 0.5
    hi = x64.float()
    return dfm.DF(hi, (x64 - hi.double()).float())


@pytest.mark.parametrize("df_out", [True, False])
@pytest.mark.parametrize("st", list(STORAGE))
@pytest.mark.parametrize("m,n", [(1, 1), (7, 1234), (300, 1000), (64, 4096)])
def test_dfx_gemv_plain_against_float64(m, n, st, df_out):
    """b - A x with x = hi + lo: within 2^-46 of Σ|a||x| + |b| with the
    (hi, lo) result (a row's DF sum errs a few units of 2^-48 of it), and
    the result rounded once to f32 otherwise. Without the lo word, the
    error is x's own f32 rounding, about 2^-25 of the scale."""
    g = torch.Generator().manual_seed(m * n)
    a = (torch.rand(m, n, generator=g) - 0.5).to(STORAGE[st])
    b = torch.rand(m, generator=g) - 0.5
    x = _dfx(n, m + n)
    got = acc.acc_gemv(a, x, b, -1.5, 0.5, ar="df64", df_out=df_out)
    xv = _value(x)
    exact = 0.5 * b.double() - 1.5 * (a.double() @ xv)
    scale = 1.5 * (a.double().abs() @ xv.abs()) + 0.5 * b.double().abs()
    if df_out:
        assert isinstance(got, dfm.DF)
        assert float(((_value(got) - exact).abs() / scale).max()) <= 2.0**-46
    else:
        assert got.dtype == torch.float32
        assert torch.equal(got, exact.float())
    if n > 1:  # the lo word is read: dropping it moves the result
        hi_only = acc.acc_gemv(a, x.hi, b, -1.5, 0.5, ar="df64", precise=True, df_out=True)
        assert float(((_value(hi_only) - exact).abs() / scale).max()) > 2.0**-40


def test_dfx_gemv_counts_no_kernel_on_the_cpu_and_refuses_bad_x():
    a = torch.rand(4, 8)
    x = _dfx(8, 1)
    before = gemvops.dfx_launches
    acc.acc_gemv(a, x, torch.zeros(4), 1.0, 0.0, ar="df64", df_out=True)
    assert gemvops.dfx_launches == before
    with pytest.raises(ValueError, match="ar='df64'"):
        acc.acc_gemv(a, x, torch.zeros(4), ar="f32")
    with pytest.raises(ValueError, match="float32"):
        acc.acc_gemv(a, dfm.DF(x.hi.double(), x.lo), torch.zeros(4), ar="df64")
    with pytest.raises(ValueError, match="float32"):
        acc.acc_gemv(a, dfm.DF(x.hi[:4], x.lo[:4]), torch.zeros(4), ar="df64")


# ---- the packed L\U solves read only their own triangle ----

@pytest.mark.parametrize("st", list(STORAGE))
@pytest.mark.parametrize("uplo,unit", [("lower", True), ("upper", False)])
@pytest.mark.parametrize("n", [256, 1000])
def test_packed_solves_ignore_the_other_triangle(n, uplo, unit, st):
    """The lower unit solve with U's triangle and the diagonal set to NaN,
    and the upper non-unit solve with L's strict triangle set to NaN, give
    the packed factor's bits."""
    a, b = _system(n, seed=n + 2)
    lu = _factors(a, st)
    poison = lu.clone()
    keep = torch.ones(n, n, dtype=torch.bool)
    keep = torch.tril(keep, -1) if uplo == "lower" else torch.triu(keep)
    poison[~keep] = float("nan")
    want = acc.acc_trsv(lu, b, uplo, unit, ar="f32", unstable_ok=True)
    got = acc.acc_trsv(poison, b, uplo, unit, ar="f32", unstable_ok=True)
    assert torch.isfinite(want).all() and torch.equal(got, want)


# ---- spans and the step counter ----

def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("accblas."))
    return out, evs


def _inside(child, parent) -> bool:
    return parent[0] <= child[0] and child[1] <= parent[1]


def _children(evs, parent):
    inner = [e for e in evs if e is not parent and _inside(e, parent)]
    return [e for e in inner if not any(o is not e and _inside(e, o) for o in inner)]


def test_refine_spans_and_step_counter():
    """``accblas.refine`` holds the first solve's two TRSVs and its residual
    GEMV, a poll a step and one more, and the steps, each with two TRSVs
    and one GEMV; ``refine_steps`` grows by the steps taken."""
    a, b = _system(256, seed=11)
    lu = _factors(a, "bf16")
    before = solvers.refine_steps
    (x, resid, steps), evs = _profiled(lambda: models.lu_refine(lu, a, b))
    assert steps >= 2 and solvers.refine_steps == before + steps
    roots = [e for e in evs if not any(o is not e and _inside(e, o) for o in evs)]
    assert [e[2] for e in roots] == ["accblas.refine"]
    kids = [e[2] for e in _children(evs, roots[0])]
    assert kids[:3] == ["accblas.trsv", "accblas.trsv", "accblas.gemv"]
    assert kids[3:] == ["accblas.refine.poll", "accblas.refine.step"] * steps \
        + ["accblas.refine.poll"]
    for s in (e for e in evs if e[2] == "accblas.refine.step"):
        assert [e[2] for e in _children(evs, s)] == ["accblas.trsv", "accblas.trsv",
                                                     "accblas.gemv"]


def test_refine_without_profiler_records_nothing_and_keeps_its_bits():
    a, b = _system(256, seed=12)
    lu = _factors(a, "bf16")
    plain = models.lu_refine(lu, a, b)
    (traced, _, _), _ = _profiled(lambda: models.lu_refine(lu, a, b))
    assert np.array_equal(plain[0].hi.numpy(), traced.hi.numpy())
    assert np.array_equal(plain[0].lo.numpy(), traced.lo.numpy())
