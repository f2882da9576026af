"""The refinement cell on the CPU, at sizes a test run holds: a run end to
end, traced and not; the program correct and the f32 control and planted
faults refused (as ``test_blasbench_control.py`` does for the other
cells); its readers on hand-made slices (and on slices of a port without
its spans or kernel); the float64 reference against plain solves; and
its driver on a port without the solver, which has to fail before it
draws anything. The card's own run of the driver is marked ``cuda``."""

import sys
from types import SimpleNamespace

import pytest
import torch

from accblas_tpu_torch.models import solvers
from accblas_tpu_torch.ops import df64 as dfm
from blasbench import roofline, run, spec
from blasbench import trace as tr
from blasbench.reference import refine as ref

US = 1_000  # ns
N = 65536
CELL = "refine.bf16.n65536"
SMALL = 512  # n of the CPU runs


@pytest.fixture
def one_thread():
    """One torch thread, as ``run.main`` runs a cell: a solve is some 200
    small ops, which extra threads on a shared host only slow."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(variant="program", seed=2**31 + 3, traced=False, n=SMALL, device="cpu"):
    cell = spec.cell(CELL)
    cell.mix["n"] = n
    cell.mix["trace_slice_requests"] = 2
    return run.run_cell(cell, seed, 0.5, traced, torch.device(device), variant=variant)


@pytest.mark.parametrize("traced", [False, True])
def test_cpu_run(one_thread, traced):
    cell = spec.cell(CELL)
    r = _run(traced=traced)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] and r["attempted"] >= 2 and r["failed"] == 0
    if traced:
        assert "breakdown" in r and r["device"]["window_s"] > 0
    names = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    if traced:
        # the CPU has no device trace: the counter's and the spans' metrics
        assert {"refine.steps_per_solve", "refine.step_host_us"} <= set(r["metrics"]) <= names
    else:
        assert set(r["metrics"]) == names
        assert all(m["value"] > 0 for m in r["metrics"].values())
    for c in r["checks"].values():
        assert 0 <= c["value"] <= c["limit"]


def test_same_seed_same_inputs():
    """The system and the pool come from --seed alone: the same seed, the
    same A, factors and right-hand sides; another seed, others."""
    cell = spec.cell(CELL)
    cell.mix["n"] = 128
    drv = spec.driver("refine").Driver

    def inputs(seed):
        d = drv(cell.config, cell.mix, seed, "cpu")
        return [d.a, d.lu, d.b]

    one, two, other = inputs(2**31 + 77), inputs(2**31 + 77), inputs(78)
    assert all(torch.equal(u, v) for u, v in zip(one, two))
    assert not any(torch.equal(u, v) for u, v in zip(one, other))


def test_the_check_holds_the_solver_to_its_own_threshold():
    """The configuration's limit on the scaled residual is HPL's 16, the
    threshold at which lu_refine stops."""
    assert spec.cell(CELL).config["refine"]["check"]["hpl_resid"] == solvers.HPL_THRESHOLD == 16


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 2**33 + 17])
def test_program_is_correct_and_control_is_not(one_thread, seed):
    assert _run(seed=seed)["correct"]
    r = _run("control", seed=seed)
    assert not r["correct"] and r["checks"]["hpl_resid"]["value"] > 16.0, r["checks"]


def _refine_unchanged(real):
    def lu_refine(lu, a, b, **kw):
        x, resid, steps = real(lu, a, b, **kw)
        return dfm.df_zeros(x.shape), resid, steps  # the solve hands back nothing solved
    return lu_refine


def _residual_half(real):
    def residual(a, x, b, *args):
        cut = a.clone()
        cut[:, a.shape[1] // 2:] = 0  # half of the columns left out of the residual
        return real(cut, x, b, *args)
    return residual


def _refine_negated(real):
    def lu_refine(lu, a, b, **kw):
        x, resid, steps = real(lu, a, b, **kw)
        return -x, resid, steps
    return lu_refine


@pytest.mark.parametrize("attr, plant", [("lu_refine", _refine_unchanged),
                                         ("_residual", _residual_half),
                                         ("lu_refine", _refine_negated)],
                         ids=["unchanged", "half", "altered"])
def test_planted_fault_is_refused(monkeypatch, one_thread, attr, plant):
    monkeypatch.setattr(solvers, attr, plant(getattr(solvers, attr)))
    r = _run()
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
def test_card_program_and_control():
    """On a card at n = 2048, through the port's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert _run(n=2048, device="cuda", traced=True)["correct"]
    assert not _run("control", n=2048, device="cuda")["correct"]


def _ctx(slices, counters=None, requests=1):
    cell = spec.cell(CELL)
    window = SimpleNamespace(counters=counters or {}, requests=[None] * requests)
    return SimpleNamespace(trace=tr.Trace(slices) if slices is not None else None, cell=cell,
                           window=window, peak_gbps=roofline.peak_gbps("NVIDIA H100 80GB HBM3"))


def _solve_slice(steps=3, resid_us=5500, sweep_us=2000, phase_us=20, dfx=True):
    """One solve's device records: a residual a step and one more, each
    step's two leaf phases and sweeps, a few small ops; and its spans."""
    dev, host, t = [], [], 0
    name = "void accblas::(anonymous namespace)::gemv_rows_dfx<float>(...)" if dfx \
        else "void accblas::(anonymous namespace)::gemv_rows<float, float, 4>(...)"
    for s in range(steps + 1):
        if s:
            host.append((t, t + 400 * US, "accblas.refine.step"))
            for _ in range(2):
                dev.append((t, t + phase_us * US, "void accblas::leaf_phase<__nv_bfloat16>()"))
                t += phase_us * US
                dev.append((t, t + sweep_us * US, "void accblas::trsv_sweep<__nv_bfloat16>()"))
                t += sweep_us * US
        dev.append((t, t + resid_us * US, name))
        t += resid_us * US
        dev.append((t, t + 10 * US, "void at::native::elementwise_kernel()"))
        t += 10 * US
        host.append((t, t + 50 * US, "accblas.refine.poll"))
        t += 100 * US
    host = sorted([(0, t, "accblas.refine")] + host)
    return tr.Slice(0, t, dev, host, [], requests=1)


def test_residual_roofline_reads_the_dfx_records_held_to_the_counter():
    bound_ms = roofline.bound_ms(N * N * 4 + N * 20, 3350.0)
    assert round(bound_ms, 3) == 5.129
    read = spec.metric("residual_roofline").read
    sl = _solve_slice(resid_us=6000)
    sl.counters = {"gemv.dfx_launches": 4}
    assert read(_ctx([sl])) == pytest.approx(100 * bound_ms / 6.0)
    # a record the counter does not hold, no record, no trace: nothing
    sl.counters = {"gemv.dfx_launches": 3}
    assert read(_ctx([sl])) is None
    other = _solve_slice(dfx=False)
    other.counters = {"gemv.dfx_launches": 4}
    assert read(_ctx([other])) is None
    assert read(_ctx(None)) is None


def test_trsv_share_of_the_device_time():
    sl = _solve_slice(steps=2, resid_us=5000, sweep_us=2000, phase_us=0)
    # 3 residuals of 5000, 3 small ops of 10, 4 sweeps of 2000 (the leaf
    # phases take no time here)
    want = 100 * 8000 / (15000 + 30 + 8000)
    assert spec.metric("refine.trsv_pct").read(_ctx([sl])) == pytest.approx(want)
    assert spec.metric("refine.trsv_pct").read(_ctx(None)) is None


def test_step_host_time_and_steps_per_solve():
    ctx = _ctx([_solve_slice(), _solve_slice()], {"refine_steps": 12}, requests=3)
    assert spec.metric("refine.step_host_us").read(ctx) == pytest.approx(400.0)
    assert spec.metric("refine.steps_per_solve").read(ctx) == pytest.approx(4.0)
    assert spec.metric("refine.steps_per_solve").COUNTERS == {
        "refine_steps": ("accblas_tpu_torch.models.solvers", "refine_steps")}


def test_readers_of_a_port_without_the_solver_read_nothing():
    """The spans and the kernel of an older port are absent: its traced
    slices give the new metrics nothing."""
    host = [(0, 10 * US, "aten::empty"), (20 * US, 30 * US, "accblas.gemv")]
    sl = tr.Slice(0, 100 * US, [(0, 50 * US, "void gemv_rows<float, float, 4>()")], host, [],
                  requests=1)
    ctx = _ctx([sl], {"gemv.dfx_launches": 0, "refine_steps": 0})
    for name in ("refine.step_host_us", "residual_roofline", "refine.trsv_pct"):
        assert spec.metric(name).read(ctx) is None
    assert spec.metric("device_idle_pct.refine").read(ctx) == pytest.approx(50.0)


def test_driver_fails_at_once_without_the_solver(monkeypatch):
    """On a port without ``lu_refine`` the driver raises ImportError before
    it draws or factors anything."""
    monkeypatch.setitem(sys.modules, "accblas_tpu_torch.models.solvers", SimpleNamespace())
    drawn = []
    monkeypatch.setattr(torch, "rand", lambda *a, **k: drawn.append(a))
    cell = spec.cell(CELL)
    with pytest.raises(ImportError):
        spec.driver("refine").Driver(cell.config, cell.mix, 1, "cpu")
    assert drawn == []


def _system(n, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(n, n, generator=g, dtype=torch.float64) - 0.5
    a.diagonal().copy_(a.abs().sum(1) - a.diagonal().abs())
    return a.float(), torch.rand(n, 3, generator=g) * 2 - 1


@pytest.mark.parametrize("st", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [100, 2500])
def test_reference_solve_and_scaled_residual(n, st):
    """Blocks of 2048 rows: n = 2500 spans two, ragged. The solution on
    the stored factors refines to float64's own solve of the stored A, and
    its scaled residual is of order one; the factors' own solve is not
    (about 2^-9 of x with bf16 factors)."""
    a, b = _system(n, n)
    lu, _ = torch.linalg.lu_factor(a)
    lu = lu.to(st)
    x = ref.solve(a, lu, b)
    x64 = torch.linalg.solve(a.double(), b.double())
    assert float((x - x64).abs().max() / x64.abs().max()) <= 1e-14
    assert float(ref.hpl_resid(a, x, b).max()) <= 1.0
    r64 = b.double() - a.double() @ x
    den = (a.double().abs().sum(1).max() * x.abs().amax(0) + b.double().abs().amax(0)) \
        * n * 2.0**-53
    assert torch.allclose(ref.hpl_resid(a, x, b), r64.abs().amax(0) / den, rtol=1e-6)
    assert float(ref.inf_norm(a)) == float(a.double().abs().sum(1).max())
    once = ref.lu_solve(lu, b)
    assert float(ref.hpl_resid(a, once, b).min()) > 16.0
