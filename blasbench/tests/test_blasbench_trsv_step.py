"""trsv.step_us (and its refinement cell's name, trsv.step_us.refine) on
hand-made slices and counters: the mean device time of one hop of the
sweep's chain, its records held to the port's sweep counters, and nothing
read from a port that does not count its steps."""

import sys
from types import SimpleNamespace

import pytest

from blasbench import spec
from blasbench import trace as tr

US = 1_000  # ns
SWEEP = "void accblas::(anonymous namespace)::trsv_sweep<float, false, 1>(float const*, long)"
PHASE = "void accblas::(anonymous namespace)::leaf_phase<float>(float const*, long)"
PORT = "accblas_tpu_torch.ops.trsv"


def _slice(sweeps_us, launches, steps, base=0):
    """A slice with one trsv_sweep record of each length in `sweeps_us` (a
    leaf_phase record and a memset before each), and the port's counters'
    growth over it."""
    dev, t = [], base
    for us in sweeps_us:
        dev += [(t, t + 10 * US, PHASE), (t + 11 * US, t + 12 * US, "Memset (Device)"),
                (t + 12 * US, t + 12 * US + us * US, SWEEP)]
        t += 20 * US + us * US
    counters = {"trsv.sweep_launches": launches, "trsv.sweep_steps": steps}
    return tr.Slice(base, t, dev, [], [], requests=len(sweeps_us), counters=counters)


def _ctx(slices):
    return SimpleNamespace(trace=tr.Trace(slices))


@pytest.fixture
def reader(monkeypatch):
    """The metric's reader as a run loads it: after the port, here a module
    with both counters."""
    monkeypatch.setitem(sys.modules, PORT, SimpleNamespace(sweep_launches=0, sweep_steps=0))
    return spec.metric("trsv.step_us")


@pytest.mark.parametrize("name", ["trsv.step_us", "trsv.step_us.refine"])
def test_reads_the_mean_hop(monkeypatch, name):
    monkeypatch.setitem(sys.modules, PORT, SimpleNamespace(sweep_launches=0, sweep_steps=0))
    read = spec.metric(name).read
    # two slices of 256-step sweeps: 512 us over 2 x 256 steps, 256 us over 256
    ctx = _ctx([_slice([256, 256], 2, 512), _slice([256], 1, 256, base=10**9)])
    assert read(ctx) == pytest.approx(1.0)
    ctx = _ctx([_slice([512, 256], 2, 512)])
    assert read(ctx) == pytest.approx(1.5)


def test_a_dropped_record_takes_its_steps_with_it(reader):
    """The profiler lost one of three launches' records: the steps are those
    of the two launches it kept."""
    assert reader.read(_ctx([_slice([300, 212], 3, 768)])) == pytest.approx(1.0)


def test_more_records_than_launches_reads_nothing(reader):
    assert reader.read(_ctx([_slice([256, 256, 256], 2, 512)])) is None


@pytest.mark.parametrize("what", ["no sweep record", "no steps", "untraced"])
def test_nothing_to_read(reader, what):
    if what == "untraced":
        assert reader.read(SimpleNamespace(trace=None)) is None
        return
    sl = _slice([256], 1, 256 if what == "no sweep record" else 0)
    if what == "no sweep record":
        sl.device = [d for d in sl.device if "trsv_sweep" not in d[2]]
    assert reader.read(_ctx([sl])) is None


def test_counters_follow_the_port(monkeypatch):
    """The run reads the counters the reader declares: both where the port
    counts its steps, its launches alone where it does not (a port from
    before the counter; the metric then reads nothing), and the launches
    where no port is loaded (the run reads 0 for a module not loaded)."""
    monkeypatch.setitem(sys.modules, PORT, SimpleNamespace(sweep_launches=0, sweep_steps=0))
    assert spec.metric("trsv.step_us").COUNTERS == {
        "trsv.sweep_launches": (PORT, "sweep_launches"),
        "trsv.sweep_steps": (PORT, "sweep_steps")}
    monkeypatch.setitem(sys.modules, PORT, SimpleNamespace(sweep_launches=0))
    older = spec.metric("trsv.step_us")
    assert older.COUNTERS == {"trsv.sweep_launches": (PORT, "sweep_launches")}
    sl = _slice([256], 1, 256)
    del sl.counters["trsv.sweep_steps"]
    assert older.read(_ctx([sl])) is None
    monkeypatch.delitem(sys.modules, PORT)
    assert set(spec.metric("trsv.step_us").COUNTERS) == {"trsv.sweep_launches"}


def test_the_refinement_cell_reads_the_same_family():
    assert spec.metric("trsv.step_us.refine").__file__ == spec.metric("trsv.step_us").__file__
