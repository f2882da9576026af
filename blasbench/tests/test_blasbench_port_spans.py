"""The readers of the port's spans (``port_spans.py`` and the metrics that
use it) on hand-made slices, and on slices with no port span at all, as
an older port's traced run gives."""

import sys
from types import SimpleNamespace

import pytest

from blasbench import port_spans, spec
from blasbench import trace as tr

US = 1_000  # ns


def _ctx(slices):
    return SimpleNamespace(trace=tr.Trace(slices))


def _trsv_slice(base=0, gather=10, inverse=40, panels=5, sweep=60):
    """One trsv call at `base`: its phases one after the other, each with an
    ATen op inside (left out by the readers), then the benchmark's read."""
    t = base + 2 * US
    host = []
    for name, us in (("leaf_gather", gather), ("leaf_inverse", inverse), ("panels", panels),
                     ("sweep", sweep)):
        host += [(t, t + us * US, f"accblas.trsv.{name}"), (t + US // 2, t + US, "aten::empty")]
        t += us * US + US
    host = sorted([(base + US, t, "accblas.trsv")] + host)
    return tr.Slice(base, t + 10 * US, [], host, [], requests=1)


def test_trsv_phase1_and_sweep():
    slices = [_trsv_slice(), _trsv_slice(inverse=60, sweep=50), _trsv_slice(inverse=80, sweep=70)]
    ctx = _ctx(slices)
    # phase 1 of each call: 10 + 40 + 5, 10 + 60 + 5, 10 + 80 + 5
    assert spec.metric("trsv.phase1_host_us").read(ctx) == pytest.approx(75.0)
    assert spec.metric("trsv.sweep_host_us").read(ctx) == pytest.approx(60.0)


def test_trsv_call_without_phases_is_left_out():
    """A call that took the composition has no phase span: it is not a
    call of zero microseconds."""
    comp = tr.Slice(0, 100 * US, [], [(US, 90 * US, "accblas.trsv")], [], requests=1)
    assert spec.metric("trsv.phase1_host_us").read(_ctx([comp, _trsv_slice()])) \
        == pytest.approx(55.0)
    assert spec.metric("trsv.phase1_host_us").read(_ctx([comp])) is None


def test_dot_launch():
    host = [(0, 30 * US, "accblas.dot"), (5 * US, 25 * US, "accblas.dot.launch"),
            (40 * US, 60 * US, "accblas.dot"), (42 * US, 52 * US, "accblas.dot.launch"),
            (43 * US, 44 * US, "cudaLaunchKernel"),
            (70 * US, 99 * US, "accblas.dot"), (71 * US, 98 * US, "accblas.dot.launch")]
    ctx = _ctx([tr.Slice(0, 100 * US, [], host, [], requests=3)])
    assert spec.metric("dot.launch_host_us").read(ctx) == pytest.approx(20.0)


def _cg_slice():
    """One solve: 16 passes of 100 us, each with a GEMV (30 us, its launch
    inside it) and two DOTs (10 us each); a poll of 50 us between passes 8
    and 9 (as if POLL_EVERY were 8)."""
    host, t = [], 0
    for i in range(16):
        if i == 8:
            host.append((t, t + 50 * US, "accblas.cg.poll"))
            host.append((t + US, t + 49 * US, "aten::_local_scalar_dense"))
            t += 50 * US
        host += [(t, t + 100 * US, "accblas.cg.pass"),
                 (t + 5 * US, t + 35 * US, "accblas.gemv"),
                 (t + 10 * US, t + 30 * US, "accblas.gemv.launch"),
                 (t + 40 * US, t + 50 * US, "accblas.dot"),
                 (t + 41 * US, t + 49 * US, "accblas.dot.launch"),
                 (t + 60 * US, t + 70 * US, "accblas.dot"),
                 (t + 75 * US, t + 80 * US, "aten::where")]
        t += 100 * US
    host = sorted([(0, t, "accblas.cg")] + host)
    return tr.Slice(0, t, [], host, [], requests=1)


def test_cg_pass_time_self_share_and_poll():
    ctx = _ctx([_cg_slice(), _cg_slice()])
    assert spec.metric("cg.pass_host_us").read(ctx) == pytest.approx(100.0)
    # 100 us a pass less the GEMV's 30 and the DOTs' 10 + 10: 50% self
    assert spec.metric("cg.pass_self_pct").read(ctx) == pytest.approx(50.0)
    assert spec.metric("cg.poll_wait_us").read(ctx) == pytest.approx(50.0)


def test_self_time_counts_overlapping_children_once():
    span = (0, 100, "accblas.cg.pass")
    evs = [span, (10, 40, "accblas.gemv"), (20, 30, "accblas.gemv.launch"),
           (35, 50, "accblas.dot"), (200, 300, "accblas.dot")]
    assert port_spans.self_ns(span, evs) == 100 - 40  # 10-50 once; the last is outside


def test_a_solve_that_never_polled_waits_zero():
    s = _cg_slice()
    s.host = [h for h in s.host if h[2] != "accblas.cg.poll"]
    ctx = _ctx([s, _cg_slice(), s])
    assert spec.metric("cg.poll_wait_us").read(ctx) == 0.0


@pytest.mark.parametrize("name", ["trsv.phase1_host_us", "trsv.sweep_host_us",
                                  "dot.launch_host_us", "cg.pass_host_us", "cg.pass_self_pct",
                                  "cg.poll_wait_us"])
def test_no_port_spans_reads_nothing(name):
    """An older port records no span: the reader reports nothing, and an
    untraced run has no trace at all."""
    host = [(0, 10 * US, "aten::empty"), (20 * US, 30 * US, "cudaLaunchKernel")]
    ctx = _ctx([tr.Slice(0, 100 * US, [(0, 50 * US, "void k()")], host,
                         [(0, 90 * US, "blasbench.call")], requests=1)])
    assert spec.metric(name).read(ctx) is None
    assert spec.metric(name).read(SimpleNamespace(trace=None)) is None


def test_load_seconds_read_from_the_port(monkeypatch):
    read = spec.metric("setup.load_s").read
    monkeypatch.setitem(sys.modules, "accblas_tpu_torch.ops._build",
                        SimpleNamespace(load_seconds=1.25))
    assert read(None) == 1.25
    # an older port, without the total, and no port loaded
    monkeypatch.setitem(sys.modules, "accblas_tpu_torch.ops._build", SimpleNamespace())
    assert read(None) is None
    monkeypatch.delitem(sys.modules, "accblas_tpu_torch.ops._build")
    assert read(None) is None


def test_no_new_reader_declares_counters():
    """The new readers take the port's spans, and the load total straight
    from the module: none adds to the window's counters."""
    for name in ("trsv.phase1_host_us", "trsv.sweep_host_us", "dot.launch_host_us",
                 "cg.pass_host_us", "cg.pass_self_pct", "cg.poll_wait_us", "setup.load_s"):
        assert not hasattr(spec.metric(name), "COUNTERS")
