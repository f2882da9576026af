"""The trace arithmetic on synthetic event lists: busy time, the idle share,
what the host did in the gaps, and the readers that use them."""

from types import SimpleNamespace

import pytest

from blasbench import roofline, spec
from blasbench import trace as tr


def _slice():
    # a 100 us slice: two kernels overlapping (10-30, 20-40), a read-back
    # copy (60-70), the device idle 0-10, 40-60 and 70-100
    device = [(10_000, 30_000, "void dot_reduce<bf16>(x)"), (20_000, 40_000, "void other()"),
              (60_000, 70_000, "Memcpy DtoH (Device -> Pageable)")]
    spans = [(0, 55_000, "blasbench.call"), (55_000, 100_000, "blasbench.read")]
    host = [(1_000, 9_000, "aten::empty"), (2_000, 8_000, "cudaMalloc"),
            (41_000, 59_000, "cudaLaunchKernel"), (71_000, 99_000, "cudaStreamSynchronize")]
    return tr.Slice(0, 100_000, device, host, spans, requests=2,
                    counters={"gemv.launches": 3})


def test_union_and_idle_share():
    t = tr.Trace([_slice()])
    assert tr.merged(_slice().device) == [(10_000, 40_000), (60_000, 70_000)]
    assert t.window_s() == pytest.approx(100e-6)
    assert t.busy_s() == pytest.approx(40e-6)
    assert t.idle_share() == pytest.approx(0.6)
    # two slices add their lengths and busy times
    assert tr.Trace([_slice(), _slice()]).idle_share() == pytest.approx(0.6)


def test_idle_gaps_by_host_activity():
    gaps = dict(map(tuple, tr.Trace([_slice()]).idle_gaps()))
    # 0-10 at 5 us: inside cudaMalloc inside aten::empty -> the innermost
    assert gaps["call: cudaMalloc"] == pytest.approx(10e-6)
    assert gaps["call: cudaLaunchKernel"] == pytest.approx(20e-6)  # 40-60 at 50 us
    assert gaps["read: cudaStreamSynchronize"] == pytest.approx(30e-6)
    assert sum(gaps.values()) == pytest.approx(60e-6)


def test_top_device_ops_and_counters():
    t = tr.Trace([_slice(), _slice()])
    top = t.top_device_ops()
    assert top[0][0].startswith("void dot_reduce") and top[0][1] == pytest.approx(40e-6)
    assert t.requests() == 4 and t.counter("gemv.launches") == 6


def _ctx(trace, mix=None, config=None, bytes_per_call=None, kind="call"):
    cell = SimpleNamespace(mix=mix or {}, config=config or {})
    return SimpleNamespace(trace=trace, cell=cell, peak_gbps=3350.0,
                           driver=SimpleNamespace(bytes_per_call=bytes_per_call, kind=kind))


@pytest.mark.parametrize("name", ["dot_roofline", "trsv_roofline"])
def test_roofline_reader_leaves_out_readback(name):
    nbytes = 3350 * 10**3  # 1 us at 3350 GB/s
    share = spec.metric(name).read(_ctx(tr.Trace([_slice()]), bytes_per_call=nbytes))
    # device time of the call: 30 us of kernels (union) / 2 requests... summed
    # per op: 20 + 20 = 40 us over 2 requests = 20 us a call
    assert share == pytest.approx(100.0 * 1e-6 / 20e-6)


def test_leaf_phase_share():
    s = _slice()
    s.device = [(0, 10_000, "void leaf_diag<float>()"), (10_000, 40_000, "void trsv_sweep<f>()"),
                (40_000, 50_000, "Memcpy DtoH (Device -> Pageable)")]
    pct = spec.metric("trsv.leaf_phase_pct").read(_ctx(tr.Trace([s])))
    assert pct == pytest.approx(25.0)


def test_gemv_roofline_checks_the_launch_counter():
    s = _slice()
    n = 1024
    t_ns = round(roofline.bound_ms(roofline.gemv_bytes(n, n, "bf16", "bf16", "f32"), 3350.0) * 2e6)
    s.device = [(0, t_ns, "void gemv_rows<a>()"), (t_ns, 2 * t_ns, "void gemv_rows<a>()"),
                (2 * t_ns, 3 * t_ns, "void elementwise()")]
    ctx = _ctx(tr.Trace([s]), mix={"n": n}, config={"cg": {"storage": "bf16"}}, kind="solve")
    assert spec.metric("gemv_roofline").read(ctx) == pytest.approx(50.0, rel=1e-3)
    assert spec.metric("cg.launches_per_pass").read(ctx) == pytest.approx(3 / 3)
    s.counters = {"gemv.launches": 1}  # more records than launches: misattributed
    assert spec.metric("gemv_roofline").read(ctx) is None


@pytest.mark.parametrize("name", ["device_idle_pct.dot", "device_idle_pct.trsv",
                                  "device_idle_pct.cg"])
def test_idle_reader_needs_device_work(name):
    s = _slice()
    s.device = []
    assert spec.metric(name).read(_ctx(tr.Trace([s]))) is None
    assert spec.metric(name).read(_ctx(tr.Trace([_slice()]))) == pytest.approx(60.0)
