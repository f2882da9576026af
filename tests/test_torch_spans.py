"""The port's spans (``utils.spans``) on the CPU: the tree each public call
records under ``torch.profiler``, each child inside its parent; CG's pass
and poll spans against the passes and polls it ran; every span a
function-scope host event, not a user annotation (which the profiler would
copy onto a device's timeline); and with no profiler, nothing recorded
and the same bits. The launch spans, which only the CUDA routes make, are
tested on a card in ``tests/test_torch_cuda.py``."""

import json

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import accblas_tpu_torch as acc
from accblas_tpu_torch import models
from accblas_tpu_torch.models import solvers
from accblas_tpu_torch.ops import _build
from accblas_tpu_torch.utils import MatrixInfo, bench, gen_mtx, spans

torch.set_num_threads(1)

PHASES = ["accblas.trsv.leaf_inverse", "accblas.trsv.sweep"]


def _profiled(fn):
    """fn()'s result and its ``accblas.`` host events, (start, end, name,
    is_user_annotation, record scope) sorted by start, from a CPU profile
    around it."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.is_user_annotation(),
                  e.scope()) for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("accblas."))
    return out, evs


def _inside(child, parent) -> bool:
    return parent[0] <= child[0] and child[1] <= parent[1]


def _children(evs, parent):
    """The events directly inside `parent`: inside it, and inside no other
    event that is inside it."""
    inner = [e for e in evs if e is not parent and _inside(e, parent)]
    return [e for e in inner if not any(o is not e and _inside(e, o) for o in inner)]


def _same(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _operands(n=256, seed=3):
    a = torch.from_numpy((gen_mtx(MatrixInfo(n, n), seed=seed) / n).astype(np.float32))
    b = torch.from_numpy(gen_mtx(MatrixInfo(1, n), seed=seed + 1)[0].astype(np.float32))
    return a, b


def _spd(n, seed=42):
    m = gen_mtx(MatrixInfo(n, n), seed=seed)
    a = (m @ m.T / n + np.eye(n) * 2.0).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(gen_mtx(MatrixInfo(1, n), seed=7)[0]
                                                 .astype(np.float32))


CALLS = {
    "acc_dot": (lambda a, b: acc.acc_dot(b, b, ar="f32"), "accblas.dot", []),
    "dot": (lambda a, b: acc.dot(b, b), "accblas.dot", []),
    "acc_gemv": (lambda a, b: acc.acc_gemv(a, b, b, 1.5, 0.5, ar="f32"), "accblas.gemv", []),
    "gemv": (lambda a, b: acc.gemv(a, b, b), "accblas.gemv", []),
    "trsv": (lambda a, b: acc.trsv(a, b), "accblas.trsv", PHASES),
    "acc_trsv": (lambda a, b: acc.acc_trsv(a, b, "lower"), "accblas.trsv", PHASES),
    "trsm": (lambda a, b: acc.trsm(a, torch.stack([b, -b], 1)), "accblas.trsv", PHASES),
    "acc_trsm": (lambda a, b: acc.acc_trsm(a, torch.stack([b, b], 1), ar="df64"),
                 "accblas.trsv", PHASES),
}


@pytest.mark.parametrize("call", list(CALLS))
def test_public_call_span_tree(call):
    """One span a public call at n = 256, its phases in order inside it
    (the CPU routes launch nothing, so no ``.launch`` span)."""
    fn, top, phases = CALLS[call]
    a, b = _operands()
    out, evs = _profiled(lambda: fn(a, b))
    roots = [e for e in evs if not any(o is not e and _inside(e, o) for o in evs)]
    assert [e[2] for e in roots] == [top]
    assert [e[2] for e in _children(evs, roots[0])] == phases
    kids = _children(evs, roots[0])
    assert all(k0[1] <= k1[0] for k0, k1 in zip(kids, kids[1:]))  # one after the other
    assert len(evs) == 1 + len(phases)


def test_composition_route_has_the_public_span_alone():
    """The blocked composition inherits the public call's span and no
    phase span of the sweep."""
    a, b = _operands()
    _, evs = _profiled(lambda: acc.trsm(a, torch.stack([b, b], 1), resident=True))
    assert [e[2] for e in evs] == ["accblas.trsv"]


def test_cg_span_tree():
    """``accblas.cg`` holds its passes, each with one GEMV and two DOTs, at
    n = 64; a fixed budget (tol = 0) polls never."""
    a, b = _spd(64)
    (x, rs, it), evs = _profiled(lambda: models.cg(a, b, iters=12))
    cg = [e for e in evs if e[2] == "accblas.cg"]
    assert len(cg) == 1 and int(it) == 12
    kids = _children(evs, cg[0])
    passes = [e for e in kids if e[2] == "accblas.cg.pass"]
    assert len(passes) == 12 and not any(e[2] == "accblas.cg.poll" for e in evs)
    # outside the passes, set-up's one DOT: |r0|^2 (tol == 0 takes no |b|^2)
    assert [e[2] for e in kids if e[2] != "accblas.cg.pass"] == ["accblas.dot"]
    for p in passes:
        assert sorted(e[2] for e in _children(evs, p)) == ["accblas.dot", "accblas.dot",
                                                           "accblas.gemv"]


class _HostReads(TorchFunctionMode):
    """Counts the tensor reads back to the host (``bool(live)``)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") == "__bool__":
            self.count += 1
        return func(*args, **(kwargs or {}))


def test_cg_one_pass_span_a_pass_and_one_poll_span_a_poll():
    """At a tol that stops the loop early: a pass span for each loop body
    that ran (one GEMV each), a poll span for each host read, every poll
    between passes."""
    a, b = _spd(64)
    calls = []

    def mv(p):
        calls.append(1)
        return solvers._matvec(a, p, "f32")

    with _HostReads() as spy:
        (x, rs, it), evs = _profiled(lambda: models.cg(a, b, iters=200, tol=1e-5, matvec=mv))
    passes = [e for e in evs if e[2] == "accblas.cg.pass"]
    polls = [e for e in evs if e[2] == "accblas.cg.poll"]
    assert len(passes) == len(calls) < 200 and int(it) <= len(calls)
    assert len(polls) == spy.count == len(calls) // solvers.POLL_EVERY > 0
    assert len(calls) % solvers.POLL_EVERY == 0  # it stopped at a poll
    for q in polls:
        assert not any(_inside(q, p) or _inside(p, q) for p in passes)
    (cg,) = [e for e in evs if e[2] == "accblas.cg"]
    assert all(_inside(e, cg) for e in passes + polls)


def test_every_span_is_a_function_scope_host_event():
    a, b = _operands()
    sa, sb = _spd(64)

    def run():
        acc.acc_dot(b, b, ar="f32")
        acc.acc_gemv(a, b, b, ar="f32")
        acc.trsv(a, b)
        acc.acc_trsv(a, b)
        models.cg(sa, sb, iters=40, tol=1e-5)

    _, evs = _profiled(run)
    names = {e[2] for e in evs}
    assert names >= {"accblas.dot", "accblas.gemv", "accblas.trsv", "accblas.cg",
                     "accblas.cg.pass", "accblas.cg.poll", *PHASES}
    assert not any(e[3] for e in evs), "a user annotation would be copied onto the device"
    assert {e[4] for e in evs} == {0}  # RecordScope::FUNCTION, as the ATen ops


def test_no_profiler_records_nothing_and_keeps_the_bits(monkeypatch):
    """With no profiler running, no recorder is made and a span is the
    shared no-op; the results equal a profiled run's bit for bit."""
    made = []
    real = spans._RecordFunctionFast

    def counting(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(spans, "_RecordFunctionFast", counting)
    a, b = _operands()
    sa, sb = _spd(64)

    def run():
        return [acc.acc_dot(b, b, ar="f32"), acc.acc_gemv(a, b, b, ar="f32"), acc.trsv(a, b),
                acc.acc_trsv(a, b), *models.cg(sa, sb, iters=40, tol=1e-5)]

    plain = run()
    assert made == [] and spans.span("accblas.x") is spans._OFF
    traced, evs = _profiled(run)
    assert len(made) == len(evs) > 0
    assert all(_same(p.float(), t.float()) for p, t in zip(plain, traced))


def test_profile_trace_carries_the_spans(tmp_path):
    """The operator's exporter: its Chrome trace holds the ``accblas.dot``
    span of a CPU ``acc_dot``, a host op, not a user annotation."""
    x = torch.ones(256)
    with bench.profile_trace(str(tmp_path / "t")):
        acc.acc_dot(x, x, ar="f32")
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    found = [e for e in events if e.get("name") == "accblas.dot"]
    assert len(found) == 1 and found[0]["cat"] == "cpu_op" and found[0]["ph"] == "X"


def test_load_counts_its_seconds_once(monkeypatch, tmp_path):
    """A load that does work adds its seconds to ``load_seconds`` and
    records an ``accblas.load`` span; a loaded library adds nothing."""
    lib = tmp_path / "libx.so"
    monkeypatch.setattr(_build, "build", lambda name, defines=(): [lib])
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "load_seconds", 0.0)
    got, evs = _profiled(lambda: _build.load("x"))
    assert got == ("lib", str(lib)) and [e[2] for e in evs] == ["accblas.load"]
    first = _build.load_seconds
    assert first > 0
    _, evs = _profiled(lambda: _build.load("x"))
    assert evs == [] and _build.load_seconds == first
