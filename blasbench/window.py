"""The measured window: one client in a closed loop.

The client issues a request, reads its result on the host, and only then
issues the next, for the given seconds (a numerical code calling the
library in sequence). Each request's latency is taken on the device's
clock by a CUDA event recorded on the stream at issue and one recorded
after the call has returned, read once the host's read has waited for
both; the host's clock around a sub-millisecond call would carry its own
jitter. Rates take
the host's clock over the whole window. The host time inside the public
call is kept per request.

With tracing on, the window profiles a few bounded slices of itself and
wraps each request's phases in ``blasbench.*`` spans.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

from . import trace as tr


class _Clock:
    """Stamps at a request's issue and after its call: a pair of CUDA events
    on the current stream, reused (the read that follows the call waits for
    both), or the host's clock where there is no device (a CPU run)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if self.cuda \
            else None
        self.t = [0.0, 0.0]

    def stamp(self, i: int):
        if self.cuda:
            self.events[i].record()
        else:
            self.t[i] = time.perf_counter()

    def elapsed_ms(self) -> float:
        if self.cuda:
            return self.events[0].elapsed_time(self.events[1])
        return (self.t[1] - self.t[0]) * 1e3


@dataclass(slots=True)
class Request:
    key: object  # the driver's choice of inputs
    ok: bool  # completed without failure
    call_ns: int  # host time inside the public call
    latency_ms: float  # from the stamp at issue to the one after the call
    in_slice: bool


@dataclass
class Window:
    seconds: float = 0.0  # host clock, first issue to last result
    requests: list = field(default_factory=list)
    answers: list = field(default_factory=list)  # (key, answer) the driver kept
    slices: list = field(default_factory=list)  # (profile, requests, counters' growth)
    counters: dict = field(default_factory=dict)  # the port's counters' growth

    def latencies_ms(self) -> list:
        return [r.latency_ms for r in self.requests]

    def completed(self, ok_only: bool = False) -> int:
        return sum(1 for r in self.requests if r.ok or not ok_only)


def _span(on: bool, name: str):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class _Slicer:
    """Profiles one bounded slice of the window at a time."""

    def __init__(self, device, counters, size: int):
        self.acts = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self.counters, self.size = counters, size
        self.prof = None

    def warm(self, request):
        """Start and stop the profiler once around `request()`: its first
        start initialises the tracer for seconds, which belongs to set-up."""
        with torch.profiler.profile(activities=self.acts):
            request()

    @property
    def active(self) -> bool:
        return self.prof is not None

    def start(self):
        self.prof = torch.profiler.profile(activities=self.acts)
        self.prof.__enter__()
        self.span = torch.profiler.record_function(tr.SLICE)
        self.span.__enter__()
        self.at, self.n = self.counters(), 0

    def count(self, out: list):
        self.n += 1
        if self.n == self.size:
            self.stop(out)

    def stop(self, out: list):
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        now = self.counters()
        out.append((self.prof, self.n, {k: now[k] - self.at[k] for k in now}))
        self.prof = None


def make_slicer(device, counters, traced: bool, slice_requests: int):
    """The profiler of a traced window's slices, None untraced."""
    return _Slicer(device, counters, slice_requests) if traced and slice_requests > 0 else None


# where the traced run's slices start, as fractions of the window
SLICE_AT = (0.2, 0.5, 0.8)


def run(driver, seconds: float, requests, keep, counters, device, slicer=None) -> Window:
    """Drive `driver` for `seconds`. `requests` and `keep` are the seed's
    host streams of choices; `counters()` reads the port's counters. With a
    `slicer` (``make_slicer``, warmed), profile its number of requests from
    each of SLICE_AT on."""
    w = Window()
    before = counters()
    traced = slicer is not None
    todo = list(SLICE_AT) if traced else []
    clock = _Clock(device)
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if todo and not slicer.active and now >= t_start + todo[0] * seconds:
            todo.pop(0)
            slicer.start()
        key = driver.pick(requests)
        with _span(traced, "blasbench.request"):
            clock.stamp(0)
            with _span(traced, "blasbench.call"):
                h0 = time.perf_counter_ns()
                out = driver.call(key)
                h1 = time.perf_counter_ns()
            clock.stamp(1)
            with _span(traced, "blasbench.read"):
                ok, answer = driver.read(key, out, keep)
        del out
        sliced = traced and slicer.active
        w.requests.append(Request(key, ok, h1 - h0, clock.elapsed_ms(), sliced))
        if answer is not None:
            w.answers.append((key, answer))
        if sliced:
            slicer.count(w.slices)
    if traced and slicer.active:  # the window closed inside a slice
        slicer.stop(w.slices)
    w.seconds = time.perf_counter() - t_start
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    after = counters()
    w.counters = {k: after[k] - before.get(k, 0) for k in after}
    return w


def reduce_slices(w: Window) -> tr.Trace:
    """The window's profiled slices as a Trace (parsed after the window)."""
    return tr.Trace([tr.make_slice(p, n, c) for p, n, c in w.slices])
