"""The profiler's trace of a run's slices, reduced to what the metrics read.

The traced run profiles a few bounded slices of its window
(``torch.profiler`` with CPU and CUDA activities), each wrapped in a
``blasbench.slice`` span. From each it keeps the device's operations
(kernels, copies, sets: name, start, end) and the host's events (the
benchmark's own ``blasbench.*`` spans, the ATen ops and the CUDA runtime
calls), all on the profiler's one clock in nanoseconds.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

SLICE = "blasbench.slice"
SPAN_PREFIX = "blasbench."
# the host reads a result back by this copy; it is the benchmark's, not the op's
READBACK = "Memcpy DtoH"


@dataclass
class Slice:
    t0: int  # ns, the slice span's bounds
    t1: int
    device: list  # (start, end, name), sorted by start
    host: list  # (start, end, name) of ATen ops and runtime calls, sorted by start
    spans: list  # (start, end, name) of the benchmark's spans but the slice's
    requests: int = 0  # requests the slice holds
    counters: dict = field(default_factory=dict)  # the port's counters' growth over it


def events(prof) -> tuple[list, list]:
    """(host, device) events of a finished ``torch.profiler.profile``, each
    (start, end, name) in ns, sorted by start."""
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        rec = (start, start + e.duration_ns(), e.name())
        on_host = e.device_type().name == "CPU"
        if not on_host and rec[2].startswith(SPAN_PREFIX):
            continue  # the profiler's copy of a benchmark span on the device's timeline
        (host if on_host else device).append(rec)
    host.sort()
    device.sort()
    return host, device


def make_slice(prof, requests: int, counters: dict) -> Slice:
    host, device = events(prof)
    spans = [h for h in host if h[2] == SLICE]
    if spans:
        t0, t1 = spans[0][0], spans[0][1]
    else:  # no span recorded: the extent of what was
        allev = host + device
        t0, t1 = min(e[0] for e in allev), max(e[1] for e in allev)
    clip = [(max(s, t0), min(e, t1), n) for s, e, n in device if e > t0 and s < t1]
    ours = [h for h in host if h[2].startswith(SPAN_PREFIX) and h[2] != SLICE]
    rest = [h for h in host if not h[2].startswith(SPAN_PREFIX)]
    return Slice(t0, t1, clip, rest, ours, requests, counters)


def merged(intervals) -> list:
    """The union of (start, end, ...) intervals as sorted disjoint (start, end)."""
    out: list = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """The slices of one traced run."""

    def __init__(self, slices: list[Slice]):
        self.slices = slices

    def window_s(self) -> float:
        return sum(s.t1 - s.t0 for s in self.slices) / 1e9

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for sl in self.slices for s, e in merged(sl.device)) / 1e9

    def idle_share(self) -> float | None:
        w = self.window_s()
        return None if w <= 0 else 1.0 - self.busy_s() / w

    def requests(self) -> int:
        return sum(s.requests for s in self.slices)

    def counter(self, name: str) -> int:
        return sum(s.counters.get(name, 0) for s in self.slices)

    def device_ops(self, keep=lambda name: True) -> list:
        """(start, end, name) of the device operations for which keep(name)."""
        return [d for s in self.slices for d in s.device if keep(d[2])]

    def op_seconds(self, keep=lambda name: True) -> float:
        return sum(e - s for s, e, _ in self.device_ops(keep)) / 1e9

    def top_device_ops(self, k: int = 10) -> list:
        """[name, seconds] of the k device operations that took most time."""
        tot: dict = defaultdict(int)
        for s, e, n in self.device_ops():
            tot[n] += e - s
        return [[_short(n), v / 1e9] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """[what the host was doing, seconds]: the device's idle time in the
        slices, summed by the host's innermost event at each gap's middle
        (prefixed by the innermost benchmark span), the k largest."""
        tot: dict = defaultdict(int)
        for sl in self.slices:
            busy = merged(sl.device)
            edges = [sl.t0] + [x for iv in busy for x in iv] + [sl.t1]
            starts = [h[0] for h in sl.host]
            span_starts = [h[0] for h in sl.spans]
            for a, b in zip(edges[::2], edges[1::2]):
                if b > a:
                    t = (a + b) // 2
                    span = _innermost(sl.spans, span_starts, t)
                    op = _innermost(sl.host, starts, t)
                    head = span[len(SPAN_PREFIX):] if span else "outside requests"
                    tot[f"{head}: {_short(op) if op else 'python'}"] += b - a
        return [[n, v / 1e9] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def _innermost(events: list, starts: list, t: int, depth: int = 256) -> str | None:
    """The name of the latest-starting event of `events` (sorted by start)
    that covers time t, looking back `depth` events at most."""
    i = bisect.bisect_right(starts, t) - 1
    for k in range(i, max(-1, i - depth), -1):
        if events[k][1] >= t:
            return events[k][2]
    return None


def _short(name: str, width: int = 160) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."
