"""The port's own spans in a traced run's slices.

The port records its phases as function-scope host events named
``accblas.*`` (``accblas_tpu_torch/utils/spans.py``): each public call and
its launch, the TRSV's phase 1 and sweep, a CG pass and its residual poll.
``trace.make_slice`` keeps them in each slice's ``host`` list, beside the
ATen ops, on the device trace's clock. Spans nest by time on the one host
thread, so a span's children are the port's spans that lie inside it. A
program that records no such span (an older port) gives empty lists here,
and the metrics that read them report nothing.
"""

from __future__ import annotations

import statistics

from . import trace

PREFIX = "accblas."


def events(sl: trace.Slice) -> list:
    """(start, end, name) of the port's spans in slice `sl`, by start."""
    return [h for h in sl.host if h[2].startswith(PREFIX)]


def named(t: trace.Trace | None, name: str) -> list:
    """[(span, the port's spans of its slice)] for each span called `name`
    over the slices of `t`."""
    if t is None:
        return []
    out = []
    for sl in t.slices:
        evs = events(sl)
        out.extend((e, evs) for e in evs if e[2] == name)
    return out


def inside(span, evs: list, names=None) -> list:
    """The spans of `evs` (named one of `names`, if given) that lie within
    `span`, the span itself left out."""
    s, e = span[0], span[1]
    return [x for x in evs if x is not span and s <= x[0] and x[1] <= e
            and (names is None or x[2] in names)]


def self_ns(span, evs: list) -> int:
    """The span's length less the part of it that the port's spans inside
    it cover."""
    return (span[1] - span[0]) - sum(b - a for a, b in trace.merged(inside(span, evs)))


def median_us(values_ns: list) -> float | None:
    return statistics.median(values_ns) / 1e3 if values_ns else None


def span_us(t: trace.Trace | None, name: str) -> float | None:
    """The median length in microseconds of the spans called `name`."""
    return median_us([e - s for (s, e, _), _ in named(t, name)])
