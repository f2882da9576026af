"""What the metric readers compute. One quantity read in cells whose noise
differs is one metric a cell kind, each with its own bound
(``throughput_gbps.dot``, ``throughput_gbps.trsv``); the file of their
family under ``metrics/`` (``throughput_gbps.py``) binds ``read`` to the
function here, and a new cell's metric of the family needs no file."""

from __future__ import annotations

import statistics

from . import roofline, trace


def throughput_gbps(ctx):
    """The op's bytes of every call completed in the window, over the
    window's seconds on the host clock."""
    nbytes = getattr(ctx.driver, "bytes_per_call", None)
    if not nbytes or ctx.window.seconds <= 0:
        return None
    return nbytes * ctx.window.completed() / ctx.window.seconds / 1e9


def p95_ms(ctx):
    """The 95th percentile over all requests of the window of a request's
    time from its issue to the end of what it launched, on the device
    clock (a CUDA event at issue and one after the call returned)."""
    lat = ctx.window.latencies_ms()
    return statistics.quantiles(lat, n=100, method="inclusive")[94] if len(lat) > 1 else None


def host_us(ctx):
    """The median over the window's calls outside the profiled slices of the
    host time inside the public call, entry to return (the benchmark's span
    around the call, on the host clock)."""
    ns = [r.call_ns for r in ctx.window.requests if not r.in_slice]
    return statistics.median(ns) / 1e3 if ns else None


def idle_pct(ctx):
    """The share of the profiled slices in which no operation ran on the
    device: 1 - the union of the device operations' intervals over the
    slices' length."""
    t = ctx.trace
    if t is None or not t.device_ops():
        return None
    share = t.idle_share()
    return None if share is None else 100.0 * share


def call_roofline_pct(ctx):
    """The op's bytes over the peak bandwidth, over the device time of
    everything the call launched (every device operation of the profiled
    slices but the host's read-back copies), a call on average."""
    t = ctx.trace
    if t is None or not ctx.peak_gbps or t.requests() == 0:
        return None
    dev = t.op_seconds(lambda n: not n.startswith(trace.READBACK)) / t.requests()
    if dev <= 0:
        return None
    return 100.0 * roofline.bound_ms(ctx.driver.bytes_per_call, ctx.peak_gbps) / 1e3 / dev
