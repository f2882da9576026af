"""Measurement protocol: one warm-up call, then ``BENCH_ITERS`` timed
repetitions, each between two CUDA events on the current stream; the
minimum in milliseconds is the result (``skip=True`` runs once and returns 0).
Counterpart of ``accblas_tpu.utils.bench`` (``benchmark_function``,
``synchronize``, ``Timer``, ``profile_trace``; the reference's
``cuda/utils.cuh:107-262``).

A time of CPU tensors is a host time: ``benchmark_host`` runs the same
protocol on the host clock, and nothing here passes one off as a device
time.
"""

from __future__ import annotations

import os
import time

import torch

BENCH_ITERS = 10  # reference: bench_iters, cuda/utils.cuh:239


def _need_cuda(what: str):
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} times CUDA work and needs a CUDA device")


def synchronize(device=None):
    """Wait for the card's queued work (``synchronize()``,
    ``cuda/utils.cuh:107``); nothing to wait for on the CPU."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        torch.cuda.synchronize(dev)


def benchmark_function(func, skip: bool = False, iters: int = BENCH_ITERS) -> float:
    """Run `func` with the protocol above and return its minimum time in ms.
    Needs a CUDA device: a time taken on the host CPU is not a device time."""
    _need_cuda("benchmark_function")
    func()  # warm-up (and first-use kernel build)
    torch.cuda.synchronize()
    if skip:
        return 0.0
    best = float("inf")
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        func()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best


def benchmark_host(func, skip: bool = False, iters: int = BENCH_ITERS) -> float:
    """The same protocol on the host clock (``time.perf_counter``), for work
    on CPU tensors: the minimum host time in ms, not a device time."""
    func()
    if skip:
        return 0.0
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        func()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


class Timer:
    """Accumulating CUDA-event timer on the current stream, the CudaTimer
    analogue (``cuda/utils.cuh:144-182``): start / stop pairs add up, and
    ``get_time`` synchronises on the last stop and returns the total ms."""

    def __init__(self):
        _need_cuda("Timer")
        self._pairs: list = []
        self._start = None

    def start(self):
        self._start = torch.cuda.Event(enable_timing=True)
        self._start.record()

    def stop(self):
        if self._start is None:
            raise RuntimeError("Timer.stop without a start")
        stop = torch.cuda.Event(enable_timing=True)
        stop.record()
        self._pairs.append((self._start, stop))
        self._start = None

    def reset(self):
        self._pairs.clear()
        self._start = None

    def get_time(self) -> float:
        if self._pairs:
            self._pairs[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in self._pairs)


class profile_trace:
    """Optional profiler hook, the way to see where a call's host time goes:
    wraps a region in ``torch.profiler`` (CPU and, where there is a card,
    CUDA activity) and writes a Chrome trace into `log_dir` on exit when a
    directory is given; a no-op otherwise. The trace carries the port's
    ``accblas.*`` spans (``utils.spans``: each public call and its launch,
    the TRSV's phase 1 and sweep, a CG pass and its residual poll, a
    library's load) as host events on the device trace's clock, beside
    the ATen ops and the kernels they launched."""

    def __init__(self, log_dir=None):
        self.log_dir = log_dir
        self._prof = None

    def __enter__(self):
        if self.log_dir:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if torch.cuda.is_available() else [])
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof.export_chrome_trace(os.path.join(self.log_dir, "trace.json"))
        return False
