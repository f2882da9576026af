"""Measurement protocol: one warm-up call, then ``BENCH_ITERS`` timed
repetitions, each between two CUDA events on the current stream; the
minimum in milliseconds is the result (``skip=True`` runs once and returns 0).
Counterpart of ``accblas_tpu.utils.bench.benchmark_function``.
"""

from __future__ import annotations

import torch

BENCH_ITERS = 10


def benchmark_function(func, skip: bool = False, iters: int = BENCH_ITERS) -> float:
    """Run `func` with the protocol above and return its minimum time in ms.
    Needs a CUDA device: a time taken on the host CPU is not a device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("benchmark_function times CUDA work and needs a CUDA device")
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
