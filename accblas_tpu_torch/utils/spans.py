"""Spans of the port's host time, on the profiler's clock.

``span(name)`` is a context manager around one phase of a call: the public
op, its launch, the TRSV's phase 1 and sweep, a CG pass and its residual
poll, a refinement solve, its steps and its flag's poll, a library's load. While a ``torch.profiler.profile`` runs (the
benchmark's traced slices, or ``utils.bench.profile_trace``), each span is
a host event of that name, at function scope beside the ATen ops and on the
clock of the device's trace; otherwise it is a shared no-op object, and
costs the flag test. Spans nest by time on the host thread that makes
them, which is their parent link. Every name starts with ``accblas.``.

The recorder is torch's function-scope ``_RecordFunctionFast``, not
``torch.profiler.record_function``: a ``record_function`` range is a user
annotation, which the profiler copies onto the device's timeline around
every kernel it encloses, where it would read as device work.
"""

from __future__ import annotations

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast


class _Off:
    """The span while no profiler runs: enters and exits, records nothing
    (cheaper than ``contextlib.nullcontext`` and than an idle recorder)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def span(name: str):
    """A context manager recording `name` as a function-scope host event
    while a profiler runs, else the shared no-op (no tensor, no CUDA call)."""
    return _RecordFunctionFast(name) if _profiler._is_profiler_enabled else _OFF
