"""solve_ms_p95: the 95th percentile over all solves of the window, start to
the solver's return (before the host reads the iteration count), on CUDA
events."""

from blasbench.readers import p95_ms as read  # noqa: F401
