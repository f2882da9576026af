"""call_ms_p95.<cell>: the 95th percentile over all calls of the window, issue
to the end of what the call launched, on CUDA events."""

from blasbench.readers import p95_ms as read  # noqa: F401
