"""api.host_us.<cell>: the median host time inside the public call (the
benchmark's span around it, entry to return), over the window's calls
outside the profiled slices. For ``trsv`` that holds the leaf gather, the
batched inverses, the panel and the sweep's launch."""

from blasbench.readers import host_us as read  # noqa: F401
