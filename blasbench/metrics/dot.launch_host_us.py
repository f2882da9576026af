"""dot.launch_host_us: the median over the profiled slices of the host
microseconds inside the port's ``accblas.dot.launch`` span (the contiguity
check, the result's allocation, the library's entry, the scratch, the
stream and the ctypes call)."""

from blasbench import port_spans


def read(ctx):
    return port_spans.span_us(ctx.trace, "accblas.dot.launch")
