"""trsv.sweep_host_us: the median over the profiled slices of the host
microseconds inside the port's ``accblas.trsv.sweep`` span (phase 2's
checks, its scratch and output allocations, the launch)."""

from blasbench import port_spans


def read(ctx):
    return port_spans.span_us(ctx.trace, "accblas.trsv.sweep")
