"""refine.step_host_us: the median over the profiled slices of the host
microseconds of one ``accblas.refine.step`` span: a refinement step's two
triangular solves, the update of x, the df64 residual and the stop flag,
issued (the host's read of the flag lies outside it)."""

from blasbench import port_spans


def read(ctx):
    return port_spans.span_us(ctx.trace, "accblas.refine.step")
