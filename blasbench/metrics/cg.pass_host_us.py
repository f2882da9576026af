"""cg.pass_host_us: the median over the profiled slices of the host
microseconds of one ``accblas.cg.pass`` span: a solver pass's GEMV, two
DOTs and its own eager update ops, issued."""

from blasbench import port_spans


def read(ctx):
    return port_spans.span_us(ctx.trace, "accblas.cg.pass")
