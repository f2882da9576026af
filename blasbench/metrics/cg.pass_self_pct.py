"""cg.pass_self_pct: the share of the summed length of the profiled
slices' ``accblas.cg.pass`` spans that is their self time, outside the
port's spans inside them (``accblas.gemv``, ``accblas.dot``): the host
time of the solver's own eager ops."""

from blasbench import port_spans


def read(ctx):
    passes = port_spans.named(ctx.trace, "accblas.cg.pass")
    total = sum(p[1] - p[0] for p, _ in passes)
    if total <= 0:
        return None
    return 100.0 * sum(port_spans.self_ns(p, evs) for p, evs in passes) / total
