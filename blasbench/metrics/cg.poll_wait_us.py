"""cg.poll_wait_us: the median over the profiled slices' solves of the host
microseconds a solve spends inside its ``accblas.cg.poll`` spans, where
the host waits for the device to give the residual flag: near nothing
where the host sets the pace, near a pass's device time or more where the
device does."""

from blasbench import port_spans

POLL = ("accblas.cg.poll",)


def read(ctx):
    solves = [sum(e - s for s, e, _ in port_spans.inside(cg, evs, POLL))
              for cg, evs in port_spans.named(ctx.trace, "accblas.cg")]
    return port_spans.median_us(solves)
