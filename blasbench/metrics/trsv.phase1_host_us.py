"""trsv.phase1_host_us: the median over the profiled slices' ``trsv`` calls
of the host microseconds inside the port's phase-1 spans of the call
(``accblas.trsv.leaf_gather``, ``.leaf_inverse`` and ``.panels``)."""

from blasbench import port_spans

PHASE1 = ("accblas.trsv.leaf_gather", "accblas.trsv.leaf_inverse", "accblas.trsv.panels")


def read(ctx):
    calls = [sum(e - s for s, e, _ in port_spans.inside(call, evs, PHASE1))
             for call, evs in port_spans.named(ctx.trace, "accblas.trsv")]
    return port_spans.median_us([ns for ns in calls if ns > 0])
