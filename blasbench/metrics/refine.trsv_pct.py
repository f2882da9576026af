"""refine.trsv_pct: the share of the solves' device time, over the profiled
slices, in the triangular solves' kernels (``trsv_sweep`` and
``leaf_phase``), out of every device operation but the host's read-back
copies."""

from blasbench import trace

KERNELS = ("trsv_sweep", "leaf_phase")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    total = t.op_seconds(lambda n: not n.startswith(trace.READBACK))
    tri = t.op_seconds(lambda n: any(k in n for k in KERNELS))
    if total <= 0 or tri <= 0:
        return None
    return 100.0 * tri / total
