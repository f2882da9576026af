"""trsv.leaf_phase_pct: the share of the ``trsv`` calls' device time outside
the sweep kernel (the leaf gather, the batched leaf inverses, the
right-hand side panel, the counter set), over the profiled slices."""

from blasbench import trace

SWEEP = "trsv_sweep"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    total = t.op_seconds(lambda n: not n.startswith(trace.READBACK))
    sweep = t.op_seconds(lambda n: SWEEP in n)
    if total <= 0 or sweep <= 0:
        return None
    return 100.0 * (total - sweep) / total
