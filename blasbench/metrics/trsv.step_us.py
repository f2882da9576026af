"""trsv.step_us: the mean device microseconds of one hop of the TRSV sweep's
chain: the ``trsv_sweep`` records' device time in the profiled slices over
the sweep steps (block rows times panels of right-hand sides) launched in
them. The profiler drops a record now and then, so the steps are those of
the launches that left a record: the port's step counter over the slices,
times the records over the port's sweep launches, and more records than
launches reads nothing (as ``gemv_roofline`` holds its records to its
counters)."""

import sys

_PORT = "accblas_tpu_torch.ops.trsv"
KERNEL = "trsv_sweep"

# the port's sweep counters (run.py reads them); a port that does not count
# its steps, as before it did, declares its launches alone, and the metric
# then reads nothing
COUNTERS = {"trsv.sweep_launches": (_PORT, "sweep_launches")}
if hasattr(sys.modules.get(_PORT), "sweep_steps"):
    COUNTERS["trsv.sweep_steps"] = (_PORT, "sweep_steps")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    recs = t.device_ops(lambda name: KERNEL in name)
    launches, steps = t.counter("trsv.sweep_launches"), t.counter("trsv.sweep_steps")
    if not recs or not steps or len(recs) > launches:
        return None
    seconds = sum(e - s for s, e, _ in recs) / 1e9
    return 1e6 * seconds / (steps * len(recs) / launches)
