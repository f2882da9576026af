"""gemv_roofline: the GEMV's bytes (A and x in the configuration's storage,
the f32 result) over the peak bandwidth, over the mean device time of the
GEMV kernels found by name in the profiled slices of ``cg``; their count
is held to the port's GEMV launch counters over the same slices."""

from blasbench import roofline

# the port's GEMV launch counters, one launch a pass (run.py reads them)
COUNTERS = {"gemv.launches": ("accblas_tpu_torch.ops.gemv", "launches"),
            "gemv.staged_launches": ("accblas_tpu_torch.ops.gemv", "staged_launches")}

KERNELS = ("gemv_rows", "gemv_staged")


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.peak_gbps:
        return None
    recs = t.device_ops(lambda name: any(k in name for k in KERNELS))
    launches = t.counter("gemv.launches") + t.counter("gemv.staged_launches")
    if not recs or len(recs) > launches:
        return None
    n = int(ctx.cell.mix["n"])
    st = ctx.cell.config["cg"]["storage"]
    mean_s = sum(e - s for s, e, _ in recs) / len(recs) / 1e9
    return 100.0 * roofline.bound_ms(roofline.gemv_bytes(n, n, st, st, "f32"), ctx.peak_gbps) \
        / 1e3 / mean_s
