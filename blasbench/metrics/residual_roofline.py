"""residual_roofline: the refinement's residual GEMV with x a DF pair
(``gemv_rows_dfx``) against the peak bandwidth: its bytes (A in f32, x's two
f32 words, b in f32, r's two f32 words) over the peak, over the mean device
time of its kernel records in the profiled slices; their count is held to
the port's launch counter of that kernel over the same slices."""

from blasbench import roofline

# the port's launch counter of gemv_rows_dfx (run.py reads it)
COUNTERS = {"gemv.dfx_launches": ("accblas_tpu_torch.ops.gemv", "dfx_launches")}

KERNEL = "gemv_rows_dfx"


def residual_bytes(n: int) -> int:
    """A read once, x's two words and b read once, r's two words written."""
    return n * n * 4 + n * (8 + 4 + 8)


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.peak_gbps:
        return None
    recs = t.device_ops(lambda name: KERNEL in name)
    if not recs or len(recs) > t.counter("gemv.dfx_launches"):
        return None
    mean_s = sum(e - s for s, e, _ in recs) / len(recs) / 1e9
    n = int(ctx.cell.mix["n"])
    return 100.0 * roofline.bound_ms(residual_bytes(n), ctx.peak_gbps) / 1e3 / mean_s
