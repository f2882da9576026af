"""cg.passes_per_solve: the solver's passes a solve over the window, one
GEMV launch a pass, read from the port's GEMV launch counters (cg polls
its residual every 16 passes, so passes round its iterations up)."""


# the port's GEMV launch counters, one launch a pass (run.py reads them)
COUNTERS = {"gemv.launches": ("accblas_tpu_torch.ops.gemv", "launches"),
            "gemv.staged_launches": ("accblas_tpu_torch.ops.gemv", "staged_launches")}


def read(ctx):
    w = ctx.window
    passes = w.counters.get("gemv.launches", 0) + w.counters.get("gemv.staged_launches", 0)
    return passes / len(w.requests) if w.requests and passes else None
