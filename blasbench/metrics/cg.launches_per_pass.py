"""cg.launches_per_pass: kernels on the device a solver pass, over the
profiled slices: the kernel records (copies and sets left out) over the
port's GEMV launches, one a pass, in the same slices."""


# the port's GEMV launch counters, one launch a pass (run.py reads them)
COUNTERS = {"gemv.launches": ("accblas_tpu_torch.ops.gemv", "launches"),
            "gemv.staged_launches": ("accblas_tpu_torch.ops.gemv", "staged_launches")}


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    passes = t.counter("gemv.launches") + t.counter("gemv.staged_launches")
    kernels = t.device_ops(lambda n: not n.startswith(("Memcpy", "Memset")))
    return len(kernels) / passes if passes and kernels else None
