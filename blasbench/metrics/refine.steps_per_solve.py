"""refine.steps_per_solve: the refinement steps a solve over the window, read
from the solver's own counter (``models.solvers.refine_steps``, one a
correction: the first solve through the factors is not a step)."""

# the solver's step counter (run.py reads it)
COUNTERS = {"refine_steps": ("accblas_tpu_torch.models.solvers", "refine_steps")}


def read(ctx):
    w = ctx.window
    if not w.requests or "refine_steps" not in w.counters:
        return None
    return w.counters["refine_steps"] / len(w.requests)
