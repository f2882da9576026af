"""CG requests: ``models.solvers.cg`` on a dense SPD system to a stated
residual, the iteration count read on the host.

A = CᵀC/n + ridge·I with C uniform(-1, 1) from the seed, the product in
genuine f32 (TF32 off), then stored as the configuration says; the
right-hand sides come from a pool of the mix's ``pool`` vectors
uniform(-1, 1). A solve fails when it has not reached the tolerance within
``max_iters`` or broke down. Every solve's x is kept and compared with the
float64 recurrence (``reference.cg``) of its right-hand side by
|x - ref|_2 / |ref|_2 (``x_gap``). The control is the program's own
narrower arithmetic (``control_arithmetic``).
"""

from __future__ import annotations

import math

from .. import draw
from ..reference import cg as ref
from ..reference.blas import ieee_f32


class Driver:
    kind = "solve"
    bytes_per_call = None

    def __init__(self, config: dict, mix: dict, seed: int, device, variant: str = "program"):
        from accblas_tpu_torch.models import solvers

        self.cg = solvers.cg
        c = config["cg"]
        n, pool = int(mix["n"]), int(mix["pool"])
        self.storage = draw.DTYPE[c["storage"]]
        self.ar = c["arithmetic"] if variant == "program" else c["control_arithmetic"]
        self.tol, self.max_iters = float(c["tol"]), int(c["max_iters"])
        g = draw.generator(seed, device)
        m = draw.uniform(g, (n, n))
        with ieee_f32():
            a = (m.T @ m).div_(n)
        del m
        a.diagonal().add_(float(c["ridge"]))
        self.a = a.to(self.storage)
        del a
        self.b = draw.uniform(g, (pool, n))

    def pick(self, rng):
        return rng.randrange(self.b.shape[0])

    def call(self, key):
        return self.cg(self.a, self.b[key], iters=self.max_iters, ar=self.ar, tol=self.tol)

    def read(self, key, out, keep):
        x, rs, it = out
        it, rs = int(it), float(rs)
        ok = it < self.max_iters and math.isfinite(rs)
        return ok, ((x, it) if keep is not None else None)

    def check(self, answers) -> dict:
        keys = sorted({k for k, _ in answers})
        xs, _ = ref.solve(self.a, self.b[keys].T, self.tol, self.max_iters, self.storage)
        col = {k: xs[:, i] for i, k in enumerate(keys)}
        return {"x_gap": max(float((x.double() - col[k]).norm() / col[k].norm())
                             for k, (x, _) in answers)}
