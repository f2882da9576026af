"""Refinement requests: ``models.solvers.lu_refine`` on one dense system
factored once, one right-hand side a request, solved to HPL's scaled
residual, the result read on the host.

Set-up, untimed, once: A (n, n) f32 from the seed, uniform(-0.5, 0.5) off
the diagonal and each diagonal entry the sum of |a_ij| over the other
entries of its row, so diagonally dominant by rows; factored once by
``torch.linalg.lu_factor`` in genuine f32 (TF32 off), which fails the
set-up unless its pivots are the identity; the packed factors are then
stored in the configuration's ``factor_storage`` and the f32 factor freed.
||A||_inf is taken once, in float64. The right-hand sides come from a pool
of the mix's ``pool`` vectors uniform(-1, 1).

A solve fails unless its scaled residual met the check's ``hpl_resid``
limit (HPL's 16) within ``max_steps`` with finite values. Every solve's x is kept, on the host, and held to the float64 reference
(``reference.refine``): HPL's scaled residual against the stored A
(``hpl_resid``), and max |x - x_ref|_inf / |x_ref|_inf (``x_gap``), x_ref
refined in float64 on the stored factors. The control is the program's own
narrower arithmetic (``control_arithmetic``: x and the residual in f32).
"""

from __future__ import annotations

import math

import torch

from .. import draw
from ..reference import refine as ref
from ..reference.blas import ieee_f32


def dominant_system(g: torch.Generator, n: int) -> torch.Tensor:
    """A (n, n) f32 on g's device: uniform(-0.5, 0.5) off the diagonal, each
    diagonal entry the sum of |a_ij| over its row's other entries."""
    a = draw.uniform(g, (n, n), -0.5, 0.5)
    d = a.diagonal()
    d.zero_()
    rows = max(1, (1 << 26) // n)
    for r in range(0, n, rows):
        d[r:r + rows] = a[r:r + rows].abs().sum(1)
    return a


def factor(a: torch.Tensor, storage: torch.dtype) -> torch.Tensor:
    """The packed L\\U factors of `a` in `storage`, row-major, formed in
    genuine f32; raises unless partial pivoting left every row in place."""
    with ieee_f32():
        lu, piv = torch.linalg.lu_factor(a)
    n = a.shape[0]
    if not torch.equal(piv, torch.arange(1, n + 1, dtype=piv.dtype, device=piv.device)):
        raise RuntimeError("lu_factor pivoted: the system is not diagonally dominant enough "
                           "to be factored without pivoting")
    del piv
    # lu_factor returns the factors column-major; the sweeps read them by rows
    out = lu.to(storage, memory_format=torch.contiguous_format)
    del lu
    return out


def _value(x, device) -> torch.Tensor:
    """A kept x, its (hi, lo) words, as float64 on `device`."""
    hi, lo = x
    return hi.to(device).double() + lo.to(device).double()


class Driver:
    kind = "solve"
    bytes_per_call = None

    def __init__(self, config: dict, mix: dict, seed: int, device, variant: str = "program"):
        # first, so that a port without the solver fails here before any draw
        from accblas_tpu_torch.models.solvers import lu_refine

        self.lu_refine = lu_refine
        c = config["refine"]
        n, pool = int(mix["n"]), int(mix["pool"])
        self.ar = c["arithmetic"] if variant == "program" else c["control_arithmetic"]
        self.limit, self.max_steps = float(c["check"]["hpl_resid"]), int(c["max_steps"])
        g = draw.generator(seed, device)
        self.a = dominant_system(g, n)
        self.lu = factor(self.a, draw.DTYPE[c["factor_storage"]])
        self.anorm = ref.inf_norm(self.a)
        self.b = draw.uniform(g, (pool, n))

    def pick(self, rng):
        return rng.randrange(self.b.shape[0])

    def call(self, key):
        return self.lu_refine(self.lu, self.a, self.b[key], ar=self.ar,
                              max_steps=self.max_steps, anorm=self.anorm)

    def read(self, key, out, keep):
        x, resid, steps = out
        resid = float(resid)
        ok = (resid <= self.limit and steps <= self.max_steps and math.isfinite(resid)
              and bool(torch.isfinite(x.hi).all() & torch.isfinite(x.lo).all()))
        # kept on the host: a window's worth of x on the card would grow the
        # device's pool through the window, a cudaMalloc every few solves
        return ok, ((x.hi.cpu(), x.lo.cpu()) if keep is not None else None)

    def check(self, answers) -> dict:
        keys = sorted({k for k, _ in answers})
        xs = ref.solve(self.a, self.lu, self.b[keys].T)
        col = {k: xs[:, i] for i, k in enumerate(keys)}
        dev = xs.device
        gap = max(float((_value(x, dev) - col[k]).abs().max() / col[k].abs().max())
                  for k, x in answers)
        del xs, col
        # the scaled residuals a block of answers at a time
        resid = 0.0
        for i in range(0, len(answers), 64):
            part = answers[i:i + 64]
            x = torch.stack([_value(w, dev) for _, w in part], 1)
            b = self.b[[k for k, _ in part]].T
            resid = max(resid, float(ref.hpl_resid(self.a, x, b, self.anorm).max()))
        return {"hpl_resid": resid, "x_gap": gap}
