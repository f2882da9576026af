"""HPL's scaled residual and the float64 solution of a system factored once,
in plain float64 torch on the run's device, a block of rows at a time, so
that no float64 copy of A or of its factors is made beside the driver's
state.

The system is the stored A (f32) and the stored packed factors L\\U (L unit
lower, in their storage); both are widened to float64 a block of rows at a
time. The solution is refined in float64 on those factors until its
correction stops shrinking: with the factors of a diagonally dominant A,
each step contracts the error by about the factors' storage precision, so
a few steps reach float64's.
"""

from __future__ import annotations

import torch

# rows of a block: 2048 x 65536 float64 values are 1 GiB
ROWS = 2048
# HPL's unit roundoff: double precision's
EPS = 2.0**-53


def _blocks(n: int, rows: int = ROWS):
    return [(r, min(n, r + rows)) for r in range(0, n, rows)]


def inf_norm(a: torch.Tensor) -> torch.Tensor:
    """||A||_inf in float64, a 0-d tensor on a's device."""
    return torch.stack([a[r0:r1].abs().sum(1, dtype=torch.float64).max()
                        for r0, r1 in _blocks(a.shape[0])]).max()


def residual(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b - A x in float64 for x and b of shape (n, k)."""
    r = b.to(torch.float64, copy=True)
    for r0, r1 in _blocks(a.shape[0]):
        r[r0:r1] -= a[r0:r1].double() @ x
    return r


def hpl_resid(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
              anorm: torch.Tensor | None = None) -> torch.Tensor:
    """HPL's scaled residual of each column of x (n, k) against b (n, k):
    ||b - A x||_inf / ((||A||_inf ||x||_inf + ||b||_inf) n eps), in
    float64, as a (k,) tensor."""
    n = a.shape[0]
    anorm = inf_norm(a) if anorm is None else anorm
    x = x.double()
    r = residual(a, x, b)
    den = (anorm * x.abs().amax(0) + b.double().abs().amax(0)) * n * EPS
    return r.abs().amax(0) / den


def lu_solve(lu: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """U^-1 L^-1 b in float64 for b (n, k), by blocks of rows: each block's
    right-hand side less the product of its panel with the rows solved,
    then its diagonal block solved (L's unit lower triangle, U's upper; the
    other triangle is not read)."""
    n = lu.shape[0]
    blocks = _blocks(n)
    y = torch.empty(b.shape, dtype=torch.float64, device=b.device)
    for r0, r1 in blocks:
        rhs = b[r0:r1].double()
        if r0:
            rhs = rhs - lu[r0:r1, :r0].double() @ y[:r0]
        y[r0:r1] = torch.linalg.solve_triangular(lu[r0:r1, r0:r1].double(), rhs, upper=False,
                                                 unitriangular=True)
    x = torch.empty_like(y)
    for r0, r1 in reversed(blocks):
        rhs = y[r0:r1]
        if r1 < n:
            rhs = rhs - lu[r0:r1, r1:].double() @ x[r1:]
        x[r0:r1] = torch.linalg.solve_triangular(lu[r0:r1, r0:r1].double(), rhs, upper=True)
    return x


def solve(a: torch.Tensor, lu: torch.Tensor, b: torch.Tensor, max_steps: int = 100):
    """The float64 solution of A x = b for each column of b (n, k):
    x = U^-1 L^-1 b, then x += U^-1 L^-1 (b - A x) while the largest
    correction still shrinks (at most `max_steps` steps)."""
    x = lu_solve(lu, b)
    last = float("inf")
    for _ in range(max_steps):
        d = lu_solve(lu, residual(a, x, b))
        size = float(d.abs().max())
        if size >= last:
            break
        x += d
        last = size
        if size == 0.0:
            break
    return x
