"""Conjugate gradients in float64: the recurrence the program runs, without
its rounding.

x0 = 0, r0 = p0 = b; each iteration takes Ap, alpha = |r|²/(p·Ap), x +=
alpha p, r -= alpha Ap, beta = |r_new|²/|r|², p = r + beta p, and stops
once |r|² <= tol²·|b|² or after max_iters. The operator is the stored A
read as float64, and p is rounded to the storage of the product's vector
before each product (the configuration stores the GEMV's x as A is
stored); everything else is float64.
"""

from __future__ import annotations

import torch


def solve(a: torch.Tensor, b: torch.Tensor, tol: float, max_iters: int,
          p_storage: torch.dtype | None) -> tuple[torch.Tensor, torch.Tensor]:
    """(x, iterations) for each column of b (n, k) at once, each column
    stopping on its own."""
    a64 = a.double()
    bd = b.double()
    x = torch.zeros_like(bd)
    r, p = bd.clone(), bd.clone()
    rs = (r * r).sum(0)
    tol2 = tol * tol * rs
    it = torch.zeros(bd.shape[1], dtype=torch.int64, device=bd.device)
    for _ in range(max_iters):
        live = rs > tol2
        if not bool(live.any()):
            break
        pq = p if p_storage is None else p.to(p_storage).double()
        ap = a64 @ pq
        alpha = rs / (p * ap).sum(0)
        x = torch.where(live, x + alpha * p, x)
        r_new = r - alpha * ap
        rs_new = (r_new * r_new).sum(0)
        p = torch.where(live, r_new + (rs_new / rs) * p, p)
        r = torch.where(live, r_new, r)
        rs = torch.where(live, rs_new, rs)
        it += live.long()
    return x, it
