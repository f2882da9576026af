"""The DOT and the unit upper triangular solve in float64, and the solve in
TF32 as the control that a lower precision has to fail."""

from __future__ import annotations

import contextlib

import torch

from .tf32 import round_tf32


@contextlib.contextmanager
def ieee_f32():
    """f32 matrix products in genuine f32 while inside."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def dot(x: torch.Tensor, y: torch.Tensor, chunk: int = 1 << 25) -> tuple[float, float]:
    """(x·y, Σ|x_i y_i|) in float64 over the stored values, in chunks."""
    tot = torch.zeros((), dtype=torch.float64, device=x.device)
    mag = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], chunk):
        p = x[i: i + chunk].double() * y[i: i + chunk].double()
        tot += p.sum()
        mag += p.abs().sum()
    return float(tot), float(mag)


def unit_upper_solve(a: torch.Tensor, b: torch.Tensor, block: int = 256,
                     prec: str = "f64") -> torch.Tensor:
    """x with (I + U) x = b, U the strict upper triangle of `a` (the stored
    diagonal and lower triangle are not read); b is (n,) or (n, k).

    prec 'f64': back substitution by blocks of rows in float64. prec 'tf32':
    the same blocks in f32 with every product taken on TF32-rounded
    operands (each diagonal block's inverse formed in float64, then
    rounded), as a tensor-core solve would compute."""
    n = a.shape[0]
    vec = b.dim() == 1
    bb = b.reshape(n, -1)
    dt = torch.float64 if prec == "f64" else torch.float32
    x = torch.zeros(bb.shape, dtype=dt, device=a.device)
    with ieee_f32():
        for r0 in reversed(range(0, n, block)):
            r1 = min(n, r0 + block)
            rhs = bb[r0:r1].to(dt)
            t = a[r0:r1, r0:r1].double()
            if prec == "f64":
                if r1 < n:
                    rhs = rhs - a[r0:r1, r1:].double() @ x[r1:]
                x[r0:r1] = torch.linalg.solve_triangular(t, rhs, upper=True, unitriangular=True)
            else:
                if r1 < n:
                    rhs = rhs - round_tf32(a[r0:r1, r1:]) @ round_tf32(x[r1:])
                eye = torch.eye(r1 - r0, dtype=torch.float64, device=a.device)
                inv = torch.linalg.solve_triangular(t, eye, upper=True, unitriangular=True)
                x[r0:r1] = round_tf32(inv.float()) @ round_tf32(rhs)
    return x[:, 0] if vec else x
