"""Shared kernel-layer helpers (counterpart of ``accblas_tpu.ops.common``)."""

from __future__ import annotations

import torch


def pow2_ceil(x: int) -> int:
    """The least power of two >= x (1 for x <= 1)."""
    return 1 << max(x - 1, 0).bit_length()


def route(what: str, *tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda': where an op runs. Every operand must lie on the same
    device: an op runs its plain torch version only for CPU tensors and its
    CUDA kernel only for CUDA tensors, and never moves data between them."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{what}: operands on different devices "
                             f"{sorted({str(u.device) for u in tensors})}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no route for device {dev}")
    return dev.type


def pow2_tree_sum(p: torch.Tensor) -> torch.Tensor:
    """Pairwise sum over the last axis, zero-padded to a power of two, in
    p's own dtype: every level is one elementwise add, so the order of the
    sum is spelled out here."""
    n = p.shape[-1]
    w = pow2_ceil(max(n, 1))
    if w != n:
        p = torch.cat([p, p.new_zeros(tuple(p.shape[:-1]) + (w - n,))], -1)
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        p = p[..., :h] + p[..., h:]
    return p[..., 0]


def tri_mask(d: torch.Tensor, lower: bool, unit: bool, *, n=None, offs=None) -> torch.Tensor:
    """Select the lower/upper triangle of (..., s, s) blocks: zero the dead
    triangle and optionally force a unit diagonal.

    With ``n``/``offs`` (per-block global row offsets against a logical
    size), past-``n`` lanes continue as identity so padded boundary blocks
    solve to x = 0.
    """
    s = d.shape[-1]
    r = torch.arange(s, device=d.device).view(s, 1)
    c = torch.arange(s, device=d.device).view(1, s)
    tri = (r >= c) if lower else (r <= c)
    diag = r == c
    keep = tri.expand(d.shape)
    if offs is not None:
        base = torch.as_tensor(offs, device=d.device).reshape(tuple(offs.shape) + (1, 1))
        keep = keep & ((base + r) < n) & ((base + c) < n)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    one = torch.ones((), dtype=d.dtype, device=d.device)
    d = torch.where(keep, d, zero)
    if unit:
        d = torch.where(diag, one, d)
    elif offs is not None:
        d = torch.where(diag & ((base + r) >= n), one, d)
    return d
