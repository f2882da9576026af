"""Inputs from the seed, made on the device in a few large calls.

The benchmark draws its own operands with a ``torch.Generator`` on the
run's device; the system under test receives only the tensors. The order
of the requests is drawn on the host from the same seed.
"""

from __future__ import annotations

import random

import torch

# the storage names of a configuration, as torch dtypes
DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(seed % 2**64)
    return g


def uniform(g: torch.Generator, shape, lo: float = -1.0, hi: float = 1.0) -> torch.Tensor:
    """f32 uniform on [lo, hi) on g's device."""
    t = torch.rand(shape, generator=g, device=g.device, dtype=torch.float32)
    return t.mul_(hi - lo).add_(lo)


def order(seed: int, stream: str) -> random.Random:
    """A host stream of choices for `stream` ('requests', 'keep', ...),
    the same for the same seed."""
    return random.Random(f"{seed}/{stream}")
