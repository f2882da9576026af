"""Benchmark data generated on the device from a seed.

Copying GiB-scale operands from the host costs more than generating them,
so the f32 storage copy is drawn on the device itself: uniform(-1, 1) from a
``torch.Generator`` on that device, seeded from (seed, role). Role tags keep
the streams of different operands disjoint. Narrower storage copies derive
from the f32 copy by a cast.

Unlike ``accblas_tpu.utils.devgen`` this stream is not replayed bit for bit
on the host: a float64 oracle is computed from the stored values on the
device instead.
"""

from __future__ import annotations

import zlib

import torch

# the same role ids as the JAX package's benchmark scripts
ROLES = {"dot_x": 0, "dot_y": 1, "gemv_a": 2, "gemv_x": 3, "gemv_res": 4,
         "trsv_b": 5, "sr": 6}


def _stream_seed(seed: int, role: str) -> int:
    """A 32-bit generator seed from (seed, role): the CPU generator keys on
    32 bits only. crc32 is stable across processes (unlike hash())."""
    rid = ROLES.get(role, role)
    return zlib.crc32(f"{int(seed)}/{rid}".encode())


def gen_f32(shape, seed: int = 42, role: str = "dot_x", device="cpu") -> torch.Tensor:
    """uniform(-1, 1) float32 tensor of `shape`, generated on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(_stream_seed(seed, role))
    u = torch.rand(shape, generator=g, dtype=torch.float32, device=device)
    return u.mul_(2.0).sub_(1.0)
