"""TF32: an f32 rounded to nearest (ties to even) at 10 stored mantissa
bits, the input precision of the tensor cores' f32 products. A product of
two such values is exact in f32, so rounding both operands and multiplying
in f32 is what a TF32 product computes."""

from __future__ import annotations

import torch

_DROP = 13  # 23 - 10 mantissa bits


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Finite f32 values rounded to TF32, as f32."""
    i = t.float().contiguous().view(torch.int32)
    sign = i & torch.iinfo(torch.int32).min
    mag = i & 0x7FFFFFFF
    half = (1 << (_DROP - 1)) - 1
    mag = (mag + half + ((mag >> _DROP) & 1)) & ~((1 << _DROP) - 1)
    return (mag | sign).view(torch.float32)
