"""Carry numpy arrays (the JAX package's data) into tensors bit for bit.

``torch.from_numpy`` refuses the ml_dtypes types numpy uses for bf16 and f8,
so those arrays cross through a same-width unsigned-integer view and are
reinterpreted on the torch side. This is how tests hand identical bits to
both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..accessor import dtypes

# storage name -> same-width integer type that carries the bits across
_CARRIER = {"bf16": np.int16, "f8e4m3": np.uint8, "f8e5m2": np.uint8}


def from_numpy(arr: np.ndarray, st=None, device="cpu") -> torch.Tensor:
    """Tensor with the same bits as `arr` (f64/f32/f16/bf16/f8 numpy array),
    on `device`. With `st` the tensor is then cast to that storage type by
    torch (round to nearest even)."""
    arr = np.ascontiguousarray(arr)
    name = dtypes.canon(arr.dtype.name)
    if name in _CARRIER:
        t = torch.from_numpy(arr.view(_CARRIER[name])).view(dtypes.torch_dtype(name))
    else:
        t = torch.from_numpy(arr)
    t = t.to(device)
    return t if st is None else t.to(dtypes.torch_dtype(st))
