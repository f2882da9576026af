"""Stochastic-rounding precision converters (counterpart of
``accblas_tpu.utils.sr``).

The f8 storage tiers sit far enough below the master precision that
round-to-nearest conversion leaves a biased per-element error (up to half
of an e4m3 gap, ~3% relative), which accumulates coherently in long dots.
Stochastic rounding (SR) makes the conversion error zero-mean, so the error
of a dot over SR-converted storage grows like sqrt(n) instead of n.

Definition: for x between representable neighbours c <= x <= u,
SR(x) = u with probability (x - c)/(u - c), else c;  E[SR(x)] = x exactly.

Implementation: a correctly rounded cast first, then a step of the IEEE bit
pattern one unit toward the residual's side through a monotone total-order
key (sign-magnitude -> lexicographic), taken with probability
|residual| / gap. Works for f8e4m3 / f8e5m2 / bf16 / f16. ``sr_round`` is
the numpy version (a copy of the JAX package's); ``sr_round_device`` the
torch one, with uniforms from an explicit ``torch.Generator``. The host
version computes the probability in f64 and the torch one in f32, so a host
replay with the same uniforms is statistically identical, not bit-exact
(elements whose uniform lands within ~1 f32 ulp of the threshold can round
to the other neighbour).
"""

from __future__ import annotations

import numpy as np
import torch

from ..accessor import dtypes


def np_dtype(st):
    """The numpy dtype of storage type `st` (ml_dtypes for bf16 and f8)."""
    import ml_dtypes

    return np.dtype({"f64": np.float64, "f32": np.float32, "f16": np.float16,
                     "bf16": ml_dtypes.bfloat16, "f8e4m3": ml_dtypes.float8_e4m3fn,
                     "f8e5m2": ml_dtypes.float8_e5m2}[dtypes.canon(st)])


def _uint_t(nbytes: int):
    return {1: np.uint8, 2: np.uint16}[nbytes]


def _monotone_np(bits: np.ndarray, nbits: int) -> np.ndarray:
    """IEEE bit pattern -> monotone unsigned key (int64 work dtype)."""
    b = bits.astype(np.int64)
    sign = 1 << (nbits - 1)
    mask = (1 << nbits) - 1
    return np.where(b & sign, mask - b, b | sign)


def _from_monotone_np(key: np.ndarray, nbits: int) -> np.ndarray:
    sign = 1 << (nbits - 1)
    mask = (1 << nbits) - 1
    return np.where(key & sign, key & ~sign & mask, mask - key).astype(np.int64)


def sr_round(src: np.ndarray, st, u: np.ndarray | None = None, seed: int = 0) -> np.ndarray:
    """Stochastically round `src` (f32/f64) to storage type `st`.

    `u`: optional uniforms in [0, 1) of src's shape (for replaying a device
    conversion host-side); default draws from numpy's Philox keyed by seed.
    """
    tdt = np_dtype(st)
    nbits = tdt.itemsize * 8
    ut = _uint_t(tdt.itemsize)

    src64 = np.asarray(src, np.float64)
    c = src64.astype(tdt)  # round-to-nearest-even
    c64 = c.astype(np.float64)
    err = src64 - c64

    key = _monotone_np(c.view(ut), nbits)
    step = np.sign(err).astype(np.int64)
    nb_bits = _from_monotone_np(key + step, nbits).astype(ut).view(tdt)
    nb64 = nb_bits.astype(np.float64)

    gap = np.abs(nb64 - c64)
    with np.errstate(invalid="ignore", divide="ignore"):
        p = np.where(gap > 0, np.abs(err) / gap, 0.0)
    if u is None:
        u = np.random.Generator(np.random.Philox(seed)).random(src64.shape)
    out = np.where((u < p) & np.isfinite(nb64), nb_bits, c)
    return out.astype(tdt)


# the signed integer type torch views each width's bits through
_BITS = {1: torch.uint8, 2: torch.int16}


def sr_round_device(src: torch.Tensor, st, generator: torch.Generator) -> torch.Tensor:
    """SR of `src` to storage type `st` in torch ops on src's device (f32
    arithmetic), uniforms drawn from `generator` (on the same device).

    The bit patterns are worked in int32 and the result selected there:
    ``torch.where`` takes no float8 operands."""
    tgt = dtypes.torch_dtype(dtypes.canon(st))
    nbytes = torch.empty((), dtype=tgt).element_size()
    nbits = nbytes * 8
    sign, mask = 1 << (nbits - 1), (1 << nbits) - 1

    x = src.float()
    c = x.to(tgt)
    c32 = c.float()
    err = x - c32

    b = c.view(_BITS[nbytes]).int() & mask
    mono = torch.where((b & sign) != 0, mask - b, b | sign)
    k2 = mono + torch.sign(err).int()
    nb = torch.where((k2 & sign) != 0, k2 & (mask ^ sign), mask - k2)

    def to_tgt(bits: torch.Tensor) -> torch.Tensor:
        if nbits == 16:  # into int16's range, the same bits
            bits = torch.where(bits >= 1 << 15, bits - (1 << 16), bits)
        return bits.to(_BITS[nbytes]).view(tgt)

    nb32 = to_tgt(nb).float()
    gap = (nb32 - c32).abs()
    p = torch.where(gap > 0, err.abs() / torch.where(gap > 0, gap, 1.0), 0.0)
    u = torch.rand(x.shape, generator=generator, dtype=torch.float32, device=x.device)
    return to_tgt(torch.where((u < p) & torch.isfinite(nb32), nb, b))


def sr_round_device_chunked(src: torch.Tensor, st, generator: torch.Generator,
                            chunk: int = 2**26) -> torch.Tensor:
    """Chunked device SR for multi-GiB operands: the SR temporaries are
    several times the f32 input, which would not fit beside a sweep's
    largest allocation. Any shape: the input is flattened and the result
    reshaped back, so a 2-D operand is chunked too. The chunks draw from
    `generator` in turn."""
    flat = src.reshape(-1)
    n = flat.numel()
    if n <= chunk:
        return sr_round_device(src, st, generator)
    out = torch.empty(n, dtype=dtypes.torch_dtype(dtypes.canon(st)), device=src.device)
    for i0 in range(0, n, chunk):
        out[i0 : i0 + chunk] = sr_round_device(flat[i0 : i0 + chunk], st, generator)
    return out.reshape(src.shape)
