"""JAX's threefry2x32 random draw, replayed bit for bit.

The port keeps its own copy of the algorithm (``jax._src.prng`` and
``jax._src.random``, partitionable layout, the default of JAX >= 0.5), so
that for the same key it draws the JAX package's numbers:

- a key is a pair of 32-bit words, kept here as a tuple of Python ints:
  ``threefry_seed`` makes ``(seed >> 32, seed & 0xFFFFFFFF)`` of the seed
  as an integer of JAX's default width, which is 32 bits in the JAX
  package (64-bit types off), so ``key(seed)`` is ``(0, seed mod 2^32)``;
- ``block(k, x0, x1)`` is threefry2x32: 20 rounds, rotations (13, 15, 26, 6)
  and (17, 29, 16, 24), a key injection every 4 rounds with the parity word
  ``k0 ^ k1 ^ 0x1BD11BDA``;
- ``fold_in(k, d)`` is ``block(k, 0, d)`` (both output words), and
  ``split(k, num)`` key i is ``block(k, i >> 32, i & 0xFFFFFFFF)``;
- the 32 random bits of flat element i of a draw are ``x0 ^ x1`` of
  ``block(k, i >> 32, i & 0xFFFFFFFF)``: the counter is the 64-bit row-major
  index, so any flat range [start, stop) of a draw can be made alone, a
  1-D draw's leading slice is a shorter draw, and element (i, j) of an
  (m, n) draw has counter i·n + j;
- ``uniform``: the top 23 bits as the mantissa of a float in [1, 2), minus
  1, times (hi - lo), plus lo, then max(lo, ·), each step in float32;
- ``normal``: sqrt(2)·erfinv(uniform(nextafter(-1, 0), 1)), with erfinv
  XLA's float32 approximation (``erfinv_f32``).

Every function has a torch form (uint32 words carried in int64 and masked
to 32 bits: ``>>`` is arithmetic on int64, but the words are never
negative) and a numpy form (``*_np``, native uint32 wrap-around). The
torch forms are the plain versions of the draw kernel (``ops.draw``);
``uniform`` and ``normal`` launch that kernel for a CUDA device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
SQRT2 = np.float32(math.sqrt(2.0))
# the lower end of normal()'s uniform, nextafter(-1, 0) in float32
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))

CHUNK = 2**24  # elements per pass of a torch form: 128 MiB per int64 temporary

# XLA's float32 erf_inv, which jax.random.normal runs (M. Giles,
# "Approximating the erfinv function", GPU Computing Gems, 2011): the
# coefficients of a degree-8 polynomial, highest first, for w < 5 and w >= 5
_ERFINV = tuple(zip(
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
     -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
     -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)))


def key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)`` with 64-bit types off: the seed taken mod
    2^32 as the low word, a zero high word."""
    return 0, int(seed) & M32


def block(k, x0, x1, wrap=lambda v: v & M32):
    """threefry2x32 of the counter words (x0, x1) under key k. The words may
    be Python ints, int64 tensors holding uint32 values, or uint32 numpy
    arrays (then pass ``wrap=lambda v: v``: uint32 wraps by itself)."""
    k0, k1 = k
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0, x1 = wrap(x0 + ks[0]), wrap(x1 + ks[1])
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = wrap(x0 + x1)
            x1 = (wrap(x1 << r) | (x1 >> (32 - r))) ^ x0
        x0 = wrap(x0 + ks[(i + 1) % 3])
        x1 = wrap(x1 + ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def fold_in(k, data: int) -> tuple[int, int]:
    """``jax.random.fold_in``: the key of `data` (taken mod 2^32) under k."""
    return block(k, 0, int(data) & M32)


def split(k, num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split``: `num` keys, key i hashed from the counter i."""
    return [block(k, i >> 32, i & M32) for i in range(num)]


def _np_key(k):
    return np.uint32(k[0]), np.uint32(k[1])


def random_bits(k, start: int, stop: int, device="cpu") -> torch.Tensor:
    """The 32-bit draws of flat elements [start, stop) under k, as int64."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    x0, x1 = block(k, idx >> 32, idx & M32)
    return x0 ^ x1


def random_bits_np(k, start: int, stop: int, step: int = 1) -> np.ndarray:
    """numpy form of ``random_bits``, every `step`-th element: uint32."""
    idx = np.arange(start, stop, step, dtype=np.uint64)
    hi, lo = (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32)
    x0, x1 = block(_np_key(k), hi, lo, wrap=lambda v: v)
    return x0 ^ x1


def f32_bounds(lo: float, hi: float) -> tuple[np.float32, np.float32]:
    """lo and hi - lo in float32, as JAX computes them."""
    lo32 = np.float32(lo)
    return lo32, np.float32(hi) - lo32


def to_uniform(bits: torch.Tensor, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [lo, hi) from int64-held 32-bit draws."""
    lo32, scale = f32_bounds(lo, hi)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32).sub_(1.0)
    return f.mul_(float(scale)).add_(float(lo32)).clamp_min_(float(lo32))


def to_uniform_np(bits: np.ndarray, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """numpy form of ``to_uniform``."""
    lo32, scale = f32_bounds(lo, hi)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    return np.maximum(lo32, f * scale + lo32)


def as_shape(shape) -> tuple:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(int(s) for s in shape)


def uniform(k, shape, lo: float = 0.0, hi: float = 1.0, device="cuda") -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, lo, hi)`` on `device`: the
    draw kernel on a CUDA device, ``random_bits`` and ``to_uniform`` in
    passes of CHUNK elements on the CPU (``ops.draw``)."""
    from ..ops import draw

    return draw.draw("uniform", k, k, shape, lo, hi, device)


def uniform_np(k, start: int, stop: int, lo: float = 0.0, hi: float = 1.0,
               step: int = 1) -> np.ndarray:
    """numpy replay of flat elements [start, stop) of ``uniform``, every
    `step`-th."""
    return to_uniform_np(random_bits_np(k, start, stop, step), lo, hi)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv in torch ops: with w = -log1p(-x²), the
    polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x. XLA evaluates the
    polynomial with fused multiply-adds; each is taken here in float64 (the
    product of two float32 is exact there) and rounded to float32. log1p is
    torch's: XLA's differs from it by up to 2 ulp, which leaves the result
    within a few ulp of XLA's. ``torch.erfinv`` is a closer approximation
    and differs from XLA's by up to ~90 ulp."""
    w = torch.log1p(x * -x).neg_()
    central = w < 5.0
    w = torch.where(central, w - 2.5, w.sqrt() - 3.0).double()
    p = torch.zeros_like(w)
    for a, b in _ERFINV:
        c = torch.where(central, np.float32(a).item(), np.float32(b).item()).double()
        p = c.add_(p.mul_(w)).float().double()
    return torch.where(x.abs() == 1.0, x * math.inf, p.float() * x)


def normal(k, shape, device="cuda") -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)`` on `device`."""
    return erfinv_f32(uniform(k, shape, NORMAL_LO, 1.0, device)).mul_(float(SQRT2))


def normal_np(k, start: int, stop: int) -> np.ndarray:
    """numpy replay of flat elements [start, stop) of ``normal`` (erfinv in
    torch on the CPU)."""
    u = torch.from_numpy(uniform_np(k, start, stop, NORMAL_LO, 1.0))
    return erfinv_f32(u).numpy() * SQRT2
