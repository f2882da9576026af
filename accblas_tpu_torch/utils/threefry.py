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

# XLA:CPU's float32 log1p. For |x| < sqrt(2) - 1 a Cephes rational
# approximation x - x²/2 + x³·num(x)/den(x) (coefficients highest first);
# elsewhere log(1 + x) with XLA's float32 log, Cephes' degree-8 polynomial
# (Eigen's plog) after a reduction of the argument to [sqrt(1/2), sqrt(2)).
_LOG1P_SMALL = np.float32(0.41421356237309504880)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRTHF = np.float32(0.707106781186547524)


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


def _fma(a, b, c) -> torch.Tensor:
    """float32 fused multiply-add a·b + c of float32 tensors or Python floats
    holding float32 values: the product is exact in float64, the sum is
    rounded there and then to float32."""
    a, b, c = (v.double() if torch.is_tensor(v) else v for v in (a, b, c))
    return (a * b + c).float()


def _f32(v: float) -> float:
    return np.float32(v).item()


def log_f32(u: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 log of u > 0 (Eigen's plog), in float32 steps with
    its fused multiply-adds: u = m·2^e with m in [sqrt(1/2), sqrt(2)), the
    polynomial in x = m - 1 in three parts, then the tail x - x²/2 + y +
    e·log(2) with log(2) split in two."""
    u = u.clamp_min(float(np.finfo(np.float32).tiny))
    bits = u.view(torch.int32)
    e = ((bits >> 23) - 126).float()
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    low = m < float(_SQRTHF)
    x = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.float()
    x2 = x * x
    x3 = x2 * x
    p = [_f32(c) for c in _LOG_P]
    y = _fma(_fma(p[0], x, p[1]), x, p[2])
    y1 = _fma(_fma(p[3], x, p[4]), x, p[5])
    y2 = _fma(_fma(p[6], x, p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _f32(_LOG_Q1))
    return _fma(e, _f32(_LOG_Q2), _fma(x2, -0.5, x) + y)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 log1p (``jax.lax.log1p`` on the CPU), bit for bit:
    the rational approximation for |x| < sqrt(2) - 1, ``log_f32(1 + x)``
    elsewhere. ``torch.log1p`` differs from it on 7% of inputs.

    The rational part rounds every multiply and every add on its own, as
    XLA's HLO does and as XLA:CPU runs it at backend optimisation level 0
    (the test configuration, tests/conftest.py). At its default level LLVM
    contracts them into fused multiply-adds, which moves the result by up
    to 2 ulp; ``log_f32``'s fused multiply-adds are XLA's own at every
    level."""
    # XLA:CPU flushes subnormal inputs to zero (with their sign)
    x = torch.where(x.abs() < float(np.finfo(np.float32).tiny), x * 0.0, x)
    x2 = x * x
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for a, b in zip(_LOG1P_NUM, _LOG1P_DEN):
        num = num * x + _f32(a)
        den = den * x + _f32(b)
    small = x + (x2 * -0.5 + (x * x2) * (num / den))
    return torch.where(x.abs() < float(_LOG1P_SMALL), small, log_f32(x + 1.0))


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv in torch ops, bit for bit (M. Giles' form, as
    XLA lowers ``chlo.erf_inv``): with w = -log1p(-x²), the polynomial in
    w - 2.5 (w < 5) or sqrt(w) - 3, times x, every multiply and add rounded
    on its own (see ``log1p_f32`` for the contraction at XLA:CPU's default
    level). ``torch.erfinv`` is a closer approximation and differs from
    XLA's by up to ~90 ulp."""
    w = log1p_f32(x * -x).neg_()
    central = w < 5.0
    # the square root taken in float64 and rounded is the correctly rounded
    # float32 one; torch's float32 sqrt on the CPU is not always
    root = w.double().sqrt().float()
    w = torch.where(central, w - 2.5, root - 3.0)
    p = torch.zeros_like(w)
    for a, b in _ERFINV:
        p = p * w + torch.where(central, _f32(a), _f32(b))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(k, shape, device="cuda") -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)`` on `device`."""
    return erfinv_f32(uniform(k, shape, NORMAL_LO, 1.0, device)).mul_(float(SQRT2))


def normal_np(k, start: int, stop: int) -> np.ndarray:
    """numpy replay of flat elements [start, stop) of ``normal`` (erfinv in
    torch on the CPU)."""
    u = torch.from_numpy(uniform_np(k, start, stop, NORMAL_LO, 1.0))
    return erfinv_f32(u).numpy() * SQRT2
