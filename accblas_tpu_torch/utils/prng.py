"""Counter-based deterministic host PRNG (splitmix64 finalizer).

The reference generates data with ``std::default_random_engine(42)`` +
``uniform_real_distribution<double>(-1,1)`` (``cuda/dot_benchmark.cu:71-72``)
— a sequential, implementation-defined stream. We replace it with a
*counter-based* scheme (splitmix64 finalizer over ``seed ⊕ f(index, round)``),
chosen TPU-framework-first:

- bit-identical between the numpy reference implementation here and the
  OpenMP C++ fast path (accblas_tpu/native/src/accblas_host.cpp), which is
  tested for exact equality;
- embarrassingly parallel (no sequential engine state), so huge buffers
  (DOT sweeps to n=5.35e8) generate fast;
- the subnormal filter (reference ``cuda/matrix_helper.cuh:42-45``:
  resample until ``std::isnormal``) becomes a per-element resample with a
  bumped round counter — still deterministic and parallel.

The mapping to [0,1) uses the top 53 bits (``(x >> 11) * 2^-53``), the standard
exact double construction.
"""

from __future__ import annotations

import numpy as np

_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_ROUND = np.uint64(0xD1342543DE82EF95)
_TWO53 = 9007199254740992.0  # 2**53
_FLT_MIN = float(np.finfo(np.float32).tiny)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = (x + _GAMMA).astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * _M1
        z = (z ^ (z >> np.uint64(27))) * _M2
        return z ^ (z >> np.uint64(31))


def uniform(idx: np.ndarray, seed: int, rnd: int = 0, lo: float = -1.0, hi: float = 1.0) -> np.ndarray:
    """Deterministic uniform [lo, hi) doubles for element counters `idx`."""
    idx = np.asarray(idx, np.uint64)
    with np.errstate(over="ignore"):
        key = idx * _GAMMA + np.uint64(seed) + np.uint64(rnd) * _ROUND
    bits = _splitmix64(key)
    u = (bits >> np.uint64(11)).astype(np.float64) / _TWO53
    return lo + u * (hi - lo)


def uniform_filtered(n: int, seed: int, lo: float = -1.0, hi: float = 1.0) -> np.ndarray:
    """uniform() with the subnormal/zero/inf/nan filter in float32 range
    (reference ``cuda/matrix_helper.cuh:42-45``)."""
    idx = np.arange(n, dtype=np.uint64)
    vals = uniform(idx, seed, 0, lo, hi)
    rnd = 1
    bad = ~np.isfinite(vals) | (np.abs(vals) < _FLT_MIN)
    while np.any(bad):
        vals[bad] = uniform(idx[bad], seed, rnd, lo, hi)
        bad = ~np.isfinite(vals) | (np.abs(vals) < _FLT_MIN)
        rnd += 1
    return vals
