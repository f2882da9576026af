"""On-device benchmark data with a host-replayable fp64 master copy.

Counterpart of ``accblas_tpu.utils.devgen``. Copying GiB-scale operands from
the host costs more than generating them, so the card draws its own storage
copies, and the host replays the exact fp64 master for the oracle: no bulk
transfer in either direction.

The master is the JAX package's construction: two independent uniform(-1, 1)
float32 draws a, b combine as

    master = fl64(a + 2^-24 * b)

- the f32 storage copy is ``a + 2^-24 * b`` in f32 (the scale is a power of
  two, so the product is exact and the add is the one correct rounding),
  which is fl32(master) (``gen_f32``);
- ``split_df64`` gives the (hi, lo) f32 pair that carries the master to
  df64 precision, for the device oracle (``ops.oracle``);
- narrower storage copies derive from the f32 copy on the device (a cast,
  or ``utils.sr`` stochastic rounding for f8).

The draw is the port's own, since threefry is JAX's: the counter-based
splitmix64 of ``utils.prng``, keyed by a stream from (seed, role, r). Element
i of round k (a: k = 0, b: k = 1) takes the top 24 bits of
splitmix64(i·γ + stream + k·ρ) (``prng.uniform``'s key) as u, and
a = u·2^-23 − 1, exact in f32. The card computes it in torch int64, whose
products wrap mod 2^64 as uint64's do; ``>>`` is arithmetic on int64, so
every shift is masked to a logical one. numpy replays it bit for bit
(``replay_f32``, ``master_f64``), the native host library in parallel
(``native.host``). Counters are drawn in chunks of ``CHUNK``: 2^27 int64
counters would take 1 GiB per temporary.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from . import prng

SCALE = 2.0**-24

# role tags keep the streams of different operands disjoint: the drivers'
# roles are pinned to the JAX package's small ids; other tags take a stable
# CRC32 of the tag
ROLES = {"dot_x": 0, "dot_y": 1, "gemv_a": 2, "gemv_x": 3, "gemv_res": 4,
         "trsv_b": 5, "sr": 6}

CHUNK = 2**24  # elements drawn per pass: 128 MiB per int64 temporary

_M64 = (1 << 64) - 1
_GAMMA = int(prng._GAMMA)
_ROUND = int(prng._ROUND)


def _s64(v: int) -> int:
    """The int64 with the bits of uint64 `v`."""
    v &= _M64
    return v - (1 << 64) if v >> 63 else v


_GAMMA_S, _M1_S, _M2_S = (_s64(int(c)) for c in (prng._GAMMA, prng._M1, prng._M2))


def _role_id(role: str) -> int:
    rid = ROLES.get(role)
    return zlib.crc32(role.encode()) & 0x7FFFFFFF if rid is None else rid


def stream(seed: int, role: str, r: int = 0) -> int:
    """The 64-bit stream key of (seed, role, r): splitmix64 folds of each."""
    z = prng._splitmix64(np.array([int(seed) & _M64], np.uint64))
    z = prng._splitmix64(z ^ np.uint64(_role_id(role)))
    z = prng._splitmix64(z ^ np.uint64(int(r) & _M64))
    return int(z[0])


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _draw(idx: torch.Tensor, key: int, rnd: int) -> torch.Tensor:
    """float32 draws of round `rnd` of stream `key` at int64 counters `idx`."""
    # splitmix64(idx·γ + key + rnd·ρ), whose first step adds γ once more
    z = idx * _GAMMA_S
    z += _s64(key + rnd * _ROUND + _GAMMA)
    z ^= _srl(z, 30)
    z *= _M1_S
    z ^= _srl(z, 27)
    z *= _M2_S
    z ^= _srl(z, 31)
    return _srl(z, 40).to(torch.float32).mul_(2.0**-23).sub_(1.0)


def _draw_np(idx: np.ndarray, key: int, rnd: int) -> np.ndarray:
    """numpy replay of ``_draw`` (uint64 counters)."""
    with np.errstate(over="ignore"):
        k = idx * prng._GAMMA + np.uint64(key) + np.uint64(rnd) * prng._ROUND
    bits = prng._splitmix64(k)
    return (bits >> np.uint64(40)).astype(np.float32) * np.float32(2.0**-23) - np.float32(1.0)


def _shape(shape) -> tuple:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(int(s) for s in shape)


def _chunks(n: int):
    for i0 in range(0, n, CHUNK):
        yield i0, min(i0 + CHUNK, n)


def gen_f32(shape, seed: int = 42, role: str = "dot_x", r: int = 0,
            device="cuda") -> torch.Tensor:
    """The f32 storage copy fl32(master) of `shape`, drawn on `device`."""
    key = stream(seed, role, r)
    out = torch.empty(_shape(shape), dtype=torch.float32, device=device)
    flat = out.view(-1)
    for i0, i1 in _chunks(flat.numel()):
        idx = torch.arange(i0, i1, dtype=torch.int64, device=out.device)
        a, b = _draw(idx, key, 0), _draw(idx, key, 1)
        flat[i0:i1] = a.add_(b.mul_(SCALE))
    return out


def split_df64(x32=None, master_shape=None, seed: int = 42, role: str = "dot_x", r: int = 0,
               device="cuda"):
    """Exact (hi, lo) f32 split of the master, computed on the device (that
    of `x32` if given, else `device`; the shape of `x32` unless
    `master_shape` is given).

    hi = fl32(master) is the f32 copy; lo = (a - hi) + 2^-24·b recovers the
    rounding residue: (a - hi) is exact except for the ~2^-24 fraction of
    near-zero draws, 2^-24·b is exact, and the final add rounds once at
    ulp(lo), so (hi, lo) carries the master to ~2^-48 relative, df64's own
    precision."""
    shape = _shape(x32.shape if master_shape is None else master_shape)
    dev = x32.device if x32 is not None else torch.device(device)
    key = stream(seed, role, r)
    hi = torch.empty(shape, dtype=torch.float32, device=dev)
    lo = torch.empty(shape, dtype=torch.float32, device=dev)
    fh, fl = hi.view(-1), lo.view(-1)
    for i0, i1 in _chunks(fh.numel()):
        idx = torch.arange(i0, i1, dtype=torch.int64, device=dev)
        a, sb = _draw(idx, key, 0), _draw(idx, key, 1).mul_(SCALE)
        h = a + sb
        fh[i0:i1] = h
        fl[i0:i1] = a.sub_(h).add_(sb)
    return hi, lo


def replay_f32(shape, seed: int = 42, role: str = "dot_x", r: int = 0, start: int = 0,
               stop: int | None = None) -> np.ndarray:
    """numpy replay of ``gen_f32``'s flat elements [start, stop), bit for bit."""
    stop = int(np.prod(_shape(shape))) if stop is None else stop
    key = stream(seed, role, r)
    idx = np.arange(start, stop, dtype=np.uint64)
    return _draw_np(idx, key, 0) + np.float32(SCALE) * _draw_np(idx, key, 1)


def master_f64(shape, seed: int = 42, role: str = "dot_x", r: int = 0) -> np.ndarray:
    """Host replay of the exact fp64 master (for the numpy oracle): the
    native library's parallel loop where it is built, else numpy in chunks;
    the two are bit-identical."""
    from ..native import host

    shape = _shape(shape)
    n = int(np.prod(shape))
    key = stream(seed, role, r)
    if host.available():
        return host.master_f64(0, n, key).reshape(shape)
    out = np.empty(n, np.float64)
    for i0, i1 in _chunks(n):
        idx = np.arange(i0, i1, dtype=np.uint64)
        a, b = _draw_np(idx, key, 0), _draw_np(idx, key, 1)
        out[i0:i1] = a.astype(np.float64) + SCALE * b.astype(np.float64)
    return out.reshape(shape)


def generator(seed: int, role: str, r: int = 0, sub: int = 0,
              device="cuda") -> torch.Generator:
    """A torch.Generator on `device`, seeded from the stream of (seed, role,
    r) and `sub` (the stochastic-rounding draws of ``utils.sr``)."""
    g = torch.Generator(device=device)
    g.manual_seed(stream(seed, role, r) ^ int(sub))
    return g
