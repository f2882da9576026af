"""On-device benchmark data with a host-replayable fp64 master copy.

Counterpart of ``accblas_tpu.utils.devgen``, drawing the same numbers.
Copying GiB-scale operands from the host costs more than generating them,
so the card draws its own storage copies, and the host replays the exact
fp64 master for the oracle: no bulk transfer in either direction.

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

The draw is JAX's: a and b are ``jax.random.uniform`` under the two keys of
``split(key(seed, role, r))``, with ``key`` the JAX package's ``_key``
(``utils.threefry``). The card draws in the kernel of ``ops.draw``; the CPU
draws in its torch form, in chunks of ``threefry.CHUNK`` elements. numpy
replays any flat range bit for bit (``replay_f32``, ``master_f64``), the
native host library the master in parallel (``native.host``).
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from . import threefry

SCALE = 2.0**-24

# role tags keep the draws of different operands apart: the drivers' roles
# are the JAX package's small ids (its CSVs were drawn with them); other
# tags take a stable CRC32 of the tag
ROLES = {"dot_x": 0, "dot_y": 1, "gemv_a": 2, "gemv_x": 3, "gemv_res": 4,
         "trsv_b": 5, "sr": 6}


def _role_id(role: str) -> int:
    rid = ROLES.get(role)
    return zlib.crc32(role.encode()) & 0x7FFFFFFF if rid is None else rid


def key(seed: int, role: str, r: int = 0) -> tuple[int, int]:
    """The threefry key of (seed, role, r): fold_in(fold_in(key(seed), role
    id), r), as the JAX package's ``devgen._key``."""
    return threefry.fold_in(threefry.fold_in(threefry.key(seed), _role_id(role)), r)


def _keys(seed: int, role: str, r: int):
    """The keys of the a and b draws."""
    ka, kb = threefry.split(key(seed, role, r))
    return ka, kb


def gen_f32(shape, seed: int = 42, role: str = "dot_x", r: int = 0,
            device="cuda") -> torch.Tensor:
    """The f32 storage copy fl32(master) of `shape`, drawn on `device`."""
    from ..ops import draw

    return draw.draw("f32", *_keys(seed, role, r), threefry.as_shape(shape), device=device)


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
    from ..ops import draw

    shape = threefry.as_shape(x32.shape if master_shape is None else master_shape)
    dev = x32.device if x32 is not None else torch.device(device)
    return draw.draw("df64", *_keys(seed, role, r), shape, device=dev)


def replay_f32(shape, seed: int = 42, role: str = "dot_x", r: int = 0, start: int = 0,
               stop: int | None = None) -> np.ndarray:
    """numpy replay of ``gen_f32``'s flat elements [start, stop), bit for bit."""
    from ..ops import draw

    stop = int(np.prod(threefry.as_shape(shape))) if stop is None else stop
    return draw.replay_np("f32", *_keys(seed, role, r), start, stop)


def _master_np(ka, kb, start: int, stop: int) -> np.ndarray:
    a = threefry.uniform_np(ka, start, stop, -1.0, 1.0).astype(np.float64)
    b = threefry.uniform_np(kb, start, stop, -1.0, 1.0).astype(np.float64)
    return a + SCALE * b


def master_f64(shape, seed: int = 42, role: str = "dot_x", r: int = 0) -> np.ndarray:
    """Host replay of the exact fp64 master (for the numpy oracle): the
    native library's parallel loop where it is built, else numpy in chunks;
    the two are bit-identical."""
    from ..native import host

    shape = threefry.as_shape(shape)
    n = int(np.prod(shape))
    ka, kb = _keys(seed, role, r)
    if host.available():
        return host.master_f64(0, n, ka, kb).reshape(shape)
    out = np.empty(n, np.float64)
    for i0 in range(0, n, threefry.CHUNK):
        i1 = min(i0 + threefry.CHUNK, n)
        out[i0:i1] = _master_np(ka, kb, i0, i1)
    return out.reshape(shape)
