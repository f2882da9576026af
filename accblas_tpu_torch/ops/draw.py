"""The benchmark data draw on the card: JAX's threefry2x32 uniforms.

A CUDA device runs the hand-written kernel of ``csrc/devgen.cu``; the CPU
runs ``_draw_plain``, the same function from the torch forms of
``utils.threefry``. Nothing falls back from one to the other: a draw for a
CUDA device that cannot build or launch the kernel raises, naming the draw.
The kernel replaces no Pallas kernel: the JAX package draws with
``jax.random`` (``accblas_tpu/utils/devgen.py``), which XLA lowers to
threefry; this draws the same bits.

Three modes, each over the flat elements of `shape`:
- ``"f32"``: fl32(a + 2^-24 b), a and b uniform(-1, 1) under keys ka and kb
  (``utils.devgen.gen_f32``);
- ``"df64"``: that hi and lo = (a - hi) + 2^-24 b (``devgen.split_df64``);
- ``"uniform"``: uniform(lo, hi) under ka (stochastic rounding, the solver
  driver's system, the power method's start).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import threefry
from . import _build
from .common import route

SCALE = 2.0**-24
MODES = {"f32": 0, "df64": 1, "uniform": 2}

# launches of the kernel, counted where the wrapper launches it
launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int,
             ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
             ctypes.c_float, ctypes.c_void_p]


def _draw_plain(mode: str, ka, kb, start: int, stop: int, lo: float, hi: float, device):
    """Flat elements [start, stop) of a draw in torch ops on `device`: one
    tensor, or (hi, lo) for "df64"."""
    if mode == "uniform":
        return threefry.to_uniform(threefry.random_bits(ka, start, stop, device), lo, hi)
    a = threefry.to_uniform(threefry.random_bits(ka, start, stop, device), -1.0, 1.0)
    sb = threefry.to_uniform(threefry.random_bits(kb, start, stop, device), -1.0, 1.0)
    sb.mul_(SCALE)
    h = a + sb
    return h if mode == "f32" else (h, a.sub_(h).add_(sb))


def _draw_cuda(mode: str, ka, kb, outs, start: int, lo: float, hi: float):
    """Launch the csrc/devgen.cu kernel over `outs` on the current stream."""
    global launches
    n = outs[0].numel()
    if n == 0:
        return
    lo32, scale = (float(v) for v in threefry.f32_bounds(lo, hi))
    try:
        fn = _build.function("devgen", "accblas_devgen", _ARGTYPES)
    except (RuntimeError, OSError) as e:  # nvcc missing or failing, or the library not loading
        raise RuntimeError(f"draw {mode}: the devgen kernel could not be built: {e}") from e
    t = outs[0]
    with _build.on_device(t):
        err = fn(t.data_ptr(), outs[-1].data_ptr(), start, n, MODES[mode], *ka, *kb, lo32,
                 scale, _build.stream(t))
    _build.check(err, f"draw {mode}: devgen kernel launch")
    launches += 1


def draw(mode: str, ka, kb, shape, lo: float = -1.0, hi: float = 1.0, device="cuda",
         start: int = 0):
    """Draw `shape` float32 elements (flat counters from `start`) on
    `device`: one tensor, or the (hi, lo) pair for mode "df64". Keys are
    (word, word) pairs; `kb` is unused by mode "uniform"."""
    if mode not in MODES:
        raise ValueError(f"draw: mode {mode!r} is not one of {', '.join(MODES)}")
    shape = threefry.as_shape(shape)
    outs = [torch.empty(shape, dtype=torch.float32, device=device)
            for _ in range(2 if mode == "df64" else 1)]
    if route(f"draw {mode}", *outs) == "cuda":
        _draw_cuda(mode, ka, kb, outs, start, lo, hi)
    else:
        flats = [o.view(-1) for o in outs]
        n = flats[0].numel()
        for i0 in range(0, n, threefry.CHUNK):
            i1 = min(i0 + threefry.CHUNK, n)
            got = _draw_plain(mode, ka, kb, start + i0, start + i1, lo, hi, outs[0].device)
            for f, g in zip(flats, got if mode == "df64" else (got,)):
                f[i0:i1] = g
    return tuple(outs) if mode == "df64" else outs[0]


def replay_np(mode: str, ka, kb, start: int, stop: int, lo: float = -1.0,
              hi: float = 1.0, step: int = 1):
    """numpy replay of flat elements [start, stop) of ``draw``, every
    `step`-th: the kernel's bits for every mode."""
    if mode == "uniform":
        return threefry.uniform_np(ka, start, stop, lo, hi, step)
    a = threefry.uniform_np(ka, start, stop, -1.0, 1.0, step)
    sb = threefry.uniform_np(kb, start, stop, -1.0, 1.0, step) * np.float32(SCALE)
    h = a + sb
    return h if mode == "f32" else (h, (a - h) + sb)
