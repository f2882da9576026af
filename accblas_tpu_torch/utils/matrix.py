"""Data-management layer: matrix descriptors, seeded generators, converters
(numpy), the counterpart of ``accblas_tpu.utils.matrix``, bit for bit:
- `MatrixInfo`: extents + row stride of a row-major matrix;
- `gen_mtx` / `write_random`: seeded uniform(-1,1) float64 masters with the
  subnormal filter (values resampled until normal in float32), from the
  counter-based stream in ``utils.prng``; the native host library
  (``native.host``) generates the same bits in parallel where it is built;
- `convert_mtx`: elementwise precision conversion, round to nearest or
  stochastic (``utils.sr``);
- `format_mtx`: debug formatter.

Tensors are made from these masters with ``utils.interop.from_numpy``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import prng


@dataclass(frozen=True)
class MatrixInfo:
    """POD descriptor of a row-major 2-D matrix: extents + row stride.
    `stride >= cols` permits submatrix views of a larger allocation."""

    rows: int
    cols: int
    stride: int | None = None

    def __post_init__(self):
        if self.stride is None:
            object.__setattr__(self, "stride", self.cols)
        if self.stride < self.cols:
            raise ValueError("stride must be >= cols")

    @property
    def size(self):
        return (self.rows, self.cols)

    def get_1d_size(self) -> int:
        return self.rows * self.stride

    def get_num_elems(self) -> int:
        return self.rows * self.cols


def gen_mtx(info: MatrixInfo, seed: int = 42, lo: float = -1.0, hi: float = 1.0) -> np.ndarray:
    """Random row-major matrix in float64, honoring stride, subnormal-filtered
    in float32. Entries outside the view (stride padding) are zero. The
    native library generates the same bits where it is built."""
    from ..native import host

    if host.available():
        return host.gen_mtx(info.rows, info.cols, info.stride, seed, lo, hi)
    vals = prng.uniform_filtered(info.get_num_elems(), seed, lo, hi)
    out = np.zeros((info.rows, info.stride), np.float64)
    out[:, : info.cols] = vals.reshape(info.rows, info.cols)
    return out


def write_random(buf: np.ndarray, info: MatrixInfo, seed: int, lo=-1.0, hi=1.0) -> None:
    """Overwrite an existing buffer view with fresh randoms."""
    buf[: info.rows, : info.cols] = gen_mtx(
        MatrixInfo(info.rows, info.cols), seed=seed, lo=lo, hi=hi
    )[:, : info.cols]


def convert_mtx(src: np.ndarray, dtype, rounding: str = "nearest", seed: int = 0) -> np.ndarray:
    """Elementwise precision conversion (reference ``cuda/matrix_helper.cuh:93-103``).

    `dtype` accepts numpy dtypes or lattice names ('bf16', 'f16', 'f8e4m3',
    'f8e5m2', ...). ``rounding='stochastic'`` uses the zero-mean SR converter
    (``utils.sr``), the recommended mode for the f8 storage tiers."""
    from ..accessor import dtypes
    from . import sr

    try:
        name = dtypes.canon(dtype)
    except ValueError:
        return src.astype(dtype)
    if rounding == "stochastic":
        if name in ("f64", "f32"):
            raise ValueError(
                "stochastic rounding targets the narrow storage tiers "
                "(bf16/f16/f8); use rounding='nearest' for f32/f64"
            )
        return sr.sr_round(src, name, seed=seed)
    return src.astype(sr.np_dtype(name))


def format_mtx(mtx: np.ndarray, max_rows: int = 8, max_cols: int = 8) -> str:
    """Debug formatter."""
    view = mtx[:max_rows, :max_cols] if mtx.ndim == 2 else mtx[:max_rows]
    return np.array2string(np.asarray(view, np.float64), precision=6, suppress_small=False)
