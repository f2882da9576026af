"""Range / ReducedRowMajor: the accessor abstraction over torch tensors.

- ``ReducedRowMajor(ar, st)`` decouples the *storage* type of a buffer from
  the *arithmetic* type of a kernel: reads cast storage → arithmetic
  (``load_cast``), writes cast arithmetic → storage (``store_cast``).
- ``Range`` is a view over a tensor: ``r[i, j]`` / ``r.load()`` read and cast,
  ``r.set(idx, v)`` / ``r.store(v)`` cast and write in place. ``const=True``
  makes writes raise. ``stride`` views an (m, n) window of a parent whose
  physical row length is ``stride`` (a 2-D parent with that row length, or a
  flat parent of at least ``m * stride`` elements).

Inside the CUDA kernels the same (ar, st) pair is a pair of template
parameters (``csrc/accessor.cuh``). Counterpart of
``accblas_tpu.accessor.range``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import dtypes
from ..ops.df64 import DF, df_to_f32


@dataclass(frozen=True)
class ReducedRowMajor:
    """Accessor spec: (arithmetic type, storage type), 2-D row-major."""

    ar: str  # arithmetic type name ('f32', 'df64', 'f64', 'bf16', 'f16')
    st: str  # storage type name

    def __post_init__(self):
        object.__setattr__(self, "ar", dtypes.check_arithmetic(self.ar))
        object.__setattr__(self, "st", dtypes.canon(self.st))
        if self.st == "df64":
            raise ValueError("storage type must be a real dtype, not df64")

    @property
    def st_dtype(self) -> torch.dtype:
        return dtypes.torch_dtype(self.st)

    def load_cast(self, raw: torch.Tensor):
        """Storage value -> arithmetic value."""
        if self.ar == "df64":
            if raw.dtype == torch.float64:
                # exact two-word split of f64 storage; where hi saturates to
                # inf, lo is zeroed so the pair evaluates to inf, not NaN
                hi = raw.float()
                lo = torch.where(torch.isfinite(hi), (raw - hi.double()).float(),
                                 torch.zeros_like(hi))
                return DF(hi, lo)
            x = raw.float()
            return DF(x, torch.zeros_like(x))
        return raw.to(dtypes.torch_dtype(self.ar))

    def store_cast(self, value):
        """Arithmetic value -> storage value."""
        st = self.st_dtype
        if isinstance(value, DF):
            if self.st == "f64":
                # f64 holds the full df64 width: the words sum exactly
                return value.hi.double() + value.lo.double()
            return df_to_f32(value).to(st)
        return torch.as_tensor(value).to(st)


class Range:
    """User-facing accessor view over a tensor (see the module docstring)."""

    __slots__ = ("spec", "data", "_size", "const", "stride")

    def __init__(self, spec: ReducedRowMajor, data: torch.Tensor, size=None,
                 const=False, stride=None):
        self.spec = spec
        self.data = data
        self.const = const
        shape = tuple(data.shape)
        self._size = shape if size is None else tuple(size)
        self.stride = None if stride is None else int(stride)
        if self.stride is None:
            if self._size != shape:
                raise ValueError(
                    f"size {self._size} != carrier shape {shape}; "
                    "pass stride= to view a sub-window of a larger carrier"
                )
            return
        if size is None or len(self._size) != 2:
            raise ValueError("stride requires an explicit 2-D size=(m, n)")
        m, n = self._size
        if self.stride < n:
            raise ValueError(f"stride {self.stride} < row length {n}")
        if len(shape) == 2:
            if shape[1] != self.stride or shape[0] < m:
                raise ValueError(
                    f"2-D carrier {shape} incompatible with size {self._size} "
                    f"stride {self.stride}"
                )
        elif len(shape) == 1:
            if shape[0] < m * self.stride:
                raise ValueError(
                    f"flat carrier of {shape[0]} elems < m*stride = {m * self.stride}"
                )
        else:
            raise ValueError("strided Range needs a 1-D or 2-D carrier")

    def _map_idx(self, idx):
        """Map a logical index to the parent carrier's index space."""
        if self.stride is None:
            return idx
        if not (isinstance(idx, tuple) and len(idx) == 2):
            raise IndexError("strided Range indexing needs an (i, j) pair")
        i, j = idx
        if self.data.dim() == 1:
            return i * self.stride + j
        return (i, j)

    def _window(self) -> torch.Tensor:
        """The logically-sized (m, n) view of the parent carrier (no copy)."""
        if self.stride is None:
            return self.data
        m, n = self._size
        if self.data.dim() == 1:
            return self.data[: m * self.stride].view(m, self.stride)[:, :n]
        return self.data[:m, :n]

    # --- queries -------------------------------------------------------
    def length(self, dim: int) -> int:
        return self._size[dim]

    @property
    def shape(self):
        return self._size

    @property
    def ar(self):
        return self.spec.ar

    @property
    def st(self):
        return self.spec.st

    # --- reads ---------------------------------------------------------
    def __getitem__(self, idx):
        return self.spec.load_cast(self.data[self._map_idx(idx)])

    def load(self, idx=None):
        """Read the whole view (or a sub-index) as the arithmetic type."""
        return self.spec.load_cast(self.load_raw(idx))

    def load_raw(self, idx=None) -> torch.Tensor:
        """Read storage-typed values without the cast."""
        return self._window() if idx is None else self.data[self._map_idx(idx)]

    # --- writes --------------------------------------------------------
    def _check_writable(self):
        if self.const:
            raise TypeError("write to const Range")

    def set(self, idx, value):
        self._check_writable()
        self.data[self._map_idx(idx)] = self.spec.store_cast(value)

    def store(self, value, idx=None):
        """Cast and write `value` to the whole (m, n) view, or to `idx`. The
        whole-view store writes the same window load() reads, never the
        out-of-window part of the parent."""
        self._check_writable()
        cast = self.spec.store_cast(value)
        if idx is None:
            self._window()[...] = cast
        else:
            self.data[self._map_idx(idx)] = cast

    def as_const(self) -> "Range":
        return Range(self.spec, self.data, self._size, const=True, stride=self.stride)

    def __repr__(self):
        return (
            f"Range<ar={self.spec.ar}, st={self.spec.st}, size={self._size}, "
            f"const={self.const}, stride={self.stride}>"
        )


def make_range(ar, st, data, size=None, const=False, stride=None) -> Range:
    """Build a Range from an (ar, st) pair."""
    return Range(ReducedRowMajor(ar, st), data, size=size, const=const, stride=stride)
