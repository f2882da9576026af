"""Arithmetic/storage dtype system for the accessor, on torch dtypes.

The same promotion lattice as the JAX package (``accblas_tpu.accessor.dtypes``):

    f8e5m2 < f8e4m3 < bf16 < f16 < f32 < df64 < f64

- ``f32``/``bf16``/``f16``/``f64``: native torch dtypes.
- ``f8e4m3``/``f8e5m2``: 8-bit float *storage-only* tiers
  (``torch.float8_e4m3fn`` / ``torch.float8_e5m2``) — may appear as `st`,
  never as `ar` (``check_arithmetic``).
- ``df64``: double-float (a pair of float32s, ``ops.df64``) — an arithmetic
  type only, never a storage dtype.
"""

from __future__ import annotations

import torch

# canonical type names, in promotion order
_ORDER = ("f8e5m2", "f8e4m3", "bf16", "f16", "f32", "df64", "f64")

# types that may appear as `st` but not as `ar`
STORAGE_ONLY = frozenset({"f8e4m3", "f8e5m2"})

_TORCH = {
    "f8e4m3": torch.float8_e4m3fn,
    "f8e5m2": torch.float8_e5m2,
    "bf16": torch.bfloat16,
    "f16": torch.float16,
    "f32": torch.float32,
    "f64": torch.float64,
}

_FROM_TORCH = {dt: name for name, dt in _TORCH.items()}

_ALIASES = {
    "float32": "f32",
    "float64": "f64",
    "bfloat16": "bf16",
    "float16": "f16",
    "fp32": "f32",
    "fp64": "f64",
    "df": "df64",
    "float8_e4m3fn": "f8e4m3",
    "float8_e4m3": "f8e4m3",
    "float8_e5m2": "f8e5m2",
    "f8": "f8e4m3",
    "fp8": "f8e4m3",
}


def canon(t) -> str:
    """Canonicalise a type spec: a lattice name, an alias, or a torch dtype."""
    if isinstance(t, str):
        name = _ALIASES.get(t.lower(), t.lower())
        if name not in _ORDER:
            raise ValueError(f"unknown arithmetic type {t!r}")
        return name
    if t not in _FROM_TORCH:
        raise ValueError(f"unsupported dtype {t!r}")
    return _FROM_TORCH[t]


# value-embedding partial order: t -> every type that can represent all of
# t's finite values exactly. bf16 vs f16 (and f8e5m2 vs f8e4m3) embed in
# neither direction; df64 ⊂ f64 (hi/lo span ≤ ~49 significand bits < 53).
_SUPER = {
    "f8e5m2": frozenset({"f8e5m2", "bf16", "f16", "f32", "df64", "f64"}),
    "f8e4m3": frozenset({"f8e4m3", "bf16", "f16", "f32", "df64", "f64"}),
    "bf16": frozenset({"bf16", "f32", "df64", "f64"}),
    "f16": frozenset({"f16", "f32", "df64", "f64"}),
    "f32": frozenset({"f32", "df64", "f64"}),
    "df64": frozenset({"df64", "f64"}),
    "f64": frozenset({"f64"}),
}


def promote(*types) -> str:
    """The narrowest type that embeds every operand's values exactly (a join
    over the embedding partial order). Ties between incomparable minimal
    supertypes resolve to the earlier name in the lattice order."""
    names = [canon(t) for t in types]
    common = frozenset.intersection(*(_SUPER[n] for n in names))
    return min(common, key=_ORDER.index)


def torch_dtype(name) -> torch.dtype:
    """torch dtype for a native arithmetic/storage type name (not df64)."""
    name = canon(name)
    if name == "df64":
        raise ValueError("df64 is not a storage dtype; it is an arithmetic pair of f32s")
    return _TORCH[name]


def is_df(name) -> bool:
    return canon(name) == "df64"


def check_arithmetic(name) -> str:
    """Canonicalise an *arithmetic*-type spec, rejecting storage-only types."""
    name = canon(name)
    if name in STORAGE_ONLY:
        raise ValueError(
            f"{name} is a storage-only tier; pass it as the tensor dtype and "
            "choose ar='bf16'/'f32'/'df64' (e.g. acc_dot(x8, y8, ar='f32'))"
        )
    return name


def storage_bytes(st) -> int:
    return torch_dtype(st).itemsize
