"""What a run must not load, and where the system under test must come from.

Modules are compared by their top-level name, the part before the first
dot, and whole: ``accblas_tpu_torch`` is the port, ``accblas_tpu`` the JAX
package it was ported from.
"""

from __future__ import annotations

import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "accblas_tpu"})

# the system under test
PORT = "accblas_tpu_torch"


def forbidden(modules=None) -> list[str]:
    """The forbidden top-level names among `modules` (sys.modules' names)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def port_outside(root: Path, module) -> str | None:
    """Why the imported port `module` is not the checkout's at `root`, or
    None when it is."""
    where = Path(module.__file__).resolve()
    if Path(root).resolve() / PORT not in where.parents:
        return f"{PORT} was imported from {where}, not from the checkout at {root}"
    return None
