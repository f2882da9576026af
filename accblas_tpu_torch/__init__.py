"""accblas_tpu_torch: the accessor BLAS on PyTorch, with CUDA kernels for an
NVIDIA H100 (sm_90a).

The port of ``accblas_tpu`` (JAX/Pallas on a TPU), which stays the reference:
an accessor (Range / ReducedRowMajor) decoupling storage precision from
arithmetic precision, and the DOT and GEMV families, each in fixed-precision,
accessor mixed-precision and vendor tiers. CUDA tensors run hand-written
kernels built from ``csrc/`` at first use; CPU tensors run the same functions
in plain torch ops. This package never imports jax.
"""

from .accessor.dtypes import canon, promote
from .accessor.range import Range, ReducedRowMajor, make_range
from .ops.df64 import DF
from .ops.dot import acc_dot, dot, xla_dot
from .ops.gemv import acc_gemv, gemv, xla_gemv

__version__ = "0.1.0"

__all__ = [
    "Range",
    "ReducedRowMajor",
    "make_range",
    "DF",
    "canon",
    "promote",
    "dot",
    "acc_dot",
    "xla_dot",
    "gemv",
    "acc_gemv",
    "xla_gemv",
]
