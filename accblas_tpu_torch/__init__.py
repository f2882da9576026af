"""accblas_tpu_torch: the accessor BLAS on PyTorch, with CUDA kernels for an
NVIDIA H100 (sm_90a).

The port of ``accblas_tpu`` (JAX/Pallas on a TPU), which stays the reference:
an accessor (Range / ReducedRowMajor) decoupling storage precision from
arithmetic precision, and the DOT, GEMV and TRSV/TRSM families, each in
fixed-precision, accessor mixed-precision and vendor tiers. CUDA tensors run hand-written
kernels built from ``csrc/`` at first use; CPU tensors run the same functions
in plain torch ops. The mixed-precision solvers (CG, Richardson refinement,
the power method) are in ``accblas_tpu_torch.models``. This package never
imports jax.
"""

from .accessor.dtypes import canon, promote
from .accessor.range import Range, ReducedRowMajor, make_range
from .ops.df64 import DF
from .ops.dot import acc_dot, dot, xla_dot
from .ops.gemv import acc_gemv, gemv, xla_gemv
from .ops.trsv import acc_trsm, acc_trsv, trsm, trsv, xla_trsm, xla_trsv

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
    "trsv",
    "acc_trsv",
    "xla_trsv",
    "trsm",
    "acc_trsm",
    "xla_trsm",
]
