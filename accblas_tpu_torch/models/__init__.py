"""Application tier: mixed-precision iterative solvers on the accessor
kernels (counterpart of ``accblas_tpu.models``)."""

from .solvers import cg, lu_refine, power_iterate, power_method, richardson_refine

__all__ = ["cg", "lu_refine", "richardson_refine", "power_method", "power_iterate"]
