"""Application tier: mixed-precision iterative solvers on the accessor
kernels (counterpart of ``accblas_tpu.models``)."""

from .solvers import cg, power_iterate, power_method, richardson_refine

__all__ = ["cg", "richardson_refine", "power_method", "power_iterate"]
