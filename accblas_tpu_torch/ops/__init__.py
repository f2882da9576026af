"""Kernel layer: df64 arithmetic, and the DOT, GEMV, TRSV/TRSM and
triangular-residual families, each a CUDA kernel (``csrc/``) for CUDA
tensors beside a plain torch version for CPU tensors. Import the submodules
(``ops.dot``, ``ops.gemv``, ``ops.trsv``, ``ops.tri_gemv``) directly: their
launch counters live there."""
