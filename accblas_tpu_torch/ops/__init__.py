"""Kernel layer: df64 arithmetic, and the DOT and GEMV families, each a CUDA
kernel (``csrc/``) for CUDA tensors beside a plain torch version for CPU
tensors. Import the submodules (``ops.dot``, ``ops.gemv``) directly: their
``launches`` counters live there."""
