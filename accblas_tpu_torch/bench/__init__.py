"""Benchmark and error-analysis drivers: ``dot_benchmark``,
``gemv_benchmark``, ``trsv_benchmark`` (each ``python -m``-runnable, `;`-CSV
on stdout) and ``plot``. Counterpart of ``accblas_tpu.bench``."""
