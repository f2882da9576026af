"""The benchmark of ``accblas_tpu_torch`` on one NVIDIA H100.

One command runs one cell once (``python3 blasbench/run.py --workload NAME
--seed N --seconds S --trace 0|1``, or ``python3 -m blasbench.run``). A cell
is an entry of ``workloads`` in the checkout's ``BENCHMARK.json``: one
configuration (``configs/<config>.json``) under one traffic mix
(``traffic/<mix>.json``). The mix names the op whose driver
(``drivers/<op>.py``) makes the inputs from the seed, issues the public
call and judges the answers against the plain float64 reference
(``reference/``). Each metric is a reader of its own
(``metrics/<metric>.py``), or that of its family where a quantity is split
by cell (``metrics/throughput_gbps.py`` reads ``throughput_gbps.dot``), and
declares the port's counters it reads. Everything is found by name, so a
cell, a mix or a metric is added with new files and new ``BENCHMARK.json``
entries.

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or ``accblas_tpu``, and
``reference/`` imports nothing of ``accblas_tpu_torch``.
"""

from pathlib import Path

# the package's own directory, and the checkout that holds it
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
