"""Error-analysis reductions — accurate host-side reference math in numpy.

The numpy paths of ``accblas_tpu.utils.compare``, bit for bit:
- ``tree_reduce``: in-place binary-tree (halving) reduction with an arbitrary
  op, so "the error of the error stays small";
- ``compare``: 1-norm of the elementwise absolute difference between a
  result and the fp64 reference;
- ``relative_error``: ||result - ref||_1 / ||ref||_1.
"""

from __future__ import annotations

import numpy as np


def tree_reduce(vals: np.ndarray, op=np.add) -> float:
    """Binary-tree (pairwise/halving) reduction."""
    cur = np.asarray(vals, np.float64).ravel().copy()
    n = cur.size
    if n == 0:
        return 0.0
    while n > 1:
        half = n // 2
        rem = n - 2 * half
        cur[:half] = op(cur[:half], cur[half : 2 * half])
        if rem:
            cur[half] = cur[2 * half]
        n = half + rem
    return float(cur[0])


def compare(result: np.ndarray, reference: np.ndarray) -> float:
    """1-norm of |result - reference| via tree reduction."""
    a = np.asarray(result, np.float64).ravel()
    b = np.asarray(reference, np.float64).ravel()
    return tree_reduce(np.abs(a - b))


def norm1(x: np.ndarray) -> float:
    """1-norm through the same pairwise accumulator as `compare`."""
    return tree_reduce(np.abs(np.asarray(x, np.float64)).ravel())


def relative_error(result: np.ndarray, reference: np.ndarray) -> float:
    """GEMV/TRSV error metric: ||result - ref||_1 / ||ref||_1."""
    denom = norm1(reference)
    return compare(result, reference) / denom if denom else float("nan")
