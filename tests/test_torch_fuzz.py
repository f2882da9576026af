"""The port's seeded configuration fuzz on the CPU: tests/test_fuzz.py's own
case lists (the same seeded Philox stream), each case through the port's
plain versions and through the JAX op on the same stored values, both held
to the JAX module's floors against float64 and the port to the same floor
of the JAX result.

The card half (the kernels against their plain versions on these cases,
every ``resident``, and the CUDA route's edges) is in test_torch_cuda.py,
whose copy of the case lists is checked here against the JAX module's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import accblas_tpu_torch as port
from accblas_tpu.ops import dot as jdot
from accblas_tpu.ops import gemv as jgemv
from accblas_tpu.ops import trsv as jtrsv
from accblas_tpu.utils import MatrixInfo, gen_mtx
from test_fuzz import DOT_CASES, FLOOR, GEMV_CASES, GEMV_NARROW_CASES, NARROW_CASES, TRSV_CASES
from test_torch_cuda import fuzz_cases

torch.set_num_threads(1)

_JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16,
        "f8e4m3": jnp.float8_e4m3fn}
_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16,
          "f8e4m3": torch.float8_e4m3fn}


def _both(v64, st):
    """The stored values as a JAX array and a torch tensor, and in float64."""
    j = jnp.asarray(np.asarray(v64, np.float32)).astype(_JNP[st])
    f = np.array(j.astype(jnp.float32))
    return j, torch.from_numpy(f).to(_TORCH[st]), f.astype(np.float64)


def _scalar(v) -> float:
    if isinstance(v, port.DF):
        return float(v.hi) + float(v.lo)
    if hasattr(v, "hi"):  # the JAX DF
        return float(v.hi) + float(v.lo)
    return float(v)


def test_case_lists_are_the_jax_modules():
    """The card half's copy of the case lists draws the JAX module's."""
    cases = fuzz_cases()
    assert cases["dot"] == DOT_CASES and cases["gemv"] == GEMV_CASES
    assert cases["dot_narrow"] == NARROW_CASES and cases["gemv_narrow"] == GEMV_NARROW_CASES
    assert [tuple(c) for c in cases["trsv"]] == [tuple(c) for c in TRSV_CASES]


def _check_dot(n, st, ar, floor, seeds):
    xj, xt, x64 = _both(gen_mtx(MatrixInfo(1, n), seed=seeds[0])[0], st)
    yj, yt, y64 = _both(gen_mtx(MatrixInfo(1, n), seed=seeds[1])[0], st)
    # relative to sum |x y|, as the JAX module measures: a dot can cancel
    ref, scale = float(x64 @ y64), float(np.abs(x64 * y64).sum())
    got = _scalar(port.acc_dot(xt, yt, ar=ar))
    want = _scalar(jdot.acc_dot(xj, yj, ar=ar))
    assert abs(got - ref) / scale < floor
    assert abs(want - ref) / scale < floor
    assert abs(got - want) / scale < floor


@pytest.mark.parametrize("n,st,ar", DOT_CASES)
def test_fuzz_dot(n, st, ar):
    _check_dot(n, st, ar, FLOOR[(st, ar)], (n, n + 1))


@pytest.mark.parametrize("n,st", NARROW_CASES)
def test_fuzz_dot_narrow(n, st):
    _check_dot(n, st, "f32", 1e-4, (n + 3, n + 4))


def _check_gemv(m, n, st, ar, floor, seeds):
    aj, at, a64 = _both(gen_mtx(MatrixInfo(m, n), seed=seeds[0]), st)
    xj, xt, x64 = _both(gen_mtx(MatrixInfo(1, n), seed=seeds[1])[0], st)
    rj, rt, r64 = _both(gen_mtx(MatrixInfo(1, m), seed=seeds[2])[0], "f32")
    ref = a64 @ x64 + r64
    got = port.acc_gemv(at, xt, rt, 1.0, 1.0, ar=ar).double().numpy()
    want = np.asarray(jgemv.acc_gemv(aj, xj, rj, 1.0, 1.0, ar=ar).astype(jnp.float32), np.float64)

    def rel(v, w):
        return np.abs(v - w).sum() / np.abs(w).sum()

    assert rel(got, ref) < floor, f"rel={rel(got, ref):.2e}"
    assert rel(want, ref) < floor
    assert rel(got, want) < floor


@pytest.mark.parametrize("m,n,st,ar", GEMV_CASES)
def test_fuzz_gemv(m, n, st, ar):
    _check_gemv(m, n, st, ar, FLOOR[(st, ar)], (m * 1000 + n, n, m))


@pytest.mark.parametrize("m,n,st", GEMV_NARROW_CASES)
def test_fuzz_gemv_narrow(m, n, st):
    _check_gemv(m, n, st, "f32", 1e-4, (m * 991 + n, n + 5, m + 6))


TRSV_FLOOR = 3e-5  # tests/test_fuzz.py's TRSV bound, both tiers


@pytest.mark.parametrize("n,uplo,unit,nrhs,ar", TRSV_CASES)
def test_fuzz_trsv(n, uplo, unit, nrhs, ar):
    uplo = str(uplo)
    if unit:
        # the JAX module's recipe: |off-diagonal| ~ 1/n keeps a unit solve
        # bounded
        lu = gen_mtx(MatrixInfo(n, n), seed=n) / n
    else:
        lu, _ = scipy.linalg.lu_factor(gen_mtx(MatrixInfo(n, n), seed=n) + np.eye(n) * (0.25 * n))
    t = np.tril(lu) if uplo == "lower" else np.triu(lu)
    if unit:
        np.fill_diagonal(t, 1.0)
    b64 = gen_mtx(MatrixInfo(max(nrhs, 1), n), seed=n + 7)
    a32 = lu.astype(np.float32)
    b32 = np.ascontiguousarray(b64[0] if nrhs == 0 else b64.T, np.float32)
    ref = scipy.linalg.solve_triangular(t, b64.T, lower=uplo == "lower")
    ref = ref[:, 0] if nrhs == 0 else ref
    aj, bj = jnp.asarray(a32), jnp.asarray(b32)
    at, bt = torch.from_numpy(a32), torch.from_numpy(b32)
    if nrhs == 0:
        fj, fp = (jtrsv.trsv, port.trsv) if ar == "f32" else (jtrsv.acc_trsv, port.acc_trsv)
    else:
        fj, fp = (jtrsv.trsm, port.trsm) if ar == "f32" else (jtrsv.acc_trsm, port.acc_trsm)
    kw = {} if ar == "f32" else {"ar": "df64"}
    got = fp(at, bt, uplo, unit, **kw).double().numpy()
    want = np.asarray(fj(aj, bj, uplo, unit, **kw), np.float64)

    def rel(v, w):
        return np.abs(v - w).sum() / np.abs(w).sum()

    assert rel(got, ref) < TRSV_FLOOR, f"rel={rel(got, ref):.2e}"
    assert rel(want, ref) < TRSV_FLOOR
    assert rel(got, want) < TRSV_FLOOR
