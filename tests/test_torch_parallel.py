"""The port's sharded layer (accblas_tpu_torch.parallel) against the JAX
package's (accblas_tpu.parallel) on identical inputs and mesh shapes,
covering the cases of tests/test_parallel.py and tests/test_fuzz_parallel.py:
here DOT and GEMV over storage x tier, with the helpers of the other files
(test_torch_parallel_df64.py: the df64 GEMV combine;
test_torch_parallel_solve.py: TRSM, CG and the power step;
test_torch_parallel_trsv.py: TRSV).

The port's ops run once for each module, on 4 ranks spawned over gloo
on the CPU (``launch.run(launch.apply, ...)``), each rank on its blocks cut
from the same numpy inputs; the JAX ops run here on a JAX mesh of the same
shape from ``make_mesh(4)`` over conftest's CPU devices (their Pallas
kernels in interpret mode, as their own tests run, each op under jit). The
default mesh is
2 x 2, so a "sign block per cols shard" input has 2 blocks, not the JAX
tests' 4 (on 2 x 2 those 4 would cancel inside each shard).

Each port result is held to the JAX test's own oracle bound against float64
on the stored values, and its gap to the JAX result to twice the JAX op's
own error plus a floor: F32_FLOOR (four units of f32 roundoff, relative) for
results rounded to f32 or narrower, DF_FLOOR (2^-48) for df64 results. Two
sum orders of the same tier (gloo against XLA's psum, the plain torch
versions against the Pallas kernels) part by that much.
"""

from __future__ import annotations

import concurrent.futures
import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from accblas_tpu import parallel as jpar
from accblas_tpu_torch.ops import dot as tdot
from accblas_tpu_torch.parallel import launch
from accblas_tpu_torch.parallel.launch import Call, Sharded
from accblas_tpu_torch.utils import MatrixInfo, gen_mtx, interop

torch.set_num_threads(1)

RANKS = 4
ROWS = COLS = 2  # make_mesh(4)
F32_FLOOR = 2.0**-21
DF_FLOOR = 2.0**-48
# the fuzz tests' floors: (storage, ar) -> relative error budget (1-norm)
FLOOR = {("f32", "f32"): 3e-5, ("bf16", "f32"): 3e-2,
         ("f32", "df64"): 3e-6, ("bf16", "df64"): 3e-2}
RNG = np.random.Generator(np.random.Philox(20261017))

_P = "accblas_tpu_torch.parallel.blas:"


class Case(NamedTuple):
    call: Call  # the port's op on the ranks
    want: Callable  # the JAX op on the same inputs and mesh shape -> float64
    ref: np.ndarray  # float64 oracle on the stored inputs
    err: Callable  # err(got, ref): the JAX test's metric
    bound: float  # the JAX test's bound on err
    floor: float = F32_FLOOR


@functools.lru_cache(maxsize=None)
def _jmesh(shape=None, axes=("rows", "cols")):
    return jpar.make_mesh(RANKS, axes=axes, shape=shape)


def _j(v32, st="f32"):
    a = jnp.asarray(v32)
    return a.astype(jnp.bfloat16) if st == "bf16" else a


def _stored(v32, st="f32") -> np.ndarray:
    return np.asarray(_j(v32, st).astype(jnp.float32), np.float64)


def _f64(v) -> np.ndarray:
    if hasattr(v, "hi"):
        return np.asarray(v.hi, np.float64) + np.asarray(v.lo, np.float64)
    return np.asarray(jnp.asarray(v).astype(jnp.float32), np.float64)


def _jax(fn, *args) -> np.ndarray:
    """The JAX op under jit (one compiled program: eager shard_map runs the
    interpret-mode kernels op by op, several times slower), as float64."""
    return _f64(jax.jit(fn)(*args))


def _vec(n, seed):
    return gen_mtx(MatrixInfo(1, n), seed=seed)[0].astype(np.float32)


def _mat(m, n, seed):
    return gen_mtx(MatrixInfo(m, n), seed=seed).astype(np.float32)


def rel1(got, ref):
    return float(np.abs(got - ref).sum() / np.abs(ref).sum())


def relmax(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def rel2(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


# --------------------------------------------------------------------------
# the cases
# --------------------------------------------------------------------------

def pdot_case(n, st, ar, seed, shape=None, precise=False, bound=None):
    """tests/test_fuzz_parallel.py::test_fuzz_pdot (error over the
    cancellation-free scale sum |x y|); with `bound`,
    tests/test_parallel.py::test_pdot_matches_local (error over |x . y|)."""
    x, y = _vec(n, seed), _vec(n, seed + 1)
    xs, ys = _stored(x, st), _stored(y, st)
    scale = float(np.abs(xs * ys).sum()) if bound is None else abs(float(xs @ ys))
    call = Call(_P + "pdot", (Sharded(x, ("cols",), st=st), Sharded(y, ("cols",), st=st)),
                {"axis": "cols", "ar": ar, "precise": precise}, shape=shape)
    return Case(call,
                lambda: _jax(lambda u, v: jpar.pdot(u, v, _jmesh(shape), axis="cols", ar=ar,
                                                    precise=precise), _j(x, st), _j(y, st)),
                np.float64(xs @ ys), lambda g, r: abs(float(g) - float(r)) / scale,
                FLOOR[(st, ar)] if bound is None else bound,
                DF_FLOOR if ar == "df64" else F32_FLOOR)


# the control's mesh: on two cols shards the cancelling pair of hi partials
# subtracts exactly (Sterbenz), so a component-wise sum loses nothing there;
# four shards with signs (+, +, -, -) make the hi sum round in any order
CONTROL_SHAPE = (1, 4)


def _cancel_dot_inputs(shape=None, n=8192):
    """tests/test_parallel.py::test_pdot_df64_exact_combine's construction
    with one sign block per cols shard of the mesh `shape` (2 x 2 if None):
    partials of +-n/(32 shards) that cancel across the ranks to ~0.3."""
    cols = COLS if shape is None else shape[1]
    signs = [1.0, -1.0] if cols == 2 else [1.0, 1.0, -1.0, -1.0]
    rng = np.random.default_rng(7)
    base = np.repeat(signs, n // cols) / 32.0
    x = (base + rng.uniform(-1.0, 1.0, n) * 1e-2).astype(np.float32)
    return x, np.ones(n, np.float32)


def pdot_df64_cancel_case(shape=None):
    """tests/test_parallel.py::test_pdot_df64_exact_combine (< 1e-12 of the
    float64 value of the stored inputs)."""
    x, y = _cancel_dot_inputs(shape)
    ref = float(x.astype(np.float64) @ y.astype(np.float64))
    call = Call(_P + "pdot", (Sharded(x, ("cols",)), Sharded(y, ("cols",))),
                {"axis": "cols", "ar": "df64", "precise": True}, shape=shape)
    return Case(call, lambda: _jax(lambda u, v: jpar.pdot(u, v, _jmesh(shape), axis="cols",
                                                          ar="df64", precise=True), _j(x), _j(y)),
                np.float64(ref), lambda g, r: abs(float(g) - float(r)) / abs(float(r)), 1e-12,
                DF_FLOOR)


def pgemv_case(m, n, st, ar, alpha, beta, seed, shape=None, res_nan=False, axes=None,
               bound=None):
    """tests/test_fuzz_parallel.py::test_fuzz_pgemv (1-norm error); `bound`
    for the cases of tests/test_parallel.py (1e-5)."""
    a, x = _mat(m, n, seed), _vec(n, seed + 1)
    r = np.full(m, np.nan, np.float32) if res_nan else _vec(m, seed + 2)
    ref = alpha * (_stored(a, st) @ _stored(x, st))
    if beta != 0:
        ref = ref + beta * r.astype(np.float64)
    ra, ca = axes or ("rows", "cols")
    # numpy scalars are runtime values (traced under jit, tensors on the
    # ranks); python numbers stay static, so a beta of 0 never reads res
    traced = (alpha, beta) if isinstance(alpha, np.floating) else ()
    args = (Sharded(a, (ra, ca), st=st), Sharded(x, (ca,), st=st), Sharded(r, (ra,)),
            *((np.asarray(v, np.float32) for v in traced) if traced else (alpha, beta)))
    kw = {"ar": ar} if axes is None else {"ar": ar, "row_axis": ra, "col_axis": ca}
    call = Call(_P + "pgemv", args, kw, out=(((ra,), (m,)),), shape=shape,
                axes=axes or ("rows", "cols"))
    return Case(call,
                lambda: _jax(lambda a_, x_, r_, *ab: jpar.pgemv(
                    a_, x_, r_, *(ab or (alpha, beta)), ar=ar,
                    mesh=_jmesh(shape, axes or ("rows", "cols")),
                    **({} if axes is None else {"row_axis": ra, "col_axis": ca})),
                    _j(a, st), _j(x, st), _j(r), *traced),
                ref, rel1, FLOOR[(st, ar)] if bound is None else bound)


def _cancel_gemv_inputs(m=64, n=8192):
    rng = np.random.default_rng(11)
    base = np.repeat([1.0, -1.0], n // COLS)[None, :] / 32.0
    return (base + rng.uniform(-1.0, 1.0, (m, n)) * 1e-3).astype(np.float32)


def pgemv_cancel_case(ar):
    """tests/test_parallel.py::test_pgemv_df64_exact_combine, a sign block
    per cols shard; both tiers (the df64 one must beat f32 by 5x)."""
    a = _cancel_gemv_inputs()
    m, n = a.shape
    x, r = np.ones(n, np.float32), np.zeros(m, np.float32)
    call = Call(_P + "pgemv", (Sharded(a, ("rows", "cols")), Sharded(x, ("cols",)),
                               Sharded(r, ("rows",)), 1.0, 0.0), {"ar": ar},
                out=((("rows",), (m,)),))
    return Case(call, lambda: _jax(lambda a_, x_, r_: jpar.pgemv(a_, x_, r_, 1.0, 0.0, ar=ar,
                                                                 mesh=_jmesh()),
                                   _j(a), _j(x), _j(r)),
                a.astype(np.float64) @ np.ones(n), rel1, 2e-4 if ar == "df64" else 1.0)


def _triangle(n, unit, seed):
    """The fuzz tests' conditioning: unit solves |off-diag| ~ 1/n; non-unit
    the LU factor of a diagonally dominant matrix."""
    if unit:
        return gen_mtx(MatrixInfo(n, n), seed=seed) / n
    lu, _ = scipy.linalg.lu_factor(gen_mtx(MatrixInfo(n, n), seed=seed) + np.eye(n) * (0.25 * n))
    return lu


def _tri_ref(lu, b64, uplo, unit):
    t = np.tril(lu) if uplo == "lower" else np.triu(lu)
    if unit:
        np.fill_diagonal(t, 1.0)
    return scipy.linalg.solve_triangular(t.astype(np.float32).astype(np.float64), b64,
                                         lower=(uplo == "lower"))


def ptrsm_case(n, k, uplo, unit, ar, seed):
    """tests/test_fuzz_parallel.py::test_fuzz_ptrsm (1-norm, < 3e-5)."""
    lu = _triangle(n, unit, seed).astype(np.float32)
    b = gen_mtx(MatrixInfo(k, n), seed=seed + 7).T.astype(np.float32).copy()
    ref = _tri_ref(lu, b.astype(np.float64), uplo, unit)
    call = Call(_P + "ptrsm", (lu, Sharded(b, (None, "cols")), uplo, unit), {"ar": ar},
                out=(((None, "cols"), (n, k)),))
    return Case(call, lambda: _jax(lambda t, b_: jpar.ptrsm(t, b_, uplo, unit, ar=ar,
                                                            mesh=_jmesh()), _j(lu), _j(b)),
                ref, rel1, 3e-5)


def ptrsm_lu_case():
    """tests/test_parallel.py::test_ptrsm_matches_local (max, < 1e-4)."""
    n, k = 256, 32
    lu, _ = scipy.linalg.lu_factor(gen_mtx(MatrixInfo(n, n), seed=11))
    lu = lu.astype(np.float32)
    b = _mat(n, k, 12)
    ref = scipy.linalg.solve_triangular(np.triu(lu).astype(np.float64), b.astype(np.float64))
    call = Call(_P + "ptrsm", (lu, Sharded(b, (None, "cols")), "upper", False), {"ar": "f32"},
                out=(((None, "cols"), (n, k)),))
    return Case(call, lambda: _jax(lambda t, b_: jpar.ptrsm(t, b_, "upper", False, ar="f32",
                                                            mesh=_jmesh()), _j(lu), _j(b)),
                ref, relmax, 1e-4)


def ptrsv_case(n, uplo, unit, ar, seed, shape=None):
    """tests/test_fuzz_parallel.py::test_fuzz_ptrsv (1-norm, < 3e-5); ragged
    n pads an identity tail."""
    lu = _triangle(n, unit, seed).astype(np.float32)
    b = _vec(n, seed + 7)
    ref = _tri_ref(lu, b.astype(np.float64), uplo, unit)
    call = Call(_P + "ptrsv", (Sharded(lu, ("rows", None), identity_tail=True),
                               Sharded(b, ("rows",)), uplo, unit), {"ar": ar},
                out=((("rows",), (n,)),), shape=shape)
    return Case(call, lambda: _jax(lambda t, b_: jpar.ptrsv(t, b_, uplo, unit, ar=ar,
                                                            mesh=_jmesh(shape)), _j(lu), _j(b)),
                ref, rel1, 3e-5)


def _spd(n, seed, ridge):
    s = gen_mtx(MatrixInfo(n, n), seed=seed)
    return (s @ s.T / n + np.eye(n) * ridge).astype(np.float32)


def pcg_case(n, ar, iters, tol, seed, st="f32", shape=None, axes=None, bound=1e-4, ridge=2.0):
    """tests/test_parallel.py::test_pcg_matches_direct and
    test_pcg_df64_dots (2-norm against the direct solve, < 1e-4)."""
    a, b = _spd(n, seed, ridge), _vec(n, seed + 1)
    ref = np.linalg.solve(_stored(a, st), b.astype(np.float64))
    ra, ca = axes or ("rows", "cols")
    kw = {"iters": iters, "ar": ar, "tol": tol}
    if axes is not None:
        kw.update(row_axis=ra, col_axis=ca)
    call = Call(_P + "pcg", (Sharded(a, (ra, ca), st=st), Sharded(b, (ca,))), kw,
                out=(((ca,), (n,)), None, None), shape=shape, axes=axes or ("rows", "cols"))
    mesh_axes = axes or ("rows", "cols")
    return Case(call, lambda: _jax(lambda a_, b_: jpar.pcg(a_, b_, mesh=_jmesh(shape, mesh_axes),
                                                          **kw)[0], _j(a, st), _j(b)),
                ref, rel2, bound)


def _uneven(mult, lo, hi):
    return mult * int(RNG.integers(lo, hi)) + int(RNG.integers(1, mult))


class PortResults:
    """Every case's port result from one launch of 4 ranks, run on a thread
    while the test process runs the JAX side: ``results[name]`` is (rank 0's
    result, whether every rank returned the same values), for the cases
    and the `extra` (name, Call) pairs."""

    def __init__(self, cases: dict, extra=()):
        self._names = list(cases) + [k for k, _ in extra]
        calls = [cases[k].call for k in cases] + [c for _, c in extra]
        self._pool = concurrent.futures.ThreadPoolExecutor(1)
        self._future = self._pool.submit(launch.run, launch.apply, RANKS, calls, "cpu",
                                         device="cpu", timeout=300)

    def __getitem__(self, name):
        per_rank = self._future.result()
        i = self._names.index(name)
        same = all(all(np.array_equal(u, v, equal_nan=True)
                       for u, v in zip(r[i]["values"], per_rank[0][i]["values"]))
                   for r in per_rank)
        return per_rank[0][i], same

    def close(self):
        self._pool.shutdown()


def port_fixture(cases: dict, extra=()):
    results = PortResults(cases, extra)
    yield results
    results.close()


def check_case(case: Case, results: PortResults, name: str):
    """The port's result within the JAX test's bound of the oracle, the
    same on every rank, and within 2 x the JAX op's error + the floor of
    the JAX op's result."""
    want = case.want()
    res, same = results[name]
    got = res["values"][0]
    assert same, "the ranks returned different results"
    assert np.all(np.isfinite(got))
    err = case.err(got, case.ref)
    assert err < case.bound, (err, case.bound)
    jax_err = case.err(want, case.ref)
    gap = case.err(got, want)
    assert gap <= 2 * jax_err + case.floor, (gap, jax_err)


# the mesh shapes besides make_mesh(4)'s 2 x 2 (tests/test_fuzz_parallel.py::
# test_fuzz_mesh_shapes), with sizes uneven against every extent
ALT_SHAPES = [(1, 4), (4, 1)]
ALT_N, ALT_M = 4 * 37 + 3, 4 * 23 + 5


def _tag(shape):
    return f"mesh{shape[0]}x{shape[1]}"


# DOT: every storage x tier of FLOOR on uneven n, the JAX tests' cases, and
# the cancellation construction on 2 x 2 (two sign blocks) and on 1 x 4
# (four, the control's mesh)
CASES = {
    "pdot_f32": pdot_case(8192, "f32", "f32", 42, bound=1e-5),
    "pdot_df64_cancel": pdot_df64_cancel_case(),
    "pdot_df64_cancel_1x4": pdot_df64_cancel_case(CONTROL_SHAPE),
}
for _st in ("f32", "bf16"):
    for _ar in ("f32", "df64"):
        _n = _uneven(COLS, 40, 2000)
        CASES[f"pdot_{_st}_{_ar}_uneven"] = pdot_case(_n, _st, _ar, _n)
for _shape in ALT_SHAPES:
    CASES[f"{_tag(_shape)}_pdot_df64"] = pdot_case(ALT_N, "f32", "df64", _shape[0] * 100 + ALT_N,
                                                   _shape)
# GEMV
CASES.update({
    "pgemv_alpha_beta": pgemv_case(512, 1024, "f32", "f32", 1.5, -0.5, 1, bound=1e-5),
    "pgemv_tensor_alpha_beta_f32": pgemv_case(128, 256, "f32", "f32", np.float32(2.0),
                                              np.float32(0.5), 52, bound=1e-5),
    "pgemv_beta0_nan_f32": pgemv_case(256, 512, "f32", "f32", 1.0, 0.0, 50, res_nan=True,
                                      bound=1e-5),
    "pgemv_cancel_f32": pgemv_cancel_case("f32"),
    "pgemv_custom_axes": pgemv_case(130, 257, "f32", "f32", 1.0, 1.0, 31, axes=("r", "c")),
})
# bf16 storage in df64, uneven (the other df64 cases: test_torch_parallel_df64.py)
_m, _n = _uneven(ROWS, 8, 32), _uneven(COLS, 16, 200)
CASES["pgemv_bf16_df64_uneven"] = pgemv_case(_m, _n, "bf16", "df64", 1.5, -0.5, _m + _n)
for _st, _beta in (("f32", 0.0), ("bf16", -0.5)):
    _m, _n = ROWS * int(RNG.integers(8, 200)), COLS * int(RNG.integers(16, 200))
    CASES[f"pgemv_{_st}_f32_beta{_beta:g}"] = pgemv_case(_m, _n, _st, "f32", 1.5, _beta,
                                                         _m * 1000 + _n)
    _m, _n = _uneven(ROWS, 8, 200), _uneven(COLS, 16, 200)
    CASES[f"pgemv_{_st}_f32_uneven"] = pgemv_case(_m, _n, _st, "f32", 1.5, 1.0, _m + _n)


def _control_partials() -> np.ndarray:
    """The (hi, lo) DOT partial of each cols shard of the 1 x 4 cancellation
    input: the port's acc_dot on the block each rank holds."""
    x, y = _cancel_dot_inputs(CONTROL_SHAPE)
    blk = x.shape[0] // CONTROL_SHAPE[1]
    out = []
    for c in range(CONTROL_SHAPE[1]):
        d = tdot.acc_dot(interop.from_numpy(x[c * blk:(c + 1) * blk]),
                         interop.from_numpy(y[c * blk:(c + 1) * blk]), "df64", precise=True)
        out.append([float(d.hi), float(d.lo)])
    return np.asarray(out, np.float32)


@pytest.fixture(scope="module")
def port():
    # the control: the per-rank DF partials summed hi with hi and lo with lo
    # by one all-reduce over cols
    control = Call("accblas_tpu_torch.parallel.collectives:all_reduce_sum",
                   (Sharded(_control_partials(), ("cols", None)), "cols"), shape=CONTROL_SHAPE)
    yield from port_fixture(CASES, [("control", control)])


@pytest.mark.parametrize("name", list(CASES))
def test_port_against_jax(port, name):
    check_case(CASES[name], port, name)


def test_pdot_df64_control_has_teeth(port):
    """A component-wise all-reduce of the (hi, lo) partials of the 1 x 4
    cancellation input (the bug the gather-and-fold combine prevents) reads
    >= 1e-7 relative; the exact combine reads < 1e-12 on the same input
    (and on 2 x 2: the parity cases)."""
    res, same = port["control"]
    hi, lo = res["values"][0][0]  # the hi sum and the lo sum, each rounded in f32
    x, y = _cancel_dot_inputs(CONTROL_SHAPE)
    ref = float(x.astype(np.float64) @ y.astype(np.float64))
    assert same and res["counts"] == {("all_reduce", "cols", "float32"): 1}
    assert abs(float(hi) + float(lo) - ref) / abs(ref) >= 1e-7
    exact = port["pdot_df64_cancel_1x4"][0]["values"][0]
    assert abs(float(exact) - ref) / abs(ref) < 1e-12


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_mesh_factors_the_world_as_jax(n):
    from accblas_tpu_torch.parallel.mesh import _factor

    assert _factor(n) == jpar.make_mesh(n).devices.shape
