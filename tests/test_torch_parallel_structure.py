"""Collective structure of the port's sharded layer, pinned by the counter
of accblas_tpu_torch.parallel.collectives, as tests/test_parallel_structure.py
pins the JAX package's jaxprs: each op runs on 4 ranks (a 2 x 2 mesh over
gloo on the CPU) and the counts of the collectives it issued, by (op, axis,
dtype), are held to the pattern its cost and its exactness assume.

Two counts differ from the JAX jaxprs by design: the df64 combines gather
the (hi, lo) partials stacked in one all_gather (JAX: one each), and the
reshard from rows to cols blocks, which XLA inserts for a sharding
constraint outside the jaxpr, is an explicit, counted all_gather over rows
here (power_step, and every matvec of pcg)."""

import collections

import numpy as np
import pytest
import torch

from accblas_tpu_torch.parallel import launch
from accblas_tpu_torch.parallel.launch import Call, Sharded
from accblas_tpu_torch.utils import MatrixInfo, gen_mtx

torch.set_num_threads(1)

N = 256
D = 2  # the rows extent of the 2 x 2 mesh
_P = "accblas_tpu_torch.parallel.blas:"


def _vec(n, seed):
    return gen_mtx(MatrixInfo(1, n), seed=seed)[0].astype(np.float32)


def _mat(seed, ridge=0.0):
    a = gen_mtx(MatrixInfo(N, N), seed=seed)
    return (a @ a.T / N + np.eye(N) * ridge if ridge else a).astype(np.float32)


_A, _B = _mat(3), _mat(11, ridge=2.0)
_T = (np.triu(_mat(6)) / N + np.eye(N)).astype(np.float32)
_X, _Y, _R = _vec(N, 1), _vec(N, 2), _vec(N, 5)
_AX = (Sharded(_A, ("rows", "cols")), Sharded(_X, ("cols",)), Sharded(_R, ("rows",)))
CALLS = {
    "pdot_f32": Call(_P + "pdot", (Sharded(_X, ("cols",)), Sharded(_Y, ("cols",))),
                     {"axis": "cols"}),
    "pdot_df64": Call(_P + "pdot", (Sharded(_X, ("cols",)), Sharded(_Y, ("cols",))),
                      {"axis": "cols", "ar": "df64", "precise": True}),
    "pgemv_f32": Call(_P + "pgemv", _AX + (1.0, 1.0), {}),
    "pgemv_df64": Call(_P + "pgemv", _AX + (1.0, 1.0), {"ar": "df64"}),
    "ptrsv": Call(_P + "ptrsv", (Sharded(_T, ("rows", None), identity_tail=True),
                                 Sharded(_X, ("rows",)), "upper", False), {}),
    "ptrsm": Call(_P + "ptrsm", (_T, Sharded(np.stack([_X, _Y], 1), (None, "cols")), "upper",
                                 True), {}),
    "power_step": Call(_P + "power_step", _AX, {}, out=(None, None)),
    "pcg_f32": Call(_P + "pcg", (Sharded(_B, ("rows", "cols")), Sharded(_X, ("cols",))),
                    {"iters": 3, "ar": "f32"}, out=(None, None, None)),
    "pcg_df64": Call(_P + "pcg", (Sharded(_B, ("rows", "cols")), Sharded(_X, ("cols",))),
                     {"iters": 3, "ar": "df64"}, out=(None, None, None)),
}


@pytest.fixture(scope="module")
def counts():
    """{name: Counter of (op, axis) over the call}, every rank's the same."""
    per_rank = launch.run(launch.apply, 4, list(CALLS.values()), "cpu", device="cpu",
                          timeout=300)
    out = {}
    for i, name in enumerate(CALLS):
        seen = [r[i]["counts"] for r in per_rank]
        assert all(c == seen[0] for c in seen), (name, seen)
        out[name] = collections.Counter()
        for (op, axis, _), n in seen[0].items():
            out[name][(op, axis)] += n
    return out


def _ops(c, op):
    return sum(n for (o, _), n in c.items() if o == op)


def test_pdot_f32_is_one_all_reduce(counts):
    assert counts["pdot_f32"] == {("all_reduce", "cols"): 1}


def test_pdot_df64_gathers_df_pairs_never_all_reduces(counts):
    """The exact combine: one all_gather of the stacked (hi, lo) partials
    and no all-reduce: a component-wise sum of a DF is the exactness bug."""
    assert counts["pdot_df64"] == {("all_gather", "cols"): 1}


def test_pgemv_f32_is_one_all_reduce_over_cols(counts):
    assert counts["pgemv_f32"] == {("all_reduce", "cols"): 1}


def test_pgemv_df64_gathers_df_pairs_never_all_reduces(counts):
    assert counts["pgemv_df64"] == {("all_gather", "cols"): 1}


def test_ptrsv_is_d_gathers_no_all_reduce(counts):
    """d dependency-ordered gathers of n/d lanes over rows, nothing else."""
    assert counts["ptrsv"] == {("all_gather", "rows"): D}


def test_ptrsm_has_no_collective(counts):
    assert counts["ptrsm"] == {}


def test_power_step_two_all_reduces_and_its_reshard(counts):
    """y = A@x + r (all-reduce over cols), nu = <y, y> (over rows), and the
    rows -> cols reshard of y / sqrt(nu): one gather over rows (in JAX a
    sharding constraint, not a traced collective)."""
    assert counts["power_step"] == {("all_reduce", "cols"): 1, ("all_reduce", "rows"): 1,
                                    ("all_gather", "rows"): 1}


@pytest.mark.parametrize("ar", ["f32", "df64"])
def test_pcg_collective_discipline(counts, ar):
    """Every pcg iteration communicates through pdot/pgemv combines and the
    matvec's reshard only: f32 all-reduces (one a matvec, one a dot, two dots
    an iteration plus the first) and the reshard gathers over rows; df64 no
    all-reduce of any kind, the dots and matvecs gathering DF pairs over
    cols."""
    c = counts[f"pcg_{ar}"]
    iters, dots = 3, 1 + 2 * 3
    reshard = {("all_gather", "rows"): iters}
    if ar == "f32":
        assert c == {("all_reduce", "cols"): iters + dots, **reshard}
    else:
        assert _ops(c, "all_reduce") == 0
        assert c == {("all_gather", "cols"): iters + dots, **reshard}


def test_run_without_a_device_asks_for_the_card():
    """launch.run and launch.apply run on the cards unless the caller asks
    for the CPU: with no CUDA device, run raises before it spawns a rank."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run(launch.apply, 2, [])
