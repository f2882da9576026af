"""The port's rhs-sharded TRSM, sharded CG and power step against the JAX
package's, on identical inputs and mesh shapes (the helpers and the rules:
see tests/test_torch_parallel.py), covering tests/test_parallel.py's
ptrsm, pcg and power_step cases and tests/test_fuzz_parallel.py's ptrsm
fuzz, uneven rhs and the mesh shapes' pcg."""

import numpy as np
import pytest
import torch

from accblas_tpu import parallel as jpar
from accblas_tpu_torch.models import solvers as tsolvers
from accblas_tpu_torch.parallel.launch import Call, Sharded
from accblas_tpu_torch.utils import interop
from test_torch_parallel import (ALT_SHAPES, COLS, FLOOR, RNG, _P, _f64, _j, _jmesh, _mat, _tag,
                                 _vec, check_case, pcg_case, ptrsm_case, ptrsm_lu_case, rel1,
                                 port_fixture)

torch.set_num_threads(1)

CASES = {
    "ptrsm_lu": ptrsm_lu_case(),
    "ptrsm_lower_unit_f32": ptrsm_case(int(RNG.integers(100, 500)), COLS * int(RNG.integers(1, 9)),
                                       "lower", True, "f32", 101),
    "ptrsm_upper_nonunit_df64": ptrsm_case(int(RNG.integers(100, 500)),
                                           COLS * int(RNG.integers(1, 9)), "upper", False,
                                           "df64", 102),
    "ptrsm_uneven_k3": ptrsm_case(257, 3, "upper", False, "f32", 257),
    "ptrsm_uneven_k7": ptrsm_case(257, 7, "upper", False, "f32", 257),
    "pcg_f32_direct": pcg_case(512, "f32", 200, 1e-7, 21),
    "pcg_df64_direct": pcg_case(256, "df64", 150, 1e-7, 23),
    "pcg_custom_axes": pcg_case(512, "f32", 40, 1e-8, 9, axes=("r", "c")),
}
# the fuzz test's pcg on the mesh shapes besides 2 x 2 (whose pcg the cases
# above hold), on f32 storage in df64 and on bf16 storage in f32; their error
# against the direct solve is whatever 40 iterations reach (no bound), the
# gap to JAX is held
PCG_MESH = [(s, st, ar) for s in ALT_SHAPES for st, ar in (("f32", "df64"), ("bf16", "f32"))]
for _shape, _st, _ar in PCG_MESH:
    CASES[f"{_tag(_shape)}_pcg_{_st}_{_ar}"] = pcg_case(128, _ar, 40, 0.0, 128, st=_st,
                                                        shape=_shape, bound=np.inf, ridge=0.5)
POWER = Call(_P + "power_step", (Sharded(_mat(512, 1024, 5), ("rows", "cols"), st="bf16"),
                                 Sharded(_vec(1024, 6), ("cols",), st="bf16"),
                                 Sharded(_vec(512, 7), ("rows",))), {"ar": "f32"},
             out=((("cols",), (512,)), None))


@pytest.fixture(scope="module")
def port():
    yield from port_fixture(CASES, [("power_step", POWER)])


@pytest.mark.parametrize("name", list(CASES))
def test_port_against_jax(port, name):
    check_case(CASES[name], port, name)


@pytest.mark.parametrize("shape,st,ar", PCG_MESH, ids=lambda v: str(v))
def test_pcg_tracks_single_card_cg(port, shape, st, ar):
    """tests/test_fuzz_parallel.py::test_fuzz_mesh_shapes: the sharded
    recurrence's final |r|^2 within 10x of the port's single-card cg on the
    same system, and the reverse."""
    name = f"{_tag(shape)}_pcg_{st}_{ar}"
    call = CASES[name].call
    rp = float(port[name][0]["values"][1])
    a = interop.from_numpy(call.args[0].array, st)
    b = torch.from_numpy(call.args[1].array)
    rs = float(tsolvers.cg(a, b, iters=40, ar=ar, tol=0.0)[1])
    assert np.isfinite(rp) and np.isfinite(rs)
    assert rp <= rs * 10 + 1e-12 and rs <= rp * 10 + 1e-12, (name, rp, rs)


def test_power_step_against_jax(port):
    """tests/test_parallel.py::test_power_step_jits_and_runs on the same
    bf16 inputs: nu finite and positive, x' of length m; nu and x' within
    the bf16 storage floor of the JAX step's."""
    res, same = port["power_step"]
    x_next, nu = res["values"]
    a, x, r = (s.array for s in POWER.args)
    jx, jnu = jpar.power_step(_j(a, "bf16"), _j(x, "bf16"), _j(r), mesh=_jmesh(), ar="f32")
    assert same and x_next.shape == (512,) and np.isfinite(nu) and nu > 0
    assert abs(float(nu) - float(jnu)) / float(jnu) < FLOOR[("bf16", "f32")]
    assert rel1(x_next, _f64(jx)) < FLOOR[("bf16", "f32")]
