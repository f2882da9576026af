"""The port's row-sharded TRSV against the JAX package's, on identical
inputs and mesh shapes (the helpers and the rules: see
tests/test_torch_parallel.py), as tests/test_fuzz_parallel.py::
test_fuzz_ptrsv and test_fuzz_mesh_shapes: upper and lower, unit and
non-unit, f32 and df64, ragged n (an identity tail pads it), on 2 x 2,
1 x 4 and 4 x 1. n stays <= 1024: the JAX sweep runs in interpret mode
here."""

import pytest
import torch

from test_torch_parallel import (ALT_M, ALT_SHAPES, RNG, _tag, check_case, port_fixture,
                                 ptrsv_case)

torch.set_num_threads(1)

CASES = {
    "ptrsv_upper_nonunit_f32": ptrsv_case(int(RNG.integers(100, 700)), "upper", False, "f32",
                                          200),
    "ptrsv_lower_unit_df64": ptrsv_case(int(RNG.integers(100, 700)), "lower", True, "df64",
                                        201),
}
for _shape in ALT_SHAPES:
    CASES[f"{_tag(_shape)}_ptrsv"] = ptrsv_case(ALT_M, "upper", False, "f32", ALT_M, _shape)


@pytest.fixture(scope="module")
def port():
    yield from port_fixture(CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_port_against_jax(port, name):
    check_case(CASES[name], port, name)
