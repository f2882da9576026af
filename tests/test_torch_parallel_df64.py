"""The port's sharded GEMV in the df64 tier against the JAX package's (its
bf16-storage case is in test_torch_parallel.py), on identical inputs and
mesh shapes (the helpers and the rules: see
tests/test_torch_parallel.py). The df64 combine gathers the unrounded (hi,
lo) row partials and folds them exactly; on the cancellation input of
tests/test_parallel.py::test_pgemv_df64_exact_combine it must beat the f32
tier by 5x."""

import numpy as np
import pytest
import torch

from test_torch_parallel import (ALT_M, ALT_N, ALT_SHAPES, COLS, ROWS, _tag, _uneven, check_case,
                                 pgemv_cancel_case, pgemv_case, port_fixture, rel1)

torch.set_num_threads(1)

CASES = {
    "pgemv_cancel_df64": pgemv_cancel_case("df64"),
    "pgemv_cancel_f32": pgemv_cancel_case("f32"),
    "pgemv_tensor_alpha_beta_df64": pgemv_case(128, 256, "f32", "df64", np.float32(2.0),
                                               np.float32(0.5), 52, bound=1e-5),
    "pgemv_beta0_nan_df64": pgemv_case(256, 512, "f32", "df64", 1.0, 0.0, 50, res_nan=True,
                                       bound=1e-5),
}
# f32 storage, uneven, on every mesh shape (bf16 storage:
# test_torch_parallel.py); the JAX df64 GEMV compiles for 0.3-3 s a call
# here, so few rows
_m, _n = _uneven(ROWS, 8, 32), _uneven(COLS, 16, 200)
CASES["pgemv_f32_df64_uneven"] = pgemv_case(_m, _n, "f32", "df64", 1.5, 1.0, _m + _n)
for _shape in ALT_SHAPES:
    CASES[f"{_tag(_shape)}_pgemv_df64"] = pgemv_case(4 * 7 + 1, ALT_N, "f32", "df64", 1.0, 1.0,
                                                     ALT_M + ALT_N, _shape)


@pytest.fixture(scope="module")
def port():
    yield from port_fixture(CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_port_against_jax(port, name):
    check_case(CASES[name], port, name)


def test_pgemv_df64_beats_f32_on_cancellation(port):
    """tests/test_parallel.py::test_pgemv_df64_exact_combine's second bound:
    the df64 combine's error is under a fifth of the f32 tier's."""
    ref = CASES["pgemv_cancel_df64"].ref
    e64 = rel1(port["pgemv_cancel_df64"][0]["values"][0], ref)
    e32 = rel1(port["pgemv_cancel_f32"][0]["values"][0], ref)
    assert e64 < e32 / 5, (e64, e32)
