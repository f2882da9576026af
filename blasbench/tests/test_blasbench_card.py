"""On a card: each cell's driver at a small size through the port's CUDA
kernels, the program correct and the control refused. Run there with
``python -m pytest -m cuda blasbench/tests``; skips without a card."""

import pytest
import torch

from blasbench import run, spec

SIZE = {"cg": 2048, "trsv": 2048, "dot": 1 << 22}


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(SIZE))
def test_card_program_and_control(op):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for variant, want in (("program", True), ("control", False)):
        cell = spec.cell(spec.first_cell_of(op))
        cell.mix["n"] = SIZE[op]
        r = run.run_cell(cell, 2**31 + 21, 0.5, variant == "program",
                         torch.device("cuda", 0), variant=variant)
        assert r["correct"] is want, r["checks"]
