"""What ``correct`` must refuse, at sizes a test run holds, on the CPU: the
control (the precision below the configuration's, in the program's place)
and the faults each cell can have, planted under the timed path. The
run's look for a card is skipped; the rest of a run is driven
(``run.run_cell``): inputs from the seed, warm-up, the window, the check
against the reference. No cell runs across cards, so the fault of an
exchange left out has no cell here."""

import pytest
import torch

import accblas_tpu_torch as port
from accblas_tpu_torch.models import solvers
from blasbench import run, spec

# the faults' sizes; the control's bf16 CG error grows with n and stands
# clear of its limit from n = 2048 (5.4e-3 to 6.1e-3 at 1024, 9.2e-3 to
# 9.5e-3 at 2048, against 5e-3; the program's 2.6e-4 to 5.0e-4)
SIZE = {"cg": 512, "trsv": 512, "dot": 1 << 16}
CONTROL_SIZE = dict(SIZE, cg=2048)


def _run(op, variant="program", seed=2**31 + 3, size=SIZE):
    cell = spec.cell(spec.first_cell_of(op))
    cell.mix["n"] = size[op]
    return run.run_cell(cell, seed, 0.3, False, torch.device("cpu"), variant=variant)


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 2**33 + 17])
@pytest.mark.parametrize("op", sorted(SIZE))
def test_program_is_correct_and_control_is_not(op, seed):
    assert _run(op, seed=seed, size=CONTROL_SIZE)["correct"]
    r = _run(op, "control", seed=seed, size=CONTROL_SIZE)
    assert not r["correct"], r["checks"]


def _cg_unchanged(real):
    def cg(a, b, **kw):
        x, rs, it = real(a, b, **kw)
        return torch.zeros_like(x), rs, it  # the solve hands back its start state
    return cg


def _cg_negated(real):
    def cg(a, b, **kw):
        x, rs, it = real(a, b, **kw)
        return -x, rs, it
    return cg


def _matvec_half(real):
    def matvec(a, x, ar):
        h = a.shape[1] // 2  # half of the columns left out, the rest doubled
        return 2 * real(a[:, :h].contiguous(), x[:h].contiguous(), ar)
    return matvec


def _trsv_unchanged(real):
    return lambda a, b, uplo, unit: b.clone()  # the right-hand side, unsolved


def _trsv_half(real):
    def trsv(a, b, uplo, unit):
        h = a.shape[1] // 2
        cut = a.clone()
        cut[:, h:] = 0  # half of the panels' corrections left out
        return real(cut, b, uplo, unit)
    return trsv


def _trsv_negated(real):
    return lambda a, b, uplo, unit: -real(a, b, uplo, unit)


def _dot_unchanged(real):
    return lambda x, y, ar: torch.zeros((), dtype=torch.float32)  # the sum's start


def _dot_half(real):
    def dot(x, y, ar):
        h = x.shape[0] // 2
        return 2 * real(x[:h], y[:h], ar=ar)
    return dot


def _dot_negated(real):
    return lambda x, y, ar: -real(x, y, ar=ar)


FAULTS = {
    "cg": [(solvers, "cg", _cg_unchanged), (solvers, "_matvec", _matvec_half),
           (solvers, "cg", _cg_negated)],
    "trsv": [(port, "trsv", _trsv_unchanged), (port, "trsv", _trsv_half),
             (port, "trsv", _trsv_negated)],
    "dot": [(port, "acc_dot", _dot_unchanged), (port, "acc_dot", _dot_half),
            (port, "acc_dot", _dot_negated)],
}


@pytest.mark.parametrize("op, fault", [
    (op, i) for op in sorted(FAULTS) for i, _ in enumerate(("unchanged", "half", "altered"))],
    ids=lambda v: v if isinstance(v, str) else ("unchanged", "half", "altered")[v])
def test_planted_fault_is_refused(monkeypatch, op, fault):
    mod, attr, plant = FAULTS[op][fault]
    monkeypatch.setattr(mod, attr, plant(getattr(mod, attr)))
    r = _run(op)
    assert not r["correct"], r["checks"]
