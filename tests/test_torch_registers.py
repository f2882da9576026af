"""chip_smoke.py's register gate: every instantiation of the main path's
kernels and of gemv_staged, held to its registers and spill bytes in
accblas_tpu_torch/csrc/registers.json.

The table itself comes from ptxas on a machine with nvcc
(scripts/torch_registers.py); here it is held to the instantiations the
C entries dispatch to, and the gate to what it must refuse, on ptxas
reports made up in the test.
"""

import itertools
import json

import pytest

import chip_smoke

STORAGE = ("float", "__nv_bfloat16", "__half", "__nv_fp8_e4m3", "__nv_fp8_e5m2")
F8 = ("__nv_fp8_e4m3", "__nv_fp8_e5m2")
TIERS = range(5)
STAGED_TIERS = (0, 3, 4)  # f32, df64 fast, df64 precise


def _table() -> dict:
    return json.loads(chip_smoke.REGISTERS.read_text())


def test_table_covers_every_dispatched_instantiation():
    """gemv_rows for every (A, x, tier) the C entry dispatches, gemv_staged
    for those with A and x in f8 in the f32 and df64 tiers, gemv_rows_dfx
    for every A (x a DF pair), and dot_reduce and trsv_sweep as built; each
    with a register count and a spill count."""
    table = _table()
    assert set(table) == {k for ks in chip_smoke.GATED.values() for k in ks}
    rows = {f"gemv_rows<{a}, {x}, {t}>" for a, x, t in itertools.product(STORAGE, STORAGE, TIERS)}
    staged = {f"gemv_staged<{a}, {x}, {t}>"
              for a, x, t in itertools.product(F8, F8, STAGED_TIERS)}
    assert set(table["gemv_rows"]) == rows
    assert set(table["gemv_staged"]) == staged
    assert set(table["gemv_rows_dfx"]) == {f"gemv_rows_dfx<{a}>" for a in STORAGE}
    assert len(table["dot_reduce"]) == 125 and len(table["trsv_sweep"]) == 20
    for kernel in table.values():
        for regs, spill in kernel.values():
            assert 0 < regs <= 255 and spill >= 0


@pytest.fixture
def build_log(monkeypatch):
    """check_registers over made-up ptxas reports: {source: {demangled
    kernel: [registers, spill bytes]}}, the table's own figures unless a
    test changes one."""
    from accblas_tpu_torch.ops import _build

    reports = {src: {f"void accblas::(anonymous namespace)::{inst}(int)": list(rs)
                     for k in kernels for inst, rs in _table()[k].items()}
               for src, kernels in chip_smoke.GATED.items()}
    monkeypatch.setattr(_build, "build_log", lambda src: src)
    monkeypatch.setattr(chip_smoke, "ptxas_entries", lambda src: reports[src])
    monkeypatch.setattr(chip_smoke, "log", lambda msg: None)
    return reports


def test_gate_passes_the_table_itself(build_log):
    chip_smoke.check_registers()


@pytest.mark.parametrize("change", ["register", "spill", "new instantiation"])
def test_gate_refuses_a_rise(build_log, change):
    gemv = build_log["gemv"]
    name = "void accblas::(anonymous namespace)::gemv_staged<__nv_fp8_e4m3, __nv_fp8_e4m3, 0>(int)"
    if change == "register":
        gemv[name][0] += 1
    elif change == "spill":
        gemv[name][1] += 8
    else:
        gemv[name.replace("gemv_staged<__nv_fp8_e4m3", "gemv_staged<double")] = [32, 0]
    with pytest.raises(AssertionError, match="registers above"):
        chip_smoke.check_registers()


def test_gate_takes_fewer_registers(build_log):
    for rs in build_log["dot"].values():
        rs[0] -= 1
    chip_smoke.check_registers()


def test_ptxas_lines_take_gemv_rows_apart_from_gemv_rows_dfx(build_log, monkeypatch):
    """The build phase's ptxas and range-path lines name gemv_rows by its
    whole template name: the report of gemv_rows_dfx, whose one template
    argument carries no tier, is not read as a gemv_rows instantiation."""
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lines.append)
    gemv = build_log["gemv"]
    rows = [k for k in gemv if "::gemv_rows<" in k]
    assert rows and any("::gemv_rows_dfx<" in k for k in gemv)
    chip_smoke.log_ptxas("gemv_rows", "gemv")
    tiers = [ln for ln in lines if ln.startswith("ptxas gemv_rows tier")]
    assert sum(int(ln.split(": ")[1].split()[0]) for ln in tiers) == len(rows)
