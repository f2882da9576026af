"""The sharded layer's entry points on CPU ranks: the port's multi-rank
dryrun (accblas_tpu_torch.parallel.dryrun, the counterpart of
__graft_entry__.dryrun_multichip) and the solver driver's --pcg table,
mirroring tests/test_bench_drivers.py::test_pcg_table_emits_per_variant."""

import math
import subprocess
import sys
from pathlib import Path

import torch

from accblas_tpu_torch.parallel.dryrun import dryrun_multichip

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    line = dryrun_multichip(4, "cpu")
    assert capsys.readouterr().out.strip() == line
    assert line.startswith("dryrun_multichip OK: mesh 2x2 (4 devices), A 512x512 bf16 sharded")
    assert "after 20 sharded df64-dot iterations" in line
    assert "alt meshes [(1, 4), (4, 1)] pcg df64+bf16 ok" in line


def test_pcg_table_emits_per_variant(tmp_path):
    """--pcg prints the header, then one row per variant as it is measured;
    the sharded recurrence tracks the single-card one per variant (the same
    class of partial convergence, not bitwise)."""
    res = subprocess.run(
        [sys.executable, "-m", "accblas_tpu_torch.bench.solvers_benchmark", "--pcg",
         "--device", "cpu", "--size", "512", "--iters", "40", "--ranks", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert lines[0].split(";") == ["n", "variant", "pcg resid", "cg resid"]
    rows = [r.split(";") for r in lines[1:]]
    assert [r[1] for r in rows] == ["f32/f32", "f32/df64", "bf16/f32", "bf16/df64"]
    for r in rows:
        rp, rs = float(r[2]), float(r[3])
        assert math.isfinite(rp) and math.isfinite(rs)
        assert rp < 1.0 and rs < 1.0
        assert rp <= rs * 10 + 1e-12 and rs <= rp * 10 + 1e-12
    assert "pcg mesh: {'rows': 2, 'cols': 2}" in res.stderr
