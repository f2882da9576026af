#!/usr/bin/env python3
"""Time the TRSV sweep of two checkouts in turns on one card, and measure
its error on an LU factor: other, this, this, other.

    python3 scripts/torch_sweep_ab.py OTHER_CHECKOUT [--n 16384]

Each turn is a child process that imports accblas_tpu_torch from its
checkout (which builds its own csrc/ there at first use) and times the
sweep kernel alone (phase 2, its leaf inverses and right-hand sides made
once), f32 and df64, with CUDA events (1 warm-up, 50 reps, minimum):
  - on the main path's operand, upper unit, A = uniform(-1, 1)/n
    (torch.Generator, seed 0), b = ones;
  - on the non-unit upper triangle of the LU factor of the drivers' seeded
    master (bench/trsv_benchmark.py lu_cached, computed once by this
    checkout), where it also gives the 1-norm relative error of trsv and
    acc_trsv against a float64 solve of that triangle.
Cards differ by more than small kernel changes do, so compare the two
checkouts only within one run. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys
import numpy as np, scipy.linalg, torch
from accblas_tpu_torch import acc_trsv, trsv
from accblas_tpu_torch.ops import trsv as T
from accblas_tpu_torch.utils.bench import benchmark_function
n, lu_path = int(sys.argv[1]), sys.argv[2]
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
main = (torch.rand(n, n, generator=g, device=dev) * 2 - 1) / n
ones = torch.ones(n, device=dev)
lu = np.load(lu_path)
ref = scipy.linalg.solve_triangular(np.triu(lu), np.ones(n))
lu32 = torch.from_numpy(lu.astype(np.float32)).to(dev)
nb = -(-n // T.BLOCK)
bt = T._rhs_panels(ones.reshape(n, 1), nb)
out = {}
for op, a, unit in (("main", main, True), ("lu", lu32, False)):
    inv = T._leaf_inverses(T._extract_leaf_diag(a, nb * T.BLOCK // T.LEAF, False, unit), False)
    for ar in ("f32", "df64"):
        ms = benchmark_function(lambda: T._trsv_sweep(a, inv, bt, False, ar, torch.float32),
                                iters=50)
        err = None
        if op == "lu":
            x = trsv(a, ones, "upper", False) if ar == "f32" else \
                acc_trsv(a, ones, "upper", False, ar="df64")
            err = float(np.abs(x.double().cpu().numpy() - ref).sum() / np.abs(ref).sum())
        out[f"{op} {ar}"] = {"ms": ms, "err": err}
print(json.dumps(out))
"""


def turn(checkout: Path, n: int, lu_path: str) -> dict:
    res = subprocess.run([sys.executable, "-c", CHILD, str(n), lu_path], cwd=checkout,
                         env=dict(os.environ, PYTHONPATH=str(checkout)), capture_output=True,
                         text=True, timeout=1200)
    if res.returncode != 0:
        raise SystemExit(f"turn in {checkout} failed:\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("other", type=Path, help="the checkout to compare with")
    p.add_argument("--n", type=int, default=16384)
    args = p.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        lu_path = os.path.join(tmp, "lu.npy")
        code = ("import sys, numpy as np; from accblas_tpu_torch.bench.trsv_benchmark import "
                "lu_cached; np.save(sys.argv[2], lu_cached(int(sys.argv[1]), 42, 'cuda'))")
        subprocess.run([sys.executable, "-c", code, str(args.n), lu_path], cwd=HERE, check=True,
                       env=dict(os.environ, PYTHONPATH=str(HERE), ACCBLAS_TORCH_CACHE=tmp),
                       timeout=1200)
        order = (("other", args.other.resolve()), ("this", HERE), ("this", HERE),
                 ("other", args.other.resolve()))
        for label, checkout in order:
            res = turn(checkout, args.n, lu_path)
            print(f"{label}: " + ", ".join(
                f"{k} {v['ms']:.4f} ms" + ("" if v["err"] is None else f" err {v['err']:.3e}")
                for k, v in res.items()), flush=True)


if __name__ == "__main__":
    main()
