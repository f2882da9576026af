#!/usr/bin/env python3
"""The sharded layer one rank a card, over NCCL, on every card of the
machine: chip_smoke.py's phase 9 checks (sharded_rank_checks: the port's
dryrun, then each sharded op at full width on the 2-D mesh of the ranks,
held to the JAX tests' bounds and against the single-card op on rank 0's
card, with host ms a call of both), then the solver driver's --pcg table
at n = 8192, 120 iterations, on the same ranks.

    python3 scripts/torch_sharded_cards.py          # from the root of the repository

chip_smoke.py runs the same checks with 4 ranks sharing one card over gloo;
this is the path where each rank has a card of its own (4 cards: a 2 x 2
mesh). Prints the card's name and power limit first; exits non-zero on a
failed check.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    from accblas_tpu_torch.bench import solvers_benchmark as sb
    from accblas_tpu_torch.parallel import launch

    if not torch.cuda.is_available():
        raise SystemExit("torch_sharded_cards: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    ranks = torch.cuda.device_count()
    t0 = time.perf_counter()
    res = launch.run(chip_smoke.sharded_rank_checks, ranks, device="cuda", timeout=900)[0]
    for line in res["lines"]:
        print(line, flush=True)
    print(f"checks on {ranks} cards: {time.perf_counter() - t0:.1f} s", flush=True)
    sb.pcg_table(chip_smoke.N_PCG, chip_smoke.PCG_ITERS, ranks, "cuda")
    if res["bad"]:
        print("FAILED:\n" + "\n".join(res["bad"]), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
