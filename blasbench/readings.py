"""The readings a check's limit is set from, many seeds in one process.

    python3 blasbench/readings.py --workload NAME --seeds 1,2,3 --seconds 3 \\
        [--variant program|control]

For each seed, one run of the cell as ``run.py`` makes it (inputs from the
seed, warm-up, a window of the given seconds at the cell's own load, the
check against the reference), with the program or with the control in its
place (``variant='control'``: the precision below the one the
configuration states). One JSON line a seed: the compared numbers, the
requests attempted and failed. The benchmark's own runs never run the
control; this tool and the tests do.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):  # run as a script: the checkout is the import root
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from blasbench import ROOT, run, spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="blasbench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--variant", choices=("program", "control"), default="program")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("blasbench.readings: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = spec.cell(args.workload, ROOT)
        res = run.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0),
                           variant=args.variant)
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          "attempted": res["attempted"], "failed": res["failed"],
                          "correct": res["correct"],
                          "checks": {k: c["value"] for k, c in res["checks"].items()},
                          "metrics": {k: m["value"] for k, m in res["metrics"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
