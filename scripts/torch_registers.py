#!/usr/bin/env python3
"""Write the registers and spill bytes of every instantiation of the main
path's kernels (dot_reduce, gemv_rows, gemv_staged, gemv_rows_dfx,
trsv_sweep), as ptxas reports them for this checkout's sources, to the
table chip_smoke.py's build phase holds each build to.

    python3 scripts/torch_registers.py [--out PATH]

Builds csrc/dot.cu, gemv.cu and trsv.cu (where no up-to-date library
exists) on a machine with nvcc; PATH defaults to
accblas_tpu_torch/csrc/registers.json. Run it after a change of those
sources whose registers the A/B (scripts/torch_generic_ab.py --sass) has
checked against the parent's.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from accblas_tpu_torch.ops import _build  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=chip_smoke.REGISTERS)
    args = ap.parse_args(argv)
    _build.build(*chip_smoke.GATED)
    table = {}
    for src, kernels in chip_smoke.GATED.items():
        for kernel, found in chip_smoke.kernel_registers(_build.build_log(src), kernels).items():
            table[kernel] = dict(sorted(found.items()))
            print(f"{kernel}: {len(found)} instantiations", flush=True)
    # one line an instantiation, so that a change reads as a diff of lines
    args.out.write_text("{\n" + ",\n".join(
        f"{json.dumps(kernel)}: {{\n" + ",\n".join(
            f" {json.dumps(inst)}: {json.dumps(rs)}" for inst, rs in found.items()) + "\n}"
        for kernel, found in table.items()) + "\n}\n")
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
