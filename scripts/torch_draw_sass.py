#!/usr/bin/env python3
"""The instruction mix of the draw kernel (accblas_tpu_torch/csrc/devgen.cu)
as compiled for sm_90a: builds the library, disassembles it with cuobjdump
and counts each opcode of each instantiation, so the integer-operation
bound that chip_smoke.py states for the kernel can be checked against what
the card runs.

    python3 scripts/torch_draw_sass.py      # on a machine with the CUDA toolkit

cuobjdump is looked up on PATH, under /usr/local/cuda/bin, then in the
triton package's bundled binaries.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from accblas_tpu_torch.ops import _build  # noqa: E402


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/cuobjdump"):
        return "/usr/local/cuda/bin/cuobjdump"
    import triton

    path = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
    if path.exists():
        return str(path)
    raise SystemExit("cuobjdump not found")


def main() -> int:
    (lib,) = _build.build("devgen")
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts: dict[str, collections.Counter] = {}
    name = None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = m.group(1)
            counts[name] = collections.Counter()
        elif name and (m := re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?P\d\s+)?([A-Z][A-Z0-9]*)",
                                     line)):
            counts[name][m.group(1)] += 1
    if not counts:
        raise SystemExit("no function in the disassembly")
    names = subprocess.run(["c++filt"], input="\n".join(counts), capture_output=True,
                           text=True, check=True).stdout.split("\n")
    for pretty, c in zip(names, counts.values()):
        alu = sum(v for k, v in c.items() if k in ("SHF", "LOP3", "IADD3", "SEL", "ISETP"))
        print(f"{pretty}: {sum(c.values())} instructions, ALU-pipe {alu} "
              f"(SHF {c['SHF']}, LOP3 {c['LOP3']}, IADD3 {c['IADD3']}), IMAD {c['IMAD']}, "
              f"FADD {c['FADD']}, FMUL {c['FMUL']}; all: "
              + ", ".join(f"{k} {v}" for k, v in c.most_common()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
