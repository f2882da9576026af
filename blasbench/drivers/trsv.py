"""TRSV requests: ``trsv(a, b, uplo, unit)``, one solve a request, its
result waited for on the host.

One A serves every request: uniform(-1, 1) scaled by 1/n, f32 (the
upstream benchmark's operand, whose off-diagonal entries of size 1/n keep
the unit solve well conditioned); right-hand sides come from a pool of the
mix's ``pool`` vectors uniform(-1, 1), all drawn from the seed. The seed's
stream keeps one answer in ``keep_one_in`` (and the first), and each kept x
is compared with the float64 block solve of its right-hand side by
|x - ref|_1 / |ref|_1 (``x_err``). The program has no narrower path for
this solve, so the control is the reference itself in TF32 put in its
place.
"""

from __future__ import annotations

import torch

from .. import draw, roofline
from ..reference import blas as ref


class Driver:
    kind = "call"

    def __init__(self, config: dict, mix: dict, seed: int, device, variant: str = "program"):
        from accblas_tpu_torch import trsv

        c = config["trsv"]
        if c["storage"] != "f32" or c["uplo"] != "upper" or not c["unit"]:
            raise ValueError("the trsv driver runs the f32 unit upper solve")
        self.trsv = trsv
        self.control = variant == "control"
        n, pool = int(mix["n"]), int(mix["pool"])
        self.keep_one_in = int(mix["keep_one_in"])
        g = draw.generator(seed, device)
        self.a = draw.uniform(g, (n, n)).div_(n)
        self.b = draw.uniform(g, (pool, n))
        self.device = torch.device(device)
        self.kept = 0
        self.bytes_per_call = roofline.trsv_bytes(n, "f32", "f32", "f32", unit=True)

    def pick(self, rng):
        return rng.randrange(self.b.shape[0])

    def call(self, key):
        if self.control:
            return ref.unit_upper_solve(self.a, self.b[key], block=64, prec="tf32")
        return self.trsv(self.a, self.b[key], "upper", True)

    def read(self, key, out, keep):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        take = keep is not None and (self.kept == 0 or keep.randrange(self.keep_one_in) == 0)
        self.kept += take
        return True, (out if take else None)

    def check(self, answers) -> dict:
        keys = sorted({k for k, _ in answers})
        xs = ref.unit_upper_solve(self.a, self.b[keys].T)
        col = {k: xs[:, i] for i, k in enumerate(keys)}
        return {"x_err": max(float((x.double() - col[k]).abs().sum() / col[k].abs().sum())
                             for k, x in answers)}
