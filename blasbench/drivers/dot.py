"""DOT requests: ``acc_dot(x, y, ar)`` on a pair of stored vectors, the
scalar read on the host.

x and y come from pools of the mix's ``pool`` vectors each, uniform(-1, 1)
drawn from the seed and stored as the configuration says; a request takes
one of each. Every answer is kept and compared with the float64 DOT of the
stored values, by |value - reference| / Σ|x_i y_i| (``dot_err``). The
control is the program's own narrower tier (``control_arithmetic``).
"""

from __future__ import annotations

import math

from .. import draw, roofline
from ..reference import blas as ref


class Driver:
    kind = "call"

    def __init__(self, config: dict, mix: dict, seed: int, device, variant: str = "program"):
        from accblas_tpu_torch import acc_dot

        self.acc_dot = acc_dot
        c = config["dot"]
        n, pool = int(mix["n"]), int(mix["pool"])
        st_x, st_y = c["storage"]
        self.ar = c["arithmetic"] if variant == "program" else c["control_arithmetic"]
        g = draw.generator(seed, device)
        self.x = [draw.uniform(g, n).to(draw.DTYPE[st_x]) for _ in range(pool)]
        self.y = [draw.uniform(g, n).to(draw.DTYPE[st_y]) for _ in range(pool)]
        self.bytes_per_call = roofline.dot_bytes(n, st_x, st_y)

    def pick(self, rng):
        return rng.randrange(len(self.x)), rng.randrange(len(self.y))

    def call(self, key):
        i, j = key
        return self.acc_dot(self.x[i], self.y[j], ar=self.ar)

    def read(self, key, out, keep):
        v = out.item()
        return math.isfinite(v), (v if keep is not None else None)

    def check(self, answers) -> dict:
        refs = {k: ref.dot(self.x[k[0]], self.y[k[1]]) for k in sorted({k for k, _ in answers})}
        return {"dot_err": max(abs(v - refs[k][0]) / refs[k][1] for k, v in answers)}
