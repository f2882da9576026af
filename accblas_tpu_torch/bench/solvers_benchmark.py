"""Solver-tier benchmark driver (counterpart of
``accblas_tpu.bench.solvers_benchmark``, with its columns and CSV): CG on
an SPD system at every (storage x dot-arithmetic) pairing.

    python -m accblas_tpu_torch.bench.solvers_benchmark [--size N] [--sweep single] [--device cpu]
    python -m accblas_tpu_torch.bench.solvers_benchmark --pcg [--iters N] [--ranks R] [--size N]

For each size it reports, per variant (f32/f32, f32/df64, bf16/f32,
bf16/df64: storage of A / arithmetic of the matvec and the dots):

- ``it_per_s``, the iteration rate: the slope between CG solves of
  ITERS_LO and ITERS_HI iterations, (ITERS_HI - ITERS_LO) / (t_hi - t_lo),
  which cancels each call's set-up (the first dot products). Each budget is
  timed with the drivers' protocol (``common.timer``: CUDA events on a
  card, 1 warm-up, 10 reps, minimum; the host clock with ``--device cpu``);
- ``resid``, the relative residual |b - A x| / |b| after ITERS_HI
  iterations: A x by the df64 precise GEMV against the f32-stored operator,
  the difference and the norms in numpy fp64.

The system is the JAX driver's: A = Cᵀ C / n + 0.01 I with C and b
uniform(-1, 1) under the two keys of ``split(key(seed))``, drawn on the
device (``spd_draws``, bit for bit the JAX driver's C and b). One line
each for ``richardson_refine`` and ``power_method`` goes to stderr at the
last size.
"""

from __future__ import annotations

import numpy as np
import torch

from . import common

ITERS_LO, ITERS_HI = 20, 120

DEFAULT_SIZE = 8192
MIN_SIZE = 512
SEED = 42

NAMES = ["CG f32/f32", "CG f32/df64", "CG bf16/f32", "CG bf16/df64"]


def spd_draws(n: int, seed: int, device):
    """The JAX driver's draws: with ku, kb = split(key(seed)), C =
    uniform(ku, (n, n), -1, 1) and b = uniform(kb, (n,), -1, 1), f32 on
    `device`."""
    from ..utils import threefry

    ku, kb = threefry.split(threefry.key(seed))
    return (threefry.uniform(ku, (n, n), -1.0, 1.0, device),
            threefry.uniform(kb, (n,), -1.0, 1.0, device))


def spd_system(n: int, seed: int, device):
    """A = Cᵀ C / n + 0.01 I (Wishart plus a ridge, kappa ~ 400: hard enough
    that a 120-iteration budget is spent) and b, both f32 on `device`, from
    ``spd_draws``. The product is genuine f32 (``ieee_f32``), a plain
    product outside the kernels, as the JAX driver leaves it to XLA."""
    from ..ops.trsv import ieee_f32

    c, b = spd_draws(n, seed, device)
    with ieee_f32():
        a = torch.matmul(c.T, c).div_(n)
    a.diagonal().add_(0.01)
    return a, b


def df64_residual(a32, b, x) -> float:
    """|b - A x| / |b| with A x from the df64 precise GEMV on the f32-stored
    operator, then numpy fp64."""
    from ..ops import gemv as gemvops

    res = torch.empty(a32.shape[0], dtype=torch.float32, device=a32.device)
    ax = gemvops.acc_gemv(a32, x, res, 1.0, 0.0, ar="df64", precise=True)
    b64 = b.double().cpu().numpy()
    r = b64 - ax.double().cpu().numpy()
    return float(np.linalg.norm(r) / np.linalg.norm(b64))


PCG_HEADER = ["n", "variant", "pcg resid", "cg resid"]


def _pcg_rank(n: int, iters: int, device) -> list[str]:
    """Every rank: the four variants' sharded CG (``parallel.pcg`` on this
    rank's blocks) and single-card CG on the whole system, each residual by
    ``df64_residual``; rank 0 prints each row as it is measured. Returns
    the rows."""
    from ..models import solvers
    from ..parallel import collectives, pcg
    from ..parallel.mesh import make_mesh, shard, unshard

    mesh = make_mesh(device=device)
    a32, b = spd_system(n, SEED, mesh.device)
    if collectives.rank() == 0:
        common.progress(f"pcg mesh: {mesh.shape}, transport {mesh.transport}")
    rows = []
    for name in NAMES:
        st, ar = name.split()[1].split("/")
        a = a32 if st == "f32" else a32.to(torch.bfloat16)
        xp, _, itp = pcg(shard(a, mesh, ("rows", "cols")), shard(b, mesh, ("cols",)),
                         mesh=mesh, iters=iters, ar=ar)
        xp = unshard(xp, mesh, ("cols",), (n,))
        xs, _, its = solvers.cg(a, b, iters=iters, ar=ar)
        rp, rs = df64_residual(a32, b, xp), df64_residual(a32, b, xs)
        row = common.DELIM.join([str(n), f"{st}/{ar}", common.fmt(rp), common.fmt(rs)])
        rows.append(row)
        if collectives.rank() == 0:
            common.progress(f"pcg {st}/{ar}: resid {rp:.3e} (single-card {rs:.3e}) after "
                            f"{int(itp)}/{int(its)} iters")
            print(row, flush=True)
    return rows


def pcg_table(n: int, iters: int, ranks: int, device) -> list[str]:
    """The --pcg table on `ranks` ranks: the header, then rank 0's rows as
    they come. Returns the rows. A fault in any rank fails the table (the
    ranks' collectives cannot go on past it)."""
    from ..parallel import launch

    print(common.DELIM.join(PCG_HEADER), flush=True)
    dev = torch.device(device)
    return launch.run(_pcg_rank, ranks, n, iters, None if dev.type == "cuda" else dev,
                      device=dev)[0]


def main(argv=None):
    def extra(p):
        p.add_argument("--pcg", action="store_true",
                       help="mesh-sharded CG convergence table (pcg beside single-card cg "
                       "per variant) instead of the it/s table")
        p.add_argument("--iters", type=int, default=ITERS_HI,
                       help="fixed iteration budget for --pcg")
        p.add_argument("--ranks", type=int, default=0,
                       help="ranks of --pcg (default: the number of cards, or 4 with "
                       "--device cpu)")

    args = common.parse_args("solvers_benchmark", DEFAULT_SIZE, MIN_SIZE, extra=extra,
                             argv=argv)
    from ..models import solvers

    dev = args.device
    if args.pcg:
        ranks = args.ranks or (torch.cuda.device_count() if dev.type == "cuda" else 4)
        pcg_table(args.size, args.iters, ranks, dev)
        return
    sizes = common.sweep_sizes(args, MIN_SIZE, 256, dense_step=2048)
    common.emit_header("n", [f"{name} {col}" for name in NAMES for col in ("it_per_s", "resid")])
    timer = common.timer(dev)
    for n in sizes:
        a32, b = spd_system(n, SEED, dev)
        ab = a32.to(torch.bfloat16)
        variants = [(NAMES[0], a32, "f32"), (NAMES[1], a32, "df64"),
                    (NAMES[2], ab, "f32"), (NAMES[3], ab, "df64")]
        vals = []
        for name, a, ar in variants:
            def measure(name=name, a=a, ar=ar):
                x = solvers.cg(a, b, iters=ITERS_HI, ar=ar)[0]
                t_lo = timer(lambda: solvers.cg(a, b, iters=ITERS_LO, ar=ar))
                t_hi = timer(lambda: solvers.cg(a, b, iters=ITERS_HI, ar=ar))
                # a non-positive slope means the two budgets timed the same
                # work: NaN, not a rate
                rate = ((ITERS_HI - ITERS_LO) / (t_hi - t_lo) * 1e3 if t_hi > t_lo
                        else float("nan"))
                resid = df64_residual(a32, b, x)
                common.progress(f"n={n} {name}: {rate:.1f} it/s ({t_lo:.4f}/{t_hi:.4f} ms at "
                                f"{ITERS_LO}/{ITERS_HI} iters), resid {resid:.3e}")
                return rate, resid

            try:
                vals.extend(measure())
            except Exception as e:  # noqa: BLE001 - one variant's fault, reported
                common.progress(f"FAILED n={n} {name}: {type(e).__name__}: {str(e)[:200]}")
                vals.extend([float("nan"), float("nan")])
        common.emit_row(n, vals)

    # the two other solvers: one line each at the last size (their value is
    # the convergence property, which the tests hold)
    _, rhist = solvers.richardson_refine(ab, a32, b, iters=6, ar="df64")
    common.progress(f"richardson bf16-precond/f32-residual: |r|^2 {float(rhist[-1]):.3e} "
                    f"after 6 iters")
    _, lam = solvers.power_method(a32, iters=15, ar="f32")
    common.progress(f"power_method lambda_max ~= {float(lam):.6f}")


if __name__ == "__main__":
    main()
