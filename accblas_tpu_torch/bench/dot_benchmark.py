"""DOT benchmark driver, the ``dot_benchmark`` executable analogue
(reference ``cuda/dot_benchmark.cu``; counterpart of
``accblas_tpu.bench.dot_benchmark``, with its variants, order and CSV).

    python -m accblas_tpu_torch.bench.dot_benchmark [--error] [--size N] [--device cpu]

Columns (the reference's set, ``cuda/dot_benchmark.cu:95-142``, on the JAX
package's lattice):

  DOT fp32 / bf16               — fixed precision (the port's DOT kernel)
  DOT Acc<f32,f32> / <bf16,bf16> — identity accessor tiers
  DOT Acc<df64,f32> [precise]   — df64 arithmetic over f32 storage
  DOT Acc<f32,bf16>             — f32 over bf16 (the headline)
  DOT Acc<df64,bf16>            — df64 over bf16
  DOT Acc<f32,f16>, <f32,f8e4m3> — narrow storage; f8 by stochastic rounding
  torch DOT fp32 / bf16         — the vendor tier: ``xla_dot``, which is
                                  ``torch.dot`` on the card
  DOT df64 oracle (device)      — error mode only: df64 over the split
                                  fp64 master (``ops.oracle.dot_df64``)

Data: drawn on the device from seeded streams with a host-replayed fp64
master (``utils.devgen``). Speed mode: GFLOP/s = 2n / t, t from
``benchmark_function`` (1 warm-up, 10 reps, minimum, CUDA events), one
flushed row per size. Eager torch hoists nothing out of a repeated call, so
no loop-carried perturbation is needed (the JAX driver's timing loop needs
one). Error mode: each variant runs once, untimed; the median relative
error over ``--randomizations`` fresh masters against the numpy fp64 dot
of the master (``cuda/dot_benchmark.cu:162-164,175,238-259``), the oracle
column last.
"""

from __future__ import annotations

import torch

from . import common

MIN_SIZE = 2**14
DEFAULT_SIZE = 2**27
ALIGN = 2**13
SEED = 42

# (column name, storage family, kind, acc_dot kwargs)
VARIANTS = [
    ("DOT fp32", "f32", "fixed", {}),
    ("DOT bf16", "bf16", "fixed", {}),
    ("DOT Acc<f32,f32>", "f32", "acc32", {}),
    ("DOT Acc<bf16,bf16>", "bf16", "accbf16", {}),
    ("DOT Acc<df64,f32>", "f32", "df", {}),
    ("DOT Acc<df64,f32> precise", "f32", "df", {"precise": True}),
    ("DOT Acc<f32,bf16>", "bf16", "acc32", {}),
    ("DOT Acc<df64,bf16>", "bf16", "df", {}),
    ("DOT Acc<f32,f16>", "f16", "acc32", {}),
    ("DOT Acc<f32,f8e4m3>", "f8", "acc32", {}),
    ("torch DOT fp32", "f32", "vendor", {}),
    ("torch DOT bf16", "bf16", "vendor", {}),
    ("DOT df64 oracle (device)", "oracle", "oracle", {}),  # error mode only
]


def family_arrays(family: str, x32, y32, seed: int, r: int):
    """One storage family's device operands, derived from the f32 copies."""
    from ..utils import devgen, threefry
    from ..utils.sr import sr_round_device_chunked

    if family == "f32":
        return x32, y32
    if family in ("bf16", "f16"):
        dt = torch.bfloat16 if family == "bf16" else torch.float16
        return x32.to(dt), y32.to(dt)
    if family == "f8":
        kx, ky = threefry.split(devgen.key(seed, "sr", r))
        return (sr_round_device_chunked(x32, "f8e4m3", kx),
                sr_round_device_chunked(y32, "f8e4m3", ky))
    raise ValueError(family)


def tier_call(kind: str, kw: dict):
    """fn(x, y) running one column's tier."""
    from ..ops import dot as dotops

    if kind == "fixed":
        return dotops.dot
    if kind == "df":
        return lambda x, y: dotops.acc_dot(x, y, ar="df64", **kw)
    if kind == "acc32":
        return lambda x, y: dotops.acc_dot(x, y, ar="f32")
    if kind == "accbf16":
        return lambda x, y: dotops.acc_dot(x, y, ar="bf16")
    return dotops.xla_dot


def main(argv=None):
    args = common.parse_args("dot_benchmark", DEFAULT_SIZE, MIN_SIZE, argv=argv)
    from ..ops import df64 as dfm
    from ..ops import oracle
    from ..native import host
    from ..utils import devgen

    dev = args.device
    sizes = common.sweep_sizes(args, MIN_SIZE, ALIGN, dense_step=2 * 10**6)
    max_n = max(sizes)
    variants = [v for v in VARIANTS if args.error or v[2] != "oracle"]
    names = [v[0] for v in variants]
    fams = sorted({v[1] for v in variants} - {"oracle"})
    calls = {nm: tier_call(kind, kw) for nm, _, kind, kw in variants if kind != "oracle"}

    if not args.error:
        timer = common.timer(dev)
        x32 = devgen.gen_f32((max_n,), SEED, "dot_x", 0, dev)
        y32 = devgen.gen_f32((max_n,), SEED, "dot_y", 0, dev)
        common.emit_header("n", names)
        for n in sizes:
            row = {}
            for fam in fams:
                xf, yf = family_arrays(fam, x32[:n], y32[:n], SEED, 0)
                for nm, f, kind, kw in variants:
                    if f != fam:
                        continue
                    row[nm] = common.guarded(
                        lambda: 2.0 * n / (timer(lambda: calls[nm](xf, yf)) * 1e-3) / 1e9,
                        f"{nm} n={n}")
                    common.progress(f"{nm} n={n}: {row[nm]:.1f} GFLOP/s")
                del xf, yf
            common.emit_row(n, [row[nm] for nm in names])
        return

    run = common.run_once(dev)
    common.progress(f"host master data: {host.describe()}")
    errs = {n: {nm: [] for nm in names} for n in sizes}
    for r in range(args.randomizations):
        # a fresh master per randomization (the write_random + convert_from
        # rerun, cuda/dot_benchmark.cu:195-200): the card and the host replay
        # draw the same stream
        x32 = devgen.gen_f32((max_n,), SEED, "dot_x", r, dev)
        y32 = devgen.gen_f32((max_n,), SEED, "dot_y", r, dev)
        x64 = devgen.master_f64((max_n,), SEED, "dot_x", r)
        y64 = devgen.master_f64((max_n,), SEED, "dot_y", r)
        refs = {n: float(x64[:n] @ y64[:n]) for n in sizes}
        del x64, y64
        for fam in fams:
            xf, yf = family_arrays(fam, x32, y32, SEED, r)
            for nm, f, kind, kw in variants:
                if f != fam:
                    continue
                for n in sizes:
                    def eval_once(n=n, nm=nm, kind=kind):
                        out = run(lambda: calls[nm](xf[:n], yf[:n]))
                        got = float(dfm.df_to_f64(out)) if kind == "df" else float(out.double())
                        return abs(got - refs[n]) / abs(refs[n])

                    errs[n][nm].append(common.guarded(eval_once, f"{nm} n={n}"))
                common.progress(f"r={r} {nm} done")
            del xf, yf
        if "oracle" in (v[1] for v in variants):
            # the split operands replace the f32 copies (hi is the f32 copy,
            # bit for bit): free those first
            del x32, y32
            xh, xl = devgen.split_df64(None, (max_n,), SEED, "dot_x", r, dev)
            yh, yl = devgen.split_df64(None, (max_n,), SEED, "dot_y", r, dev)
            onm = names[-1]
            for n in sizes:
                def eval_oracle(n=n):
                    out = run(lambda: oracle.dot_df64(xh[:n], xl[:n], yh[:n], yl[:n]))
                    return abs(float(dfm.df_to_f64(out)) - refs[n]) / abs(refs[n])

                errs[n][onm].append(common.guarded(eval_oracle, f"oracle n={n}"))
            common.progress(f"r={r} oracle done")
            del xh, xl, yh, yl
    common.emit_header("n", names)
    for n in sizes:
        common.emit_row(n, [common.median(errs[n][nm]) for nm in names])


if __name__ == "__main__":
    main()
