"""GEMV benchmark driver, the ``gemv_benchmark`` executable analogue
(reference ``cuda/gemv_benchmark.cu``; counterpart of
``accblas_tpu.bench.gemv_benchmark``, with its variants, order and CSV).

    python -m accblas_tpu_torch.bench.gemv_benchmark [--error] [--size N] [--device cpu]

A square sweep over leading views of one max-size allocation (the
reference's stride trick, ``cuda/gemv_benchmark.cu:211-215``). The kernel
takes a row-major contiguous A, so a size below the maximum runs on a copy
of the leading block, made once per size and storage, outside the timed
calls. alpha = beta = 1 (``cuda/gemv_benchmark.cu:25-28``). Speed mode
reports GFLOP/s = 2·n² / t, t from ``benchmark_function``; error mode the
1-norm relative error against the numpy fp64 product of the master data
(``cuda/gemv_benchmark.cu:219-231``), each variant run once, untimed, and
the df64 device oracle over the split master (``ops.oracle.gemv_df64``)
last. The vendor columns run ``xla_gemv``, which is ``torch.mv`` on the
card. Data is drawn on the device with a host-replayed fp64 master
(``utils.devgen``).
"""

from __future__ import annotations

import torch

from ..utils.memory import lead
from . import common

MIN_SIZE = 128
DEFAULT_SIZE = 16384
ALIGN = 128
ALPHA, BETA = 1.0, 1.0
SEED = 42

VARIANTS = [
    ("GEMV fp32", "f32", "fixed", {}),
    ("GEMV bf16", "bf16", "fixed", {}),
    ("GEMV Acc<f32,f32>", "f32", "acc32", {}),
    ("GEMV Acc<bf16,bf16>", "bf16", "accbf16", {}),
    ("GEMV Acc<df64,f32>", "f32", "df", {}),
    ("GEMV Acc<df64,f32> precise", "f32", "df", {"precise": True}),
    ("GEMV Acc<f32,bf16>", "bf16", "acc32", {}),
    ("GEMV Acc<df64,bf16>", "bf16", "df", {}),
    ("GEMV Acc<f32,f16>", "f16", "acc32", {}),
    ("GEMV Acc<f32,f8e4m3>", "f8", "acc32", {}),
    ("torch GEMV fp32", "f32", "vendor", {}),
    ("torch GEMV bf16", "bf16", "vendor", {}),
    ("GEMV df64 oracle (device)", "oracle", "oracle", {}),  # error mode only
]


def family_arrays(fam: str, a32, x32, seed: int):
    from ..utils import devgen
    from ..utils.sr import sr_round_device_chunked

    if fam == "f32":
        return a32, x32
    if fam in ("bf16", "f16"):
        dt = torch.bfloat16 if fam == "bf16" else torch.float16
        return a32.to(dt), x32.to(dt)
    if fam == "f8":
        ga, gx = (devgen.generator(seed, "sr", 0, sub, a32.device) for sub in (0, 1))
        return (sr_round_device_chunked(a32, "f8e4m3", ga),
                sr_round_device_chunked(x32, "f8e4m3", gx))
    raise ValueError(fam)


def tier_call(kind: str, kw: dict, fam: str):
    """fn(a, x, r) running one column's tier; the bf16 fixed and identity
    tiers take res in bf16, as the JAX driver's do."""
    from ..ops import gemv as gemvops

    if kind == "fixed":
        if fam == "bf16":
            return lambda a, x, r: gemvops.gemv(a, x, r.to(torch.bfloat16), ALPHA, BETA)
        return lambda a, x, r: gemvops.gemv(a, x, r, ALPHA, BETA)
    if kind == "df":
        return lambda a, x, r: gemvops.acc_gemv(a, x, r, ALPHA, BETA, ar="df64", **kw)
    if kind == "acc32":
        return lambda a, x, r: gemvops.acc_gemv(a, x, r, ALPHA, BETA, ar="f32")
    if kind == "accbf16":
        return lambda a, x, r: gemvops.acc_gemv(a, x, r.to(a.dtype), ALPHA, BETA, ar="bf16")
    return lambda a, x, r: gemvops.xla_gemv(a, x, r, ALPHA, BETA)


def main(argv=None):
    args = common.parse_args("gemv_benchmark", DEFAULT_SIZE, MIN_SIZE, argv=argv)
    from ..native import host
    from ..ops import df64 as dfm
    from ..ops import oracle
    from ..utils import devgen
    from ..utils.compare import relative_error

    dev = args.device
    sizes = common.sweep_sizes(args, MIN_SIZE, ALIGN, dense_step=1024)
    max_n = max(sizes)
    variants = [v for v in VARIANTS if args.error or v[2] != "oracle"]
    names = [v[0] for v in variants]
    fams = sorted({v[1] for v in variants} - {"oracle"})
    calls = {nm: tier_call(kind, kw, f) for nm, f, kind, kw in variants if kind != "oracle"}
    common.emit_header("rows", names)

    a32 = devgen.gen_f32((max_n, max_n), SEED, "gemv_a", 0, dev)
    x32 = devgen.gen_f32((max_n,), SEED, "gemv_x", 0, dev)
    r32 = devgen.gen_f32((max_n,), SEED, "gemv_res", 0, dev)
    results = {n: {} for n in sizes}

    if not args.error:
        timer = common.timer(dev)
        for fam in fams:
            af, xf = family_arrays(fam, a32, x32, SEED)
            for n in sizes:
                a_, x_, r_ = lead(af, n), lead(xf, n), lead(r32, n)
                for nm, f, kind, kw in variants:
                    if f != fam:
                        continue
                    results[n][nm] = common.guarded(
                        lambda: 2.0 * n * n / (timer(lambda: calls[nm](a_, x_, r_)) * 1e-3)
                        / 1e9, f"{nm} n={n}")
                    common.progress(f"{nm} n={n}: {results[n][nm]:.1f} GFLOP/s")
                del a_, x_
            del af, xf
        for n in sizes:
            common.emit_row(n, [results[n][nm] for nm in names])
        return

    run = common.run_once(dev)
    common.progress(f"host master data: {host.describe()}")
    a64 = devgen.master_f64((max_n, max_n), SEED, "gemv_a")
    x64 = devgen.master_f64((max_n,), SEED, "gemv_x")
    r64 = devgen.master_f64((max_n,), SEED, "gemv_res")
    refs = {n: ALPHA * (a64[:n, :n] @ x64[:n]) + BETA * r64[:n] for n in sizes}
    del a64, x64, r64
    for fam in fams:
        af, xf = family_arrays(fam, a32, x32, SEED)
        for n in sizes:
            a_, x_, r_ = lead(af, n), lead(xf, n), lead(r32, n)
            for nm, f, kind, kw in variants:
                if f != fam:
                    continue

                def eval_once(n=n, nm=nm):
                    out = run(lambda: calls[nm](a_, x_, r_))
                    return relative_error(out.double().cpu().numpy(), refs[n])

                results[n][nm] = common.guarded(eval_once, f"{nm} n={n}")
            del a_, x_
        common.progress(f"{fam} storage error done")
        del af, xf
    if "oracle" in (v[1] for v in variants):
        onm = names[-1]
        del a32  # the split is the high-water mark; hi is the f32 copy
        ah, al = devgen.split_df64(None, (max_n, max_n), SEED, "gemv_a", 0, dev)
        xh, xl = devgen.split_df64(None, (max_n,), SEED, "gemv_x", 0, dev)
        rh, rl = devgen.split_df64(None, (max_n,), SEED, "gemv_res", 0, dev)
        for n in sizes:
            def eval_oracle(n=n):
                def once():
                    ax = oracle.gemv_df64(lead(ah, n), lead(al, n), xh[:n], xl[:n])
                    return dfm.df_add(dfm.df_mul_f32(ax, ALPHA),
                                      dfm.df_mul_f32(dfm.DF(rh[:n], rl[:n]), BETA))

                out = run(once)
                got = (out.hi.double() + out.lo.double()).cpu().numpy()
                return relative_error(got, refs[n])

            results[n][onm] = common.guarded(eval_oracle, f"oracle n={n}")
            common.progress(f"oracle n={n} done")
    for n in sizes:
        common.emit_row(n, [results[n][nm] for nm in names])


if __name__ == "__main__":
    main()
