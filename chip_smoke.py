#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (accblas_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the kernels of accblas_tpu_torch/csrc with nvcc;
  3. checks: every tier of the DOT and GEMV kernels at mid and ragged sizes,
     held against the plain torch version on the same inputs and against a
     float64 reduction on the card, under accblas_tpu_torch.utils.tolerance;
  4. main path at full size through the public API: acc_dot Acc<f32, bf16>
     at n = 2^29, acc_gemv Acc<f32, bf16> at 16384^2 (beta = 0), and the
     flagship 1024x2048 GEMV (alpha = beta = 1) from seeded host data; each
     checked against float64, with the launch counters reset just before and
     read just after;
  5. timing of each kernel and of its plain version at the main-path shapes
     (1 warm-up, 10 reps, minimum, CUDA events).
The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

N_DOT = 2**29
N_GEMV = 16384
SEED = 42


def log(msg: str):
    print(msg, flush=True)


# --------------------------------------------------------------------------
# phase 1 + 2
# --------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    # vendor tiers in genuine f32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    return smi


def phase_build():
    from accblas_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build()
    log(f"build: {', '.join(p.name for p in paths)} in {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# phase 3: kernel vs plain vs float64
# --------------------------------------------------------------------------

class Checks:
    def __init__(self):
        self.failures: list[str] = []

    def record(self, ok: bool, line: str):
        log(("ok   " if ok else "FAIL ") + line)
        if not ok:
            self.failures.append(line)


def _dot_case(chk: Checks, label: str, x, y, ar: str, precise=False, init=None, fixed=False):
    from accblas_tpu_torch.ops import _build
    from accblas_tpu_torch.ops import dot as dotops
    from accblas_tpu_torch.ops import df64 as dfm
    from accblas_tpu_torch.utils import tolerance

    if fixed:
        got = dotops.dot(x, y, init=init).double()
    else:
        out = dotops.acc_dot(x, y, ar, precise=precise, init=init)
        got = dfm.df_to_f64(out) if ar == "df64" else out.double()
    tier = _build.tier(ar, precise, "dot")
    hi, lo = dotops._dot_plain(x, y, tier, 0.0 if init is None else float(init))
    plain = hi.double() + lo.double()
    ref = torch.dot(x.double(), y.double()) + (0.0 if init is None else float(init))
    den = float(ref.abs())
    k_err = float((got - ref).abs()) / den
    p_err = float((plain - ref).abs()) / den
    kp = float((got - plain).abs()) / den
    if tier in tolerance.TOL:
        tol = tolerance.TOL[tier]
        ok = k_err <= tol and p_err <= tol and kp <= 2 * tol
    else:
        tol = tolerance.narrow_bound(p_err)
        ok = k_err <= tol
    chk.record(ok, f"dot {label} n={x.shape[0]}: kernel_err={k_err:.3e} plain_err={p_err:.3e} "
                   f"kernel_vs_plain={kp:.3e} bound={tol:.3e}")


def _gemv_case(chk: Checks, label: str, a, x, res, alpha, beta, ar, precise=False,
               df_out=False, fixed=False):
    from accblas_tpu_torch.ops import _build
    from accblas_tpu_torch.ops import gemv as gemvops
    from accblas_tpu_torch.ops import df64 as dfm
    from accblas_tpu_torch.utils import tolerance

    if fixed:
        out = gemvops.gemv(a, x, res, alpha, beta)
    else:
        out = gemvops.acc_gemv(a, x, res, alpha, beta, ar, precise=precise, df_out=df_out)
    tier = _build.tier(ar, precise, "gemv")
    plain = gemvops._gemv_plain(a, x, res, float(alpha), float(beta), tier, df_out)
    if df_out:
        got, plain, out_dt = dfm.df_to_f64(out), dfm.df_to_f64(plain), None
    else:
        got, plain, out_dt = out.double(), plain.double(), res.dtype
    a64, x64 = a.double(), x.double()
    rterm = 0.0 if beta == 0 else beta * res.double()
    ref = alpha * torch.mv(a64, x64) + rterm
    scale = abs(alpha) * torch.mv(a64.abs(), x64.abs())
    if beta != 0:
        scale = scale + abs(beta) * res.double().abs()
    finite = bool(torch.isfinite(got).all())
    k_err = tolerance.gemv_row_err(got, ref, scale, out_dt)
    p_err = tolerance.gemv_row_err(plain, ref, scale, out_dt)
    kp = tolerance.gemv_row_err(got, plain, scale, out_dt)
    if tier in tolerance.TOL:
        tol = tolerance.TOL[tier]
        ok = finite and k_err <= tol and p_err <= tol and kp <= 2 * tol
    else:
        tol = tolerance.narrow_bound(p_err)
        ok = finite and k_err <= tol
    chk.record(ok, f"gemv {label} {a.shape[0]}x{a.shape[1]}: kernel_err={k_err:.3e} "
                   f"plain_err={p_err:.3e} kernel_vs_plain={kp:.3e} bound={tol:.3e} "
                   f"finite={finite}")


def phase_checks():
    from accblas_tpu_torch.utils import devgen

    dev = torch.device("cuda", 0)
    chk = Checks()
    bf, f16 = torch.bfloat16, torch.float16
    e4, e5 = torch.float8_e4m3fn, torch.float8_e5m2

    for n in (2**24, 100003):
        x = devgen.gen_f32((n,), SEED, "dot_x", dev)
        y = devgen.gen_f32((n,), SEED, "dot_y", dev)
        xb, yb = x.to(bf), y.to(bf)
        _dot_case(chk, "fixed f32", x, y, "f32", fixed=True)
        _dot_case(chk, "fixed bf16", xb, yb, "bf16", fixed=True)
        for st in (bf, f16, e4, e5):
            _dot_case(chk, f"Acc<f32,{st}>", x.to(st), y.to(st), "f32")
        _dot_case(chk, "Acc<f32,f32 x bf16 y>", x, yb, "f32")
        for st in (torch.float32, bf):
            for precise in (False, True):
                _dot_case(chk, f"Acc<df64,{st}> precise={precise}", x.to(st), y.to(st),
                          "df64", precise=precise)
        _dot_case(chk, "Acc<f32,bf16> init=2.5", xb, yb, "f32", init=2.5)
        _dot_case(chk, "Acc<df64,f32> precise init=-3.25", x, y, "df64", precise=True,
                  init=-3.25)
        del x, y, xb, yb

    for m, n in ((4096, 4096), (1000, 12345)):
        a = devgen.gen_f32((m, n), SEED, "gemv_a", dev)
        x = devgen.gen_f32((n,), SEED, "gemv_x", dev)
        r = devgen.gen_f32((m,), SEED, "gemv_res", dev)
        ab, xb = a.to(bf), x.to(bf)
        nan = torch.full((m,), float("nan"), device=dev)
        _gemv_case(chk, "fixed f32 a=1.5 b=0.5", a, x, r, 1.5, 0.5, "f32", fixed=True)
        _gemv_case(chk, "fixed bf16", ab, xb, r.to(bf), 1.0, 1.0, "bf16", fixed=True)
        _gemv_case(chk, "Acc<f32,bf16>", ab, xb, r, 1.0, 1.0, "f32")
        for st in (torch.float32, bf):
            for precise in (False, True):
                _gemv_case(chk, f"Acc<df64,{st}> precise={precise}", a.to(st), x.to(st), r,
                           1.5, 0.5, "df64", precise=precise)
        _gemv_case(chk, "Acc<df64,f32> precise df_out", a, x, r, 1.5, 0.5, "df64",
                   precise=True, df_out=True)
        _gemv_case(chk, "fixed f32 beta=0 res=NaN", a, x, nan, 1.0, 0.0, "f32", fixed=True)
        _gemv_case(chk, "Acc<df64,bf16> beta=0 res=NaN", ab, xb, nan, 1.0, 0.0, "df64")
        del a, x, r, ab, xb

    torch.cuda.synchronize()
    if chk.failures:
        raise AssertionError(f"{len(chk.failures)} kernel checks failed:\n" +
                             "\n".join(chk.failures))


# --------------------------------------------------------------------------
# phase 4 + 5: the main path, then timings
# --------------------------------------------------------------------------

def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref).abs()) / float(ref.abs())


def phase_main() -> list[dict]:
    from accblas_tpu_torch import acc_dot, acc_gemv
    from accblas_tpu_torch.ops import dot as dotops
    from accblas_tpu_torch.ops import gemv as gemvops
    from accblas_tpu_torch.utils import MatrixInfo, devgen, gen_mtx, interop, tolerance
    from accblas_tpu_torch.utils.bench import benchmark_function

    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    xb = devgen.gen_f32((N_DOT,), SEED, "dot_x", dev).to(bf)
    yb = devgen.gen_f32((N_DOT,), SEED, "dot_y", dev).to(bf)
    ab = devgen.gen_f32((N_GEMV, N_GEMV), SEED, "gemv_a", dev).to(bf)
    xg = devgen.gen_f32((N_GEMV,), SEED, "gemv_x", dev).to(bf)
    rg = devgen.gen_f32((N_GEMV,), SEED, "gemv_res", dev)
    # the flagship op of __graft_entry__.entry(): seeded host masters
    me, ne = 1024, 2048
    ae = interop.from_numpy(gen_mtx(MatrixInfo(me, ne), seed=42).astype("float32"),
                            device=dev).to(bf)
    xe = interop.from_numpy(gen_mtx(MatrixInfo(1, ne), seed=43)[0].astype("float32"),
                            device=dev).to(bf)
    re = interop.from_numpy(gen_mtx(MatrixInfo(1, me), seed=44)[0].astype("float32"),
                            device=dev)
    torch.cuda.synchronize()

    # ---- the main path, through the public API ----
    dotops.launches = 0
    gemvops.launches = 0
    d = acc_dot(xb, yb, ar="f32")
    g = acc_gemv(ab, xg, rg, 1.0, 0.0, ar="f32")
    e = acc_gemv(ae, xe, re, 1.0, 1.0, ar="f32")
    torch.cuda.synchronize()
    launches = {"dot": dotops.launches, "gemv": gemvops.launches}
    log(f"main path launches: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"main path did not launch every kernel: {launches}")

    # ---- its results against float64 and the plain versions, on the card ----
    tol = tolerance.TOL["f32"]
    ref = torch.dot(xb.double(), yb.double())
    plain, _ = dotops._dot_plain(xb, yb, "f32", 0.0)
    k_err, p_err = _rel(d, ref), _rel(plain, ref)
    kp = float((d.double() - plain.double()).abs()) / float(ref.abs())
    max_abs = {"dot": float((d.double() - plain.double()).abs()), "gemv": 0.0}
    log(f"main dot Acc<f32,bf16> n={N_DOT}: value={float(d):.9g} kernel_err={k_err:.3e} "
        f"plain_err={p_err:.3e} kernel_vs_plain={kp:.3e} bound={tol:.1e}")
    if not (d.dtype == torch.float32 and math.isfinite(float(d))
            and max(k_err, p_err) <= tol and kp <= 2 * tol):
        raise AssertionError("main-path DOT out of bounds")
    del ref, plain
    for label, out, a, x, r, beta in ((f"{N_GEMV}^2 beta=0", g, ab, xg, rg, 0.0),
                                      ("entry 1024x2048", e, ae, xe, re, 1.0)):
        plain = gemvops._gemv_plain(a, x, r, 1.0, beta, "f32", False)
        a64, x64 = a.double(), x.double()
        ref = torch.mv(a64, x64) + beta * r.double()
        scale = torch.mv(a64.abs(), x64.abs()) + beta * r.double().abs()
        k_err = tolerance.gemv_row_err(out, ref, scale, out.dtype)
        p_err = tolerance.gemv_row_err(plain, ref, scale, out.dtype)
        kp = tolerance.gemv_row_err(out, plain, scale, out.dtype)
        max_abs["gemv"] = max(max_abs["gemv"], float((out - plain).abs().max()))
        log(f"main gemv Acc<f32,bf16> {label}: shape={tuple(out.shape)} kernel_err={k_err:.3e} "
            f"plain_err={p_err:.3e} kernel_vs_plain={kp:.3e} bound={tol:.1e}")
        if not (out.shape == r.shape and out.dtype == torch.float32
                and bool(torch.isfinite(out).all()) and max(k_err, p_err) <= tol
                and kp <= 2 * tol):
            raise AssertionError(f"main-path GEMV {label} out of bounds")
        del plain, a64, x64, ref, scale

    # ---- timings: kernel, plain, plain, kernel ----
    def dot_k():
        return acc_dot(xb, yb, ar="f32")

    def dot_p():
        return dotops._dot_plain(xb, yb, "f32", 0.0)

    def gemv_k():
        return acc_gemv(ab, xg, rg, 1.0, 0.0, ar="f32")

    def gemv_p():
        return gemvops._gemv_plain(ab, xg, rg, 1.0, 0.0, "f32", False)

    def best(fk, fp):
        k1, p1, p2, k2 = (benchmark_function(f) for f in (fk, fp, fp, fk))
        return min(k1, k2), min(p1, p2)

    dot_ms, dot_plain_ms = best(dot_k, dot_p)
    gemv_ms, gemv_plain_ms = best(gemv_k, gemv_p)
    dot_bytes = N_DOT * (2 + 2)
    gemv_bytes = N_GEMV * N_GEMV * 2 + N_GEMV * 2 + N_GEMV * 4
    for name, flops, nbytes, ms, pms in (
        (f"dot Acc<f32,bf16> n={N_DOT}", 2 * N_DOT, dot_bytes, dot_ms, dot_plain_ms),
        (f"gemv Acc<f32,bf16> {N_GEMV}^2", 2 * N_GEMV**2, gemv_bytes, gemv_ms, gemv_plain_ms),
    ):
        log(f"time {name}: kernel {ms:.4f} ms {flops / ms / 1e6:.1f} GFLOP/s "
            f"{nbytes / ms / 1e6:.1f} GB/s | plain {pms:.4f} ms "
            f"{flops / pms / 1e6:.1f} GFLOP/s {nbytes / pms / 1e6:.1f} GB/s")

    # the GEMV tiers the TPU served with its full-row kernel, at 16384^2
    a32 = ab.float()
    x32 = xg.float()
    for label, fk, fp, nbytes in (
        (f"gemv fixed f32 {N_GEMV}^2",
         lambda: gemvops.gemv(a32, x32, rg, 1.0, 0.0),
         lambda: gemvops._gemv_plain(a32, x32, rg, 1.0, 0.0, "f32", False),
         N_GEMV * N_GEMV * 4 + N_GEMV * 8),
        (f"gemv Acc<df64,bf16> fast {N_GEMV}^2",
         lambda: acc_gemv(ab, xg, rg, 1.0, 0.0, ar="df64"),
         lambda: gemvops._gemv_plain(ab, xg, rg, 1.0, 0.0, "df64_fast", False),
         gemv_bytes),
    ):
        ms, pms = best(fk, fp)
        log(f"time {label}: kernel {ms:.4f} ms {nbytes / ms / 1e6:.1f} GB/s | "
            f"plain {pms:.4f} ms {nbytes / pms / 1e6:.1f} GB/s")
    del a32, x32

    return [
        {"name": "dot", "route": "cuda", "source": "accblas_tpu_torch/csrc/dot.cu",
         "replaces": "accblas_tpu/ops/dot.py:136", "launches": launches["dot"],
         "max_abs_err": max_abs["dot"], "ms": dot_ms, "plain_ms": dot_plain_ms},
        {"name": "gemv", "route": "cuda", "source": "accblas_tpu_torch/csrc/gemv.cu",
         "replaces": "accblas_tpu/ops/gemv.py:147", "launches": launches["gemv"],
         "max_abs_err": max_abs["gemv"], "ms": gemv_ms, "plain_ms": gemv_plain_ms},
    ]


def main() -> int:
    phase_device()
    phase_build()
    phase_checks()
    kernels = phase_main()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
