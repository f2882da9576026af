#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (accblas_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the kernels of accblas_tpu_torch/csrc with nvcc;
  3. checks: every tier of the DOT and GEMV kernels at mid and ragged sizes,
     held against the plain torch version on the same inputs and against a
     float64 reduction on the card, under accblas_tpu_torch.utils.tolerance;
     the TRSV/TRSM sweep in every mode, storage and tier, and the triangular
     residual, at n = 1000 (ragged) and 4096 on seeded LU factors, against
     the plain versions and a float64 solve of the stored triangle; the
     masked leaf gather bit for bit against its plain version in every mode;
     50 back-to-back TRSV and TRSM calls on one stream, bit for bit equal;
     and a solve whose grid holds more block rows than the card holds
     sweep CTAs at once (the occupancy is printed), against float64;
  4. main path at full size through the public API: acc_dot Acc<f32, bf16>
     at n = 2^29, acc_gemv Acc<f32, bf16> at 16384^2 (beta = 0), and the
     flagship 1024x2048 GEMV (alpha = beta = 1) from seeded host data; then
     trsv fixed f32 and acc_trsv Acc<df64, f32> at n = 16384 (upper, unit,
     A = uniform(-1, 1)/n, b = ones, as bench.py) and the df64 residual of
     the f32 solution (tri_gemv_df64); each checked against float64, with the
     launch counters reset just before and read just after each path; the
     TRSV calls are profiled (torch.profiler), and the sweep must be one
     kernel launch per call;
  5. timing of each kernel, of its plain version and of the one PyTorch call
     that computes the same function, where there is one, at the main-path
     shapes (1 warm-up, 10 reps, minimum, CUDA events), beside the least time
     the card could take (bytes over 3.35 TB/s or f32 flops over 67 TFLOP/s);
     and acc_trsm at n = 16384 with k = 8 and 64 right-hand sides, checked
     against float64 and timed beside torch.linalg.solve_triangular.
The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. A CUDA fault fails the run naming the phase;
in a TRSV phase that includes the sweep's bounded spin-wait, which traps
when a wait runs out (accblas_tpu_torch/csrc/trsv.cu).
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
N_TRSV = 16384
SEED = 42
# the card's published peaks (H100 SXM data sheet): device memory bytes/s,
# and float32 flop/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time in ms the card could take for work that must move
    `nbytes` and do `flops` f32 operations, and which of the two bounds it."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


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

    def raise_failures(self):
        if self.failures:
            raise AssertionError(f"{len(self.failures)} kernel checks failed:\n" +
                                 "\n".join(self.failures))


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


def _packed_lu(n: int, seed: int, dev):
    """The JAX tests' TRSV operand (tests/test_trsv.py): the packed LU factor
    of a diagonally dominant seeded matrix, and a seeded right-hand side,
    made on the host. `ldu` is the same factor with U's strict upper triangle
    scaled by U's diagonal (the LDU form): the operand of the unit-upper
    mode, which on the raw factor drops U's large diagonal and is
    exponentially ill-conditioned."""
    import numpy as np
    import scipy.linalg
    from accblas_tpu_torch.utils import MatrixInfo, gen_mtx, interop

    a64 = gen_mtx(MatrixInfo(n, n), seed=seed) + np.eye(n) * (0.25 * n)
    lu, _ = scipy.linalg.lu_factor(a64)
    ldu = np.tril(lu) + np.triu(lu, 1) / np.diag(lu)[:, None]
    b = gen_mtx(MatrixInfo(1, n), seed=seed + 1)[0]
    return tuple(interop.from_numpy(v.astype(np.float32), device=dev) for v in (lu, ldu, b))


def _tri64(a, uplo: str, unit: bool):
    t = a.double()
    t = torch.tril(t) if uplo == "lower" else torch.triu(t)
    if unit:
        t.fill_diagonal_(1.0)
    return t


def _solve64(a, b, uplo: str, unit: bool):
    """float64 solve of the stored triangle, on the card."""
    x = torch.linalg.solve_triangular(_tri64(a, uplo, unit), b.double().reshape(b.shape[0], -1),
                                      upper=uplo != "lower")
    return x.reshape(b.shape)


def _rel1(got, ref) -> float:
    got, ref = got.double().reshape(-1), ref.double().reshape(-1)
    return float((got - ref).abs().sum() / ref.abs().sum())


def trsv_plain(a, b, uplo: str, unit: bool, ar: str, out_dtype):
    """The whole solve through the plain versions only: leaf gather, the
    batched inversion the kernel path uses too, and the plain sweep."""
    from accblas_tpu_torch.ops import trsv as trsvops

    n = a.shape[0]
    nb = -(-n // trsvops.BLOCK)
    lower = uplo == "lower"
    d = trsvops._extract_leaf_diag_plain(a, nb * trsvops.BLOCK // trsvops.LEAF, lower, unit)
    inv = trsvops._leaf_inverses(d, lower)
    bt = trsvops._rhs_panels(b.reshape(n, -1), nb)
    return trsvops._trsv_sweep_plain(a, inv, bt, uplo == "lower", ar, out_dtype).reshape(b.shape)


def _trsv_case(chk: Checks, label: str, fn: str, a, b, uplo: str, unit: bool, ar: str,
               tol: float):
    """One public TRSV/TRSM call through the kernels, against the plain
    versions and float64. Bounds: the JAX tests' (tests/test_trsv.py)."""
    import accblas_tpu_torch

    kw = {"ar": ar} if fn.startswith("acc_") else {}
    got = getattr(accblas_tpu_torch, fn)(a, b, uplo, unit, unstable_ok=True, **kw)
    plain = trsv_plain(a, b, uplo, unit, ar, got.dtype)
    ref = _solve64(a, b, uplo, unit)
    finite = bool(torch.isfinite(got).all())
    k_err, p_err, kp = _rel1(got, ref), _rel1(plain, ref), _rel1(got, plain)
    ok = finite and k_err < tol and p_err < tol and kp < 2 * tol
    chk.record(ok, f"{fn} {label} n={a.shape[0]} {uplo} unit={unit} ar={ar}: "
                   f"kernel_err={k_err:.3e} plain_err={p_err:.3e} kernel_vs_plain={kp:.3e} "
                   f"bound={tol:.1e} finite={finite}")


def _tri_gemv_case(chk: Checks, a, x, b, uplo: str, unit: bool):
    """tri_gemv_df64 against its plain version and float64: the 1-norm error
    below 1e-6 of ||T x||_1 (the JAX test's bound)."""
    from accblas_tpu_torch.ops import tri_gemv as trigops

    got = trigops.tri_gemv_df64(a, x, b, uplo, unit)
    plain = trigops._tri_gemv_plain(a, x, b, uplo == "lower", unit)
    tx = _tri64(a, uplo, unit) @ x.double()
    ref, den = b.double() - tx, float(tx.abs().sum())
    k_err = float((got.double() - ref).abs().sum()) / den
    p_err = float((plain.double() - ref).abs().sum()) / den
    kp = float((got.double() - plain.double()).abs().sum()) / den
    ok = bool(torch.isfinite(got).all()) and k_err < 1e-6 and p_err < 1e-6 and kp < 2e-6
    chk.record(ok, f"tri_gemv_df64 {a.dtype} n={a.shape[0]} {uplo} unit={unit}: "
                   f"kernel_err={k_err:.3e} plain_err={p_err:.3e} kernel_vs_plain={kp:.3e} "
                   f"bound=1.0e-06")


def _repeat_check(chk: Checks, lu, b, bm):
    """50 TRSV and 50 TRSM calls queued on one stream without a
    synchronisation: each sweep resets its counters, and all results carry
    the first call's bits."""
    import accblas_tpu_torch

    for ar in ("f32", "df64"):
        xs = [accblas_tpu_torch.acc_trsv(lu, b, "upper", False, ar=ar) for _ in range(50)]
        ms = [accblas_tpu_torch.acc_trsm(lu, bm, "lower", True, ar=ar) for _ in range(50)]
        torch.cuda.synchronize()
        same = all(torch.equal(xs[0], x) for x in xs[1:]) and all(
            torch.equal(ms[0], m) for m in ms[1:])
        chk.record(same, f"trsv/trsm {ar} n={lu.shape[0]} k=1 and {bm.shape[1]}: 50 back-to-back "
                         f"calls each on one stream, bits repeat={same}")


def _progress_check(chk: Checks, dev):
    """A grid of more block rows than the card holds sweep CTAs at once, on
    the main path's operand: the tickets keep the sweep advancing."""
    import accblas_tpu_torch
    from accblas_tpu_torch.ops import trsv as trsvops
    from accblas_tpu_torch.utils import devgen

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    occ = {(ar, k): trsvops.sweep_occupancy(torch.float32, ar, k)
           for ar in ("f32", "df64") for k in (1, 4)}
    resident = occ[("f32", 1)] * sms
    log(f"trsv sweep occupancy (CTAs of {trsvops.LEAF * 4} threads per SM, f32 A): "
        + ", ".join(f"{ar} k{'=1' if k == 1 else '>1'}: {v}" for (ar, k), v in occ.items())
        + f"; x {sms} SMs = {resident} resident for f32 k=1; "
        f"n={N_TRSV} has {N_TRSV // trsvops.LEAF} block rows")
    n = max(20000, trsvops.LEAF * (resident + 49) + 17)
    nr = -(-n // trsvops.LEAF)
    a = devgen.gen_f32((n, n), SEED, "trsv_a", dev).mul_(1.0 / n)
    b = torch.ones(n, device=dev)
    x = accblas_tpu_torch.trsv(a, b, "upper", True)
    ref = _solve64(a, b, "upper", True)
    err = _rel1(x, ref)
    ok = nr > resident and bool(torch.isfinite(x).all()) and err < 1e-4
    chk.record(ok, f"trsv fixed f32 n={n} upper unit: {nr} block rows > {resident} resident "
                   f"CTAs, err={err:.3e} bound=1.0e-04")
    del a, b, x, ref
    torch.cuda.empty_cache()


def trsv_checks(chk: Checks, dev):
    from accblas_tpu_torch.ops import trsv as trsvops
    from accblas_tpu_torch.utils import devgen

    bf, f16 = torch.bfloat16, torch.float16
    for n in (1000, 4096):
        lu, ldu, b = _packed_lu(n, SEED, dev)
        for uplo, unit in (("upper", True), ("lower", True), ("upper", False),
                           ("lower", False)):
            op = ldu if (uplo, unit) == ("upper", True) else lu
            _trsv_case(chk, "fixed f32", "trsv", op, b, uplo, unit, "f32", 1e-4)
        for st in (bf, f16):
            _trsv_case(chk, f"Acc<f32,{st}>", "acc_trsv", lu.to(st), b, "upper", False,
                       "f32", 1e-3)
        for st, (uplo, unit) in ((torch.float32, ("upper", False)),
                                 (torch.float32, ("lower", True)), (bf, ("upper", False))):
            _trsv_case(chk, f"Acc<df64,{st}>", "acc_trsv", lu.to(st), b, uplo, unit, "df64",
                       5e-6)
        for k in (3, 8):
            bm = devgen.gen_f32((n, k), SEED, "trsv_b", dev)
            _trsv_case(chk, f"fixed f32 k={k}", "trsm", lu, bm, "upper", False, "f32", 1e-4)
            _trsv_case(chk, f"Acc<df64,f32> k={k}", "acc_trsm", lu, bm, "lower", True, "df64",
                       5e-6)
        m = -(-n // trsvops.BLOCK) * trsvops.BLOCK // trsvops.LEAF
        # f8e5m2: the factor's diagonal (n/4) overflows e4m3 to NaN
        for st in (torch.float32, bf, torch.float8_e5m2):
            same = all(
                torch.equal(trsvops._extract_leaf_diag(lu.to(st), m, lower, unit).view(torch.int32),
                            trsvops._extract_leaf_diag_plain(lu.to(st), m, lower, unit)
                            .view(torch.int32))
                for lower in (False, True) for unit in (False, True))
            chk.record(same, f"masked leaf gather {st} n={n}, 4 modes: bits equal to the plain "
                             f"version={same}")
        if n == 4096:
            _repeat_check(chk, lu, b, devgen.gen_f32((n, 3), SEED, "trsv_b", dev))
        x = devgen.gen_f32((n,), SEED, "gemv_x", dev)
        _tri_gemv_case(chk, lu, x, b, "upper", False)
        _tri_gemv_case(chk, lu.to(bf), x, b, "lower", True)
        del lu, ldu, b
    _progress_check(chk, dev)


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
    chk.raise_failures()


def phase_trsv_checks():
    chk = Checks()
    trsv_checks(chk, torch.device("cuda", 0))
    torch.cuda.synchronize()
    chk.raise_failures()


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
    # the one PyTorch call computing the same function: the yardstick only
    dot_lib_ms = benchmark_function(lambda: torch.dot(xb, yb))
    gemv_lib_ms = benchmark_function(lambda: torch.mv(ab, xg))
    dot_bytes = N_DOT * (2 + 2)
    gemv_bytes = N_GEMV * N_GEMV * 2 + N_GEMV * 2 + N_GEMV * 4
    for name, flops, nbytes, ms, pms in (
        (f"dot Acc<f32,bf16> n={N_DOT}", 2 * N_DOT, dot_bytes, dot_ms, dot_plain_ms),
        (f"gemv Acc<f32,bf16> {N_GEMV}^2", 2 * N_GEMV**2, gemv_bytes, gemv_ms, gemv_plain_ms),
    ):
        log(f"time {name}: kernel {ms:.4f} ms {flops / ms / 1e6:.1f} GFLOP/s "
            f"{nbytes / ms / 1e6:.1f} GB/s | plain {pms:.4f} ms "
            f"{flops / pms / 1e6:.1f} GFLOP/s {nbytes / pms / 1e6:.1f} GB/s")
    dot_bound, dot_by = bound(dot_bytes, 2 * N_DOT)
    gemv_bound, gemv_by = bound(gemv_bytes, 2 * N_GEMV**2)
    log(f"time library torch.dot bf16 n={N_DOT}: {dot_lib_ms:.4f} ms | "
        f"torch.mv bf16 {N_GEMV}^2: {gemv_lib_ms:.4f} ms | bounds dot {dot_bound:.4f} ms, "
        f"gemv {gemv_bound:.4f} ms")

    # the GEMV tiers the TPU served with its full-row kernel, at 16384^2;
    # torch.mv computes the f32 tier's function, and no PyTorch call df64's
    a32 = ab.float()
    x32 = xg.float()
    for label, fk, fp, fl, nbytes in (
        (f"gemv fixed f32 {N_GEMV}^2",
         lambda: gemvops.gemv(a32, x32, rg, 1.0, 0.0),
         lambda: gemvops._gemv_plain(a32, x32, rg, 1.0, 0.0, "f32", False),
         lambda: torch.mv(a32, x32), N_GEMV * N_GEMV * 4 + N_GEMV * 8),
        (f"gemv Acc<df64,bf16> fast {N_GEMV}^2",
         lambda: acc_gemv(ab, xg, rg, 1.0, 0.0, ar="df64"),
         lambda: gemvops._gemv_plain(ab, xg, rg, 1.0, 0.0, "df64_fast", False),
         None, gemv_bytes),
    ):
        ms, pms = best(fk, fp)
        lib = "none" if fl is None else f"{benchmark_function(fl):.4f} ms"
        log(f"time {label}: kernel {ms:.4f} ms {nbytes / ms / 1e6:.1f} GB/s | "
            f"plain {pms:.4f} ms {nbytes / pms / 1e6:.1f} GB/s | library {lib} | "
            f"bound {bound(nbytes, 2 * N_GEMV**2)[0]:.4f} ms")
    del a32, x32

    return [
        {"name": "dot", "route": "cuda", "source": "accblas_tpu_torch/csrc/dot.cu",
         "replaces": "accblas_tpu/ops/dot.py:136", "launches": launches["dot"],
         "max_abs_err": max_abs["dot"], "ms": dot_ms, "plain_ms": dot_plain_ms,
         "bound_ms": dot_bound, "bound_by": dot_by, "library_ms": dot_lib_ms},
        {"name": "gemv", "route": "cuda", "source": "accblas_tpu_torch/csrc/gemv.cu",
         "replaces": "accblas_tpu/ops/gemv.py:147", "launches": launches["gemv"],
         "max_abs_err": max_abs["gemv"], "ms": gemv_ms, "plain_ms": gemv_plain_ms,
         "bound_ms": gemv_bound, "bound_by": gemv_by, "library_ms": gemv_lib_ms},
    ]


def profile_calls(label: str, fn, counted: dict, calls: int = 5) -> dict[str, tuple[float, float]]:
    """Device time by kernel over `calls` calls of `fn` (torch.profiler,
    "Self CUDA"), and the calls' wall time: where a call's time goes.
    `counted` maps a name in a port kernel's symbol to a function reading
    its wrapper's launch counter. The profiler drops a record now and then,
    so a kernel's device ms per call is its mean time per record times the
    launches its wrapper counted per call; a drop is logged. A port kernel
    (namespace accblas) that no counter names, or more records than counted
    launches, fails the run. Returns {name: (device ms, launches) per call}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    before = {name: read() for name, read in counted.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls * 1e3
    launched = {name: read() - before[name] for name, read in counted.items()}
    # (symbol, total device ms, records, whether a device record)
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count,
                    e.device_type != DeviceType.CPU)
                   for e in prof.key_averages() if e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows if r[3]) / calls
    log(f"profile {label}: wall {wall:.4f} ms/call, device busy {busy:.4f} ms/call")
    for key, ms, count, _ in rows[:8]:
        log(f"  {ms / calls:9.4f} ms/call  {count:4d} records/{calls} calls  {key[:90]}")
    for key, *_ in rows:
        if "accblas::" in key and not any(name in key for name in counted):
            raise AssertionError(f"{label}: port kernel no wrapper counted: {key[:90]}")
    out = {}
    for name, n in launched.items():
        hits = [r for r in rows if name in r[0]]
        records = sum(r[2] for r in hits)
        if not 0 < records <= n:
            raise AssertionError(f"{label}: {records} {name} kernel records for {n} counted "
                                 f"launches")
        if records < n:
            log(f"  the profiler dropped {n - records} of {n} {name} records; its ms/call "
                f"is the mean record times the counted launches")
        out[name] = (sum(r[1] for r in hits) / records * n / calls, n / calls)
    return out


def host_us(fn, reps: int = 2000) -> float:
    """Host microseconds per call of `fn`, called back to back (the card
    keeps up with a short kernel): what a call costs before its launch."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn()
        if i % 200 == 199:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def phase_main_trsv() -> list[dict]:
    """The TRSV part of the main path (bench.py's TRSV at 16384), checked,
    then timed: the whole calls, each kernel alone, the plain versions and
    torch.linalg.solve_triangular."""
    from accblas_tpu_torch import acc_trsm, acc_trsv, trsv
    from accblas_tpu_torch.ops import tri_gemv as trigops
    from accblas_tpu_torch.ops import trsv as trsvops
    from accblas_tpu_torch.utils import devgen
    from accblas_tpu_torch.utils.bench import benchmark_function

    dev = torch.device("cuda", 0)
    n = N_TRSV
    # unit upper: the off-diagonals scaled by 1/n keep the substitution
    # bounded (bench.py's operand)
    a = devgen.gen_f32((n, n), SEED, "trsv_a", dev).mul_(1.0 / n)
    b = torch.ones(n, device=dev)
    torch.cuda.synchronize()

    # ---- the main path, through the public API ----
    trsvops.leaf_diag_launches = 0
    trsvops.sweep_launches = 0
    trigops.launches = 0
    x32 = trsv(a, b, "upper", True)
    xdf = acc_trsv(a, b, "upper", True, ar="df64")
    res = trigops.tri_gemv_df64(a, x32, b, "upper", True)
    torch.cuda.synchronize()
    launches = {"trsv_leaf_diag": trsvops.leaf_diag_launches,
                "trsv_sweep": trsvops.sweep_launches, "tri_gemv": trigops.launches}
    log(f"main path launches: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"TRSV main path did not launch every kernel: {launches}")

    # ---- its results against float64 and the plain versions, on the card ----
    ref = _solve64(a, b, "upper", True)
    max_abs = {}
    for label, got, ar, tol in (("trsv fixed f32", x32, "f32", 1e-4),
                                ("acc_trsv Acc<df64,f32>", xdf, "df64", 5e-6)):
        plain = trsv_plain(a, b, "upper", True, ar, got.dtype)
        k_err, p_err, kp = _rel1(got, ref), _rel1(plain, ref), _rel1(got, plain)
        max_abs["trsv_sweep"] = max(max_abs.get("trsv_sweep", 0.0),
                                    float((got - plain).abs().max()))
        log(f"main {label} n={n} upper unit: shape={tuple(got.shape)} kernel_err={k_err:.3e} "
            f"plain_err={p_err:.3e} kernel_vs_plain={kp:.3e} bound={tol:.1e}")
        if not (got.shape == b.shape and got.dtype == torch.float32
                and bool(torch.isfinite(got).all()) and max(k_err, p_err) < tol
                and kp < 2 * tol):
            raise AssertionError(f"main-path {label} out of bounds")
        del plain
    del ref
    tx = _tri64(a, "upper", True) @ x32.double()
    rref, den = b.double() - tx, float(tx.abs().sum())
    rplain = trigops._tri_gemv_plain(a, x32, b, False, True)
    r_err = float((res.double() - rref).abs().sum()) / den
    rp_err = float((rplain.double() - rref).abs().sum()) / den
    max_abs["tri_gemv"] = float((res - rplain).abs().max())
    log(f"main tri_gemv_df64 residual of the f32 solve: |r|_1={float(res.abs().sum()):.6e} "
        f"kernel_err={r_err:.3e} plain_err={rp_err:.3e} bound=1.0e-06 (of |T x|_1)")
    if not (bool(torch.isfinite(res).all()) and max(r_err, rp_err) < 1e-6):
        raise AssertionError("main-path tri_gemv_df64 out of bounds")
    del tx, rref, rplain
    m = n // trsvops.LEAF
    d_k = trsvops._extract_leaf_diag(a, m, False, True)
    d_p = trsvops._extract_leaf_diag_plain(a, m, False, True)
    max_abs["trsv_leaf_diag"] = float((d_k - d_p).abs().max())
    if not torch.equal(d_k, d_p):
        raise AssertionError("main-path leaf gather differs from its plain version")

    # ---- timings: kernel, plain, plain, kernel ----
    def best(fk, fp):
        k1, p1, p2, k2 = (benchmark_function(f) for f in (fk, fp, fp, fk))
        return min(k1, k2), min(p1, p2)

    times = {}
    times["trsv"] = best(lambda: trsv(a, b, "upper", True),
                         lambda: trsv_plain(a, b, "upper", True, "f32", torch.float32))
    times["acc_trsv_df64"] = best(
        lambda: acc_trsv(a, b, "upper", True, ar="df64"),
        lambda: trsv_plain(a, b, "upper", True, "df64", torch.float32))
    times["leaf_diag"] = best(lambda: trsvops._extract_leaf_diag(a, m, False, True),
                              lambda: trsvops._extract_leaf_diag_plain(a, m, False, True))
    inv = trsvops._leaf_inverses(d_k, False)
    bt = trsvops._rhs_panels(b.reshape(n, 1), n // trsvops.BLOCK)
    for ar in ("f32", "df64"):
        times[f"sweep_{ar}"] = best(
            lambda: trsvops._trsv_sweep(a, inv, bt, False, ar, torch.float32),
            lambda: trsvops._trsv_sweep_plain(a, inv, bt, False, ar, torch.float32))
    times["inversion"] = (benchmark_function(lambda: trsvops._leaf_inverses(d_k, False)), None)
    times["phase1"] = (benchmark_function(
        lambda: trsvops._leaf_inverses(trsvops._extract_leaf_diag(a, m, False, True), False)),
        None)
    times["tri_gemv"] = best(lambda: trigops.tri_gemv_df64(a, x32, b, "upper", True),
                             lambda: trigops._tri_gemv_plain(a, x32, b, False, True))
    # the one PyTorch call computing the same function: the yardsticks only
    with trsvops.ieee_f32():
        lib_solve = benchmark_function(
            lambda: torch.linalg.solve_triangular(a, b.reshape(n, 1), upper=True,
                                                  unitriangular=True))
    # TRSM: each panel of 4 right-hand sides is a chain of its own, and the
    # panels of k = 64 hold 16x the CTAs the card holds at once
    for k in (8, 64):
        bk = devgen.gen_f32((n, k), SEED, "trsv_b", dev)
        xk = acc_trsm(a, bk, "upper", True, ar="f32")
        err = _rel1(xk, _solve64(a, bk, "upper", True))
        log(f"main acc_trsm Acc<f32,f32> n={n} k={k} upper unit: err={err:.3e} bound=1.0e-04")
        if not (bool(torch.isfinite(xk).all()) and err < 1e-4):
            raise AssertionError(f"acc_trsm k={k} out of bounds")
        trsm_ms = benchmark_function(lambda: acc_trsm(a, bk, "upper", True, ar="f32"))
        with trsvops.ieee_f32():
            trsm_lib = benchmark_function(
                lambda: torch.linalg.solve_triangular(a, bk, upper=True, unitriangular=True))
        log(f"time acc_trsm f32 n={n} k={k}: kernel {trsm_ms:.4f} ms | "
            f"torch.linalg.solve_triangular {trsm_lib:.4f} ms")
        del bk, xk
    # the diagonal tiles as a strided view: clone() copies them (the yardstick);
    # float() of f32 storage returns the view itself, no kernel, so its time
    # is the floor of a call timed with CUDA events
    tiles = (m, trsvops.LEAF, trsvops.LEAF), (trsvops.LEAF * (n + 1), n, 1)
    lib_gather = benchmark_function(lambda: a.as_strided(*tiles).clone())
    event_floor = benchmark_function(lambda: a.as_strided(*tiles).float())

    tri = n * (n + 1) // 2
    leaf = trsvops.LEAF
    # the triangle outside the diagonal leaves (n is a multiple of LEAF)
    off = m * (m - 1) // 2 * leaf**2
    inv_bytes = m * leaf**2 * 4
    bounds = {
        # the off-diagonal triangle, the leaf inverses, b and x; 2 flops per
        # element and per inverse entry
        "trsv_sweep": bound(off * 4 + inv_bytes + 2 * n * 4, 2 * off + 2 * n * leaf),
        # the strict upper triangle of each tile read (unit), each tile
        # written as f32
        "trsv_leaf_diag": bound(m * (leaf * (leaf - 1) // 2 + leaf**2) * 4, 0),
        # the triangle, x, b and r; a product, a two_sum (6 ops), an add
        "tri_gemv": bound(tri * 4 + 3 * n * 4, 8 * tri),
    }
    df_bound = bound(off * 4 + inv_bytes + 2 * n * 4, 10 * off + 10 * n * leaf)

    # where the device time of a call goes; the sweep is one launch per call
    device_ms = {}
    trsv_counted = {"trsv_sweep": lambda: trsvops.sweep_launches,
                    "leaf_diag": lambda: trsvops.leaf_diag_launches}
    for label, fn, ar in ((f"trsv f32 n={n}", lambda: trsv(a, b, "upper", True), "f32"),
                          (f"acc_trsv df64 n={n}",
                           lambda: acc_trsv(a, b, "upper", True, ar="df64"), "df64")):
        prof = profile_calls(label, fn, trsv_counted)
        (sweep_ms, sweep_n), (gather_ms, gather_n) = prof["trsv_sweep"], prof["leaf_diag"]
        log(f"  per call: {sweep_n:g} trsv_sweep launch(es) {sweep_ms:.4f} ms, {gather_n:g} "
            f"leaf_diag launch(es) {gather_ms:.4f} ms")
        if sweep_n != 1:
            raise AssertionError(f"{label}: {sweep_n} sweep launches per call, not 1")
        if ar == "f32":
            device_ms["trsv_sweep"], device_ms["trsv_leaf_diag"] = sweep_ms, gather_ms
        else:
            device_ms["trsv_sweep_df64"] = sweep_ms
    device_ms["tri_gemv"] = profile_calls(
        f"tri_gemv_df64 n={n}", lambda: trigops.tri_gemv_df64(a, x32, b, "upper", True),
        {"tri_gemv": lambda: trigops.launches})["tri_gemv"][0]
    for label, (ms, pms) in times.items():
        log(f"time {label} n={n}: kernel {ms:.4f} ms"
            + ("" if pms is None else f" | plain {pms:.4f} ms"))
    log(f"time library torch.linalg.solve_triangular f32 n={n}: {lib_solve:.4f} ms | "
        f"strided-copy leaf gather (clone): {lib_gather:.4f} ms | strided view .float(), "
        f"no kernel: {event_floor:.4f} ms")
    log(f"bounds: sweep f32 {bounds['trsv_sweep'][0]:.4f} ms ({bounds['trsv_sweep'][1]}), "
        f"sweep df64 {df_bound[0]:.4f} ms ({df_bound[1]}), leaf gather "
        f"{bounds['trsv_leaf_diag'][0]:.4f} ms, tri_gemv {bounds['tri_gemv'][0]:.4f} ms")
    gather_us = host_us(lambda: trsvops._extract_leaf_diag(a, m, False, True))
    empty_us = host_us(lambda: torch.empty(m, trsvops.LEAF, trsvops.LEAF, device=dev))
    clone_us = host_us(lambda: a.as_strided(*tiles).clone())
    log(f"host us per call: leaf gather {gather_us:.2f}, of which torch.empty of the tiles "
        f"{empty_us:.2f}; strided copy (clone) {clone_us:.2f}")
    log("device ms per call (torch.profiler): " + ", ".join(f"{k} {v:.4f}"
                                                            for k, v in device_ms.items()))

    def entry(name, source, replaces, ms, pms, lib):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": max_abs[name], "ms": ms,
                "plain_ms": pms, "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "library_ms": lib, "device_ms": device_ms[name]}

    return [
        entry("trsv_leaf_diag", "accblas_tpu_torch/csrc/trsv.cu", "accblas_tpu/ops/trsv.py:119",
              *times["leaf_diag"], lib_gather),
        # the fixed f32 tier of the main path; the df64 tier's times are logged
        entry("trsv_sweep", "accblas_tpu_torch/csrc/trsv.cu", "accblas_tpu/ops/trsv.py:244",
              *times["sweep_f32"], lib_solve),
        entry("tri_gemv", "accblas_tpu_torch/csrc/tri_gemv.cu",
              "accblas_tpu/ops/tri_gemv.py:27", *times["tri_gemv"], None),
    ]


def _run(name: str, phase):
    """Run a phase; a CUDA fault fails the run with a message naming it."""
    try:
        return phase()
    except RuntimeError as e:
        if "CUDA" not in str(e) and "launch failure" not in str(e):
            raise
        sweep = (" This phase runs the TRSV sweep, whose bounded spin-wait traps when a wait "
                 "runs out (an 'accblas trsv_sweep' line above names it)."
                 if "trsv" in name else "")
        raise SystemExit(f"chip_smoke: CUDA fault in phase {name}: {e}.{sweep}") from e


def main() -> int:
    phase_device()
    phase_build()
    _run("dot/gemv checks", phase_checks)
    _run("trsv checks", phase_trsv_checks)
    kernels = _run("dot/gemv main path", phase_main)
    kernels += _run("trsv main path", phase_main_trsv)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
