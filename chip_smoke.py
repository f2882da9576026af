#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (accblas_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the kernels of accblas_tpu_torch/csrc with nvcc, and
     prints ptxas' registers and spills of the GEMV kernel's instantiations
     and of the draw and column-sum kernels';
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
  4. main path at full size through the public API, on bench.py's exact
     operands drawn on the card by the draw kernel (JAX's threefry bits):
     acc_dot Acc<f32, bf16> at n = 2^29 (gen_f32 dot_x, dot_y as bf16),
     acc_gemv Acc<f32, bf16> at 16384^2 (beta = 0; gemv_a, gemv_x,
     gemv_res), and the flagship 1024x2048 GEMV (alpha = beta = 1) from
     seeded host data; then trsv fixed f32 and acc_trsv Acc<df64, f32> at
     n = 16384 (upper, unit, A = uniform(key(0), (n, n), -1, 1)/n, b = ones,
     as bench.py) and the df64 residual of the f32 solution
     (tri_gemv_df64); each checked against float64, with the launch counters
     reset just before the draws and read just after each path; the TRSV
     calls are profiled (torch.profiler), and the sweep must be one kernel
     launch per call; then the draw kernel on the 2^29 DOT draw: its bits
     against the numpy replay (first, last and every 512th 2^20 elements)
     and the native replay (all of them), each mode against its plain torch
     version on 2^24 elements past counter 2^32, and its time beside its
     plain version and its byte and integer-operation bounds;
  5. timing of each kernel, of its plain version and of the one PyTorch call
     that computes the same function, where there is one, at the main-path
     shapes (1 warm-up, 10 reps, minimum, CUDA events), beside the least time
     the card could take (bytes over 3.35 TB/s or f32 flops over 67 TFLOP/s);
     for GEMV (Acc<f32,bf16>, fixed f32 and Acc<df64,bf16> at 16384^2, and
     the flagship) where a call's time goes, beside torch.mv: device time
     from torch.profiler, and host microseconds of the call, of torch.mv, of
     torch.empty, of the bare ctypes call and of the checks alone; and
     acc_trsm at n = 16384 with k = 8 and 64 right-hand sides, checked
     against float64 and timed beside torch.linalg.solve_triangular;
  generic: the three kernels of csrc/generic.cu, each written once against
     the device Range, at f32/f32, bf16 storage with f32 arithmetic and
     f32 storage with df64 arithmetic, on operands drawn by the draw
     kernel: generic_axpy over a (16384, 32768) range, generic_gemv at
     16384^2 and at 16383 x 16385, window_sum over the (8192, 16384) window
     at (4096, 8192) of a (16384, 32768) parent; each against its plain
     version on the same inputs (bit for bit) and against float64 on the
     stored values (AXPY and the df64 results correctly rounded, the f32
     GEMV and window within the f32 tier's bound), then timed beside its
     bytes bound, its plain version, acc_gemv for the same GEMV and the
     PyTorch call for the same f32 function ("time generic_..." lines);
     the three kernels' counters are reset before the phase and must each
     have launched;
  f8 probe: the port of scripts/probe_r4a.py through its entry point
     (accblas_tpu_torch.bench.probe_r4a.main at N = 24576: GEMV
     Acc<f32,f8e4m3> as acc_gemv (A), two torch forms (B, C) and
     torch._scaled_mm (D), and col_sums (E) at three chunk heights, each
     checked against float64 first); then col_sums (csrc/colsum.cu, the
     TPU probe's Pallas convert stream) against its plain version bit for
     bit and against float64 at 24576^2 (16-byte loads), 1000 x 1003 and
     24576^2 one byte off alignment (element loads), timed beside its bytes
     bound, its plain version and a8.sum(0, dtype=float32) where torch's
     CUDA sum takes f8 ("time col_sums" line), its counter reset before the
     phase and required to have launched; then the other TPU probes'
     counterparts at the probes' own shapes, each checked against its plain
     version and float64 and timed ("time probe" lines): acc_dot
     Acc<f32,f32> at 2^27 and 2^27 + 17 (probe_dot_ragged.py's draws),
     acc_gemv Acc<f32,f8e4m3> at 24576^2 with f32 and f8 x (probe_r4e.py),
     acc_gemv df64 fast and precise at 16384^2 over f32 and bf16
     (probe_gemv_df64.py's draws);
  6. drivers: the benchmark drivers (accblas_tpu_torch.bench) at their
     default sizes through their main(): dot_benchmark (n = 2^27) and
     gemv_benchmark (16384^2) in speed mode and in error mode (DOT over
     the reference's 10 randomizations), trsv_benchmark (n = 16384) in
     speed mode, in error mode on the non-unit triangle, and as TRSM with 8
     right-hand sides;
     and GEMV in error mode once more at 24576^2, the drawn shape of the v5e
     CSV's run; each CSV printed ("csv" lines), each error cell beside its
     v5e cell ("ratio" lines). It fails on a cell that is NaN, a
     speed cell that is not positive, an error cell above its bound (f32
     tiers 1e-5, df64 over f32 5e-7, TRSV over f32 storage 1e-4, the df64
     oracles 1e-12 for DOT and GEMV and 1e-11 for TRSV, narrow storage
     4 x max(the JAX package's error in bench_results/ at that size, 2^-8)),
     a data-set column (Acc<df64,bf16>, Acc<df64,f32> precise) more than
     1e-3 relative from the v5e cell where the drawn shape is the CSV
     run's (DOT at 2^27, GEMV at 24576), an f32-arithmetic column over
     narrow storage more than NARROW_TOL from it there, a draw of gen_f32 that differs in
     any bit from its numpy replay (first and last 2^20 elements of the
     16384^2 draw), or a kernel of the path (DOT, GEMV, the leaf gather,
     the sweep, the draw) that the drivers never launched;
  7. trsm routes: on the LU factor of the TRSV driver's master at n = 4096,
     8192 and 16384, k = 1, 8, 16, 32, 64 and 128 (upper, non-unit), the
     sweep, the blocked composition and xla_trsm side by side for f32
     storage and bf16 storage in the f32 tier and f32 storage in the df64
     tier: each checked against float64 (and the composition against its
     own CPU run), timed (CUDA events), its device records, device ms and
     host ms per call, and the route resident=None takes ("route" lines);
     then every route at n = 1024 on the JAX tests' operand, to their
     bounds;
  8. solvers: the solver driver at its default n = 8192 on the JAX
     driver's system, drawn bit for bit (the CSV printed, every it_per_s
     finite and positive, every resid within 4 x the v5e cell and its ratio
     to it logged, the DOT and GEMV kernels launched), CG through the kernels
     against CG with the plain versions injected at n = 1024, and one CG
     iteration split into event, device and host time ("split cg" lines);
  9. sharded (accblas_tpu_torch.parallel): (a) a 1 x 1 mesh over NCCL in
     this process at the main path's widths (pdot 2^29 and df64 2^27,
     pgemv 16384^2, ptrsv and ptrsm at 16384, pcg at 8192 for 120
     iterations), each op bit for bit equal to its single-card op, the
     DOT, GEMV, leaf gather and sweep kernels launched by the sharded path,
     and the layer's overhead a call and a pcg iteration; (b) 4 ranks
     sharing the card over gloo with host-staged collectives: the port's
     dryrun_multichip, then each op at full width on the 2 x 2 mesh held to
     the JAX tests' bounds and against the single-card op ("sharded 2x2"
     lines); (c) the solver driver's --pcg table over the 4 ranks, each pcg
     resid within 4 x the single-card cg resid.
The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. A CUDA fault fails the run naming the phase;
in a TRSV phase that includes the sweep's bounded spin-wait, which traps
when a wait runs out (accblas_tpu_torch/csrc/trsv.cu).
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_DOT = 2**29
N_GEMV = 16384
N_TRSV = 16384
SEED = 42
# the card's published peaks (H100 SXM data sheet): device memory bytes/s,
# and float32 flop/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# the draw kernel's integer work (csrc/devgen.cu) that only the SM's
# integer ALU pipe (64 lanes an SM a clock) can do: a threefry block's 20
# rotations (SHF), 20 xors and the output words' xor (LOP3); a uniform's
# shift and or. Its ~27 adds a block can issue on the FMA pipe's other 64
# lanes (IMAD) alongside.
DRAW_ALU_OPS_PER_BLOCK = 41
DRAW_ALU_OPS_PER_UNIFORM = 2
INT_LANES_PER_SM = 64
# launches of the draw kernel on the main path (phases 4 and 5)
MAIN_DRAWS = {"launches": 0}


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
    log_ptxas("gemv_rows", _build.build_log("gemv"))
    for lib in ("devgen", "colsum"):
        for line in _build.build_log(lib).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {lib}: {line.strip()}")


def log_ptxas(kernel: str, text: str):
    """Registers and spill bytes of each instantiation of `kernel`, from the
    ptxas -v lines of its library's build log: a line per tier, and one per
    main-path instantiation (GEMV's A and x storage, tier)."""
    found, name = {}, None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                found[name] = [0, 0]
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            found[name][1] = int(m.group(1)) + int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            found[name][0] = int(m.group(1))
    if not found:
        raise AssertionError(f"no ptxas report of {kernel} in the build log")
    names = subprocess.run(["c++filt"], input="\n".join(found), capture_output=True, text=True,
                           check=True).stdout.split("\n")
    by_tier = {}
    for pretty, (regs, spill) in zip(names, found.values()):
        tier = int(re.search(r", (\d)>\(", pretty).group(1))
        by_tier.setdefault(tier, []).append((regs, spill))
        if any(f"{kernel}<{st}, {st}, {t}>" in pretty
               for st, t in (("__nv_bfloat16", 0), ("float", 0), ("__nv_bfloat16", 3))):
            log(f"ptxas {pretty[pretty.index(kernel):pretty.index('>(') + 1]}: {regs} registers, "
                f"{spill} spill bytes")
    from accblas_tpu_torch.ops import _build

    tier_names = {code: name for name, code in _build.TIER_CODE.items()}
    for tier, rs in sorted(by_tier.items()):
        log(f"ptxas {kernel} tier {tier_names[tier]}: {len(rs)} instantiations, registers "
            f"{min(r for r, _ in rs)}-{max(r for r, _ in rs)}, spill bytes at most "
            f"{max(s for _, s in rs)}")


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
    a = devgen.gen_f32((n, n), SEED, "trsv_a", device=dev).mul_(1.0 / n)
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
            bm = devgen.gen_f32((n, k), SEED, "trsv_b", device=dev)
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
            _repeat_check(chk, lu, b, devgen.gen_f32((n, 3), SEED, "trsv_b", device=dev))
        x = devgen.gen_f32((n,), SEED, "gemv_x", device=dev)
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
        x = devgen.gen_f32((n,), SEED, "dot_x", device=dev)
        y = devgen.gen_f32((n,), SEED, "dot_y", device=dev)
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
        a = devgen.gen_f32((m, n), SEED, "gemv_a", device=dev)
        x = devgen.gen_f32((n,), SEED, "gemv_x", device=dev)
        r = devgen.gen_f32((m,), SEED, "gemv_res", device=dev)
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
    from accblas_tpu_torch.ops import draw as drawops
    from accblas_tpu_torch.ops import gemv as gemvops
    from accblas_tpu_torch.utils import MatrixInfo, devgen, gen_mtx, interop, tolerance
    from accblas_tpu_torch.utils.bench import benchmark_function

    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    # ---- the main path, through the public API: bench.py's operands, drawn
    # on the card, then its DOT and GEMV ----
    drawops.launches = 0
    dotops.launches = 0
    gemvops.launches = 0
    xb = devgen.gen_f32((N_DOT,), SEED, "dot_x", device=dev).to(bf)
    yb = devgen.gen_f32((N_DOT,), SEED, "dot_y", device=dev).to(bf)
    ab = devgen.gen_f32((N_GEMV, N_GEMV), SEED, "gemv_a", device=dev).to(bf)
    xg = devgen.gen_f32((N_GEMV,), SEED, "gemv_x", device=dev).to(bf)
    rg = devgen.gen_f32((N_GEMV,), SEED, "gemv_res", device=dev)
    # the flagship op of __graft_entry__.entry(): seeded host masters
    me, ne = 1024, 2048
    ae = interop.from_numpy(gen_mtx(MatrixInfo(me, ne), seed=42).astype("float32"),
                            device=dev).to(bf)
    xe = interop.from_numpy(gen_mtx(MatrixInfo(1, ne), seed=43)[0].astype("float32"),
                            device=dev).to(bf)
    re = interop.from_numpy(gen_mtx(MatrixInfo(1, me), seed=44)[0].astype("float32"),
                            device=dev)
    d = acc_dot(xb, yb, ar="f32")
    g = acc_gemv(ab, xg, rg, 1.0, 0.0, ar="f32")
    e = acc_gemv(ae, xe, re, 1.0, 1.0, ar="f32")
    torch.cuda.synchronize()
    launches = {"dot": dotops.launches, "gemv": gemvops.launches,
                "devgen_draw": drawops.launches}
    MAIN_DRAWS["launches"] += drawops.launches
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
    # the one PyTorch call computing the same function: the yardstick only
    dot_lib_ms = benchmark_function(lambda: torch.dot(xb, yb))
    dot_bytes = N_DOT * (2 + 2)
    dot_bound, dot_by = bound(dot_bytes, 2 * N_DOT)
    # both passes of the DOT count as one launch of its wrapper
    dot_prof, *_ = profile_calls(f"dot Acc<f32,bf16> n={N_DOT}", dot_k,
                                {k: lambda: dotops.launches for k in ("dot_partials",
                                                                      "dot_finish")})
    dot_dev_ms = sum(ms for ms, _ in dot_prof.values())
    log(f"time dot Acc<f32,bf16> n={N_DOT}: kernel {dot_ms:.4f} ms "
        f"{2 * N_DOT / dot_ms / 1e6:.1f} GFLOP/s {dot_bytes / dot_ms / 1e6:.1f} GB/s, device "
        f"{dot_dev_ms:.4f} ms ({dot_bound / dot_dev_ms:.1%} of the bound) | plain "
        f"{dot_plain_ms:.4f} ms | library torch.dot bf16 {dot_lib_ms:.4f} ms | bound "
        f"{dot_bound:.4f} ms")

    # GEMV: the main path's tier and the tiers the TPU served with its
    # full-row kernel at 16384^2, and the flagship; torch.mv computes the
    # f32 tiers' function, and no PyTorch call df64's
    a32, x32 = ab.float(), xg.float()
    gemv_bytes = N_GEMV * N_GEMV * 2 + N_GEMV * 2 + N_GEMV * 4
    gemv = {}
    for key, label, fk, fp, fl, m, n, nbytes in (
        ("main", f"Acc<f32,bf16> {N_GEMV}^2 beta=0", gemv_k, gemv_p,
         lambda: torch.mv(ab, xg), N_GEMV, N_GEMV, gemv_bytes),
        ("f32", f"fixed f32 {N_GEMV}^2 beta=0",
         lambda: gemvops.gemv(a32, x32, rg, 1.0, 0.0),
         lambda: gemvops._gemv_plain(a32, x32, rg, 1.0, 0.0, "f32", False),
         lambda: torch.mv(a32, x32), N_GEMV, N_GEMV, N_GEMV * N_GEMV * 4 + N_GEMV * 8),
        ("df64", f"Acc<df64,bf16> fast {N_GEMV}^2 beta=0",
         lambda: acc_gemv(ab, xg, rg, 1.0, 0.0, ar="df64"),
         lambda: gemvops._gemv_plain(ab, xg, rg, 1.0, 0.0, "df64_fast", False),
         None, N_GEMV, N_GEMV, gemv_bytes),
        ("entry", f"Acc<f32,bf16> entry {me}x{ne}",
         lambda: acc_gemv(ae, xe, re, 1.0, 1.0, ar="f32"),
         lambda: gemvops._gemv_plain(ae, xe, re, 1.0, 1.0, "f32", False),
         lambda: torch.mv(ae, xe), me, ne, me * ne * 2 + ne * 2 + me * 8),
    ):
        bnd, by = bound(nbytes, 2 * m * n)
        sp = gemv_split(label, fk, fp, fl, m, dev)
        log(f"time gemv {label}: kernel {sp['ms']:.4f} ms {nbytes / sp['ms'] / 1e6:.1f} GB/s, "
            f"device {sp['device_ms']:.4f} ms ({bnd / sp['device_ms']:.1%} of the bound) | plain "
            f"{sp['plain_ms']:.4f} ms | bound {bnd:.4f} ms ({by})")
        gemv[key] = dict(sp, bound_ms=bnd, bound_by=by)
    # the fixed f32 tier, which the TPU ran on its full-row kernel: kernel
    # against plain on the same inputs
    max_abs["gemv_fullrow"] = float(
        (gemvops.gemv(a32, x32, rg, 1.0, 0.0)
         - gemvops._gemv_plain(a32, x32, rg, 1.0, 0.0, "f32", False)).abs().max())
    del a32, x32

    return [
        {"name": "dot", "route": "cuda", "source": "accblas_tpu_torch/csrc/dot.cu",
         "replaces": "accblas_tpu/ops/dot.py:136", "launches": launches["dot"],
         "max_abs_err": max_abs["dot"], "ms": dot_ms, "plain_ms": dot_plain_ms,
         "bound_ms": dot_bound, "bound_by": dot_by, "library_ms": dot_lib_ms,
         "device_ms": dot_dev_ms},
        {"name": "gemv", "route": "cuda", "source": "accblas_tpu_torch/csrc/gemv.cu",
         "replaces": "accblas_tpu/ops/gemv.py:147", "launches": launches["gemv"],
         "max_abs_err": max_abs["gemv"], "ms": gemv["main"]["ms"],
         "plain_ms": gemv["main"]["plain_ms"], "bound_ms": gemv["main"]["bound_ms"],
         "bound_by": gemv["main"]["bound_by"], "library_ms": gemv["main"]["library_ms"],
         "device_ms": gemv["main"]["device_ms"]},
        # the same kernel serves the TPU's full-row kernel's tiers (f32 and
        # df64): its fixed-f32 numbers; its launches are the main path's
        {"name": "gemv_fullrow", "route": "cuda", "source": "accblas_tpu_torch/csrc/gemv.cu",
         "replaces": "accblas_tpu/ops/gemv.py:307", "launches": launches["gemv"],
         "max_abs_err": max_abs["gemv_fullrow"], "ms": gemv["f32"]["ms"],
         "plain_ms": gemv["f32"]["plain_ms"], "bound_ms": gemv["f32"]["bound_ms"],
         "bound_by": gemv["f32"]["bound_by"], "library_ms": gemv["f32"]["library_ms"],
         "device_ms": gemv["f32"]["device_ms"]},
    ]


def profile_calls(label: str, fn, counted: dict, calls: int = 5, top: int = 8):
    """Device time by kernel over `calls` calls of `fn` (torch.profiler,
    "Self CUDA"), and the calls' wall time: where a call's time goes.
    `counted` maps a name in a port kernel's symbol to a function reading
    its wrapper's launch counter. The profiler drops a record now and then,
    so a kernel's device ms per call is its mean time per record times the
    launches its wrapper counted per call; a drop is logged. A port kernel
    (namespace accblas) that no counter names, or more records than counted
    launches, fails the run. The `top` costliest records are logged.
    Returns ({name: (device ms, launches) per call}, device busy ms per
    call, device records per call: kernels, memsets and copies, of which
    the profiler may drop a few). A trace with no device record, or none of
    a counted kernel that launched, is taken again (up to 5 times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
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
        per_call = sum(r[2] for r in rows if r[3]) / calls
        missing = [name for name, n in launched.items()
                   if n and not any(name in r[0] for r in rows)]
        if busy > 0 and not missing:
            break
        # the trace came back without one device record, or without any
        # record of a kernel its wrapper launched: profile again
        log(f"profile {label}: no device records"
            + (f" of {', '.join(missing)}" if busy > 0 else "")
            + f" in the trace (attempt {attempt + 1})")
    if top:
        log(f"profile {label}: wall {wall:.4f} ms/call, device busy {busy:.4f} ms/call")
    for key, ms, count, _ in rows[:top]:
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
    return out, busy, per_call


def host_us(fn, reps: int = 2000) -> float:
    """Host microseconds a call of `fn` takes before it returns: the median
    of the calls timed one by one on the host clock. The card is drained
    every 100 calls, outside the timed calls, so no call waits for room in
    the launch queue, however long its kernel runs."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if i % 100 == 99:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return sorted(times)[reps // 2] * 1e6


def paired_ms(fn, reps: int = 7) -> tuple[float, float]:
    """CUDA-event ms and host ms of the same `reps` calls of `fn`, each
    started on a drained queue: (median event ms, median host ms). The host
    ms is the time the call takes to return; the event ms runs from before
    its first launch to the end of its last kernel, so the two agree when
    the call's host work is the longer."""
    fn()
    ev, host = [], []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        host.append((time.perf_counter() - t0) * 1e3)
        e1.synchronize()
        ev.append(e0.elapsed_time(e1))
    return sorted(ev)[reps // 2], sorted(host)[reps // 2]


def _bare_launch(call):
    """Run `call` once, noting the C entry point it launches through
    (`_build.function`) and the arguments it passes: the bare ctypes call,
    its arguments prepared. Returns (fn, args, the call's result), which
    keeps the output the arguments point to alive."""
    from accblas_tpu_torch.ops import _build

    seen = []
    real = _build.function

    def spy(lib, name, argtypes):
        fn = real(lib, name, argtypes)

        def launch(*args):
            seen.append((fn, args))
            return fn(*args)
        return launch

    _build.function = spy
    try:
        out = call()
    finally:
        _build.function = real
    (fn, args), = seen
    torch.cuda.synchronize()
    return fn, args, out


def _checks_only_us(call) -> float:
    """Host us of a GEMV call with its launch (`_gemv_cuda`) stubbed out:
    the public function's checks and dispatch alone."""
    from accblas_tpu_torch.ops import gemv as gemvops

    real = gemvops._gemv_cuda
    gemvops._gemv_cuda = lambda *args: None
    try:
        return host_us(call)
    finally:
        gemvops._gemv_cuda = real


def gemv_split(label: str, call, plain, lib, m: int, dev) -> dict:
    """Where a GEMV call's time goes, for the port's call and, where there
    is one, torch.mv on the same operands: CUDA-event minima of the call, of
    torch.mv and of the plain version, interleaved (call, torch.mv, plain,
    plain, torch.mv, call); device ms per call from torch.profiler
    (gemv_rows, and torch.mv's kernels); host us per call of the call, of
    torch.mv, of torch.empty(m), of the bare ctypes call with its arguments
    prepared, and of the checks alone (the launch stubbed)."""
    from accblas_tpu_torch.ops import gemv as gemvops
    from accblas_tpu_torch.utils.bench import benchmark_function

    order = (call, plain, plain, call) if lib is None else (call, lib, plain, plain, lib, call)
    t = [benchmark_function(f) for f in order]
    ms, plain_ms = min(t[0], t[-1]), min(t[len(t) // 2 - 1], t[len(t) // 2])
    lib_ms = None if lib is None else min(t[1], t[-2])
    prof, *_ = profile_calls(f"gemv {label}", call, {"gemv_rows": lambda: gemvops.launches})
    dev_ms = prof["gemv_rows"][0]
    lib_dev = None if lib is None else profile_calls(f"torch.mv {label}", lib, {})[1]
    fn, args, _out = _bare_launch(call)
    host = {"call": host_us(call),
            "torch.mv": None if lib is None else host_us(lib),
            "torch.empty": host_us(lambda: torch.empty(m, device=dev)),
            "ctypes": host_us(lambda: fn(*args)),
            "checks": _checks_only_us(call)}
    fmt = lambda v: "none" if v is None else f"{v:.4f}"  # noqa: E731
    log(f"split gemv {label}: event ms kernel {ms:.4f} library {fmt(lib_ms)} | device ms "
        f"gemv_rows {dev_ms:.4f} library {fmt(lib_dev)} | host us "
        + ", ".join(f"{k} {fmt(v)}" for k, v in host.items()))
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "device_ms": dev_ms,
            "library_device_ms": lib_dev, "host_us": host}


def _bench_trsv_operand(dev):
    """bench.py's TRSV operand: uniform(key(0), (n, n), -1, 1) / n, unit
    upper (the off-diagonals scaled by 1/n keep the substitution bounded),
    and b = ones."""
    from accblas_tpu_torch.utils import threefry

    a = threefry.uniform(threefry.key(0), (N_TRSV, N_TRSV), -1.0, 1.0, dev).mul_(1.0 / N_TRSV)
    return a, torch.ones(N_TRSV, device=dev)


def phase_main_trsv() -> list[dict]:
    """The TRSV part of the main path (bench.py's TRSV at 16384), checked,
    then timed: the whole calls, each kernel alone, the plain versions and
    torch.linalg.solve_triangular."""
    from accblas_tpu_torch import acc_trsm, acc_trsv, trsv
    from accblas_tpu_torch.ops import draw as drawops
    from accblas_tpu_torch.ops import tri_gemv as trigops
    from accblas_tpu_torch.ops import trsv as trsvops
    from accblas_tpu_torch.utils import devgen
    from accblas_tpu_torch.utils.bench import benchmark_function

    dev = torch.device("cuda", 0)
    n = N_TRSV
    # ---- the main path, through the public API: bench.py's operand drawn
    # on the card, then the solves ----
    drawops.launches = 0
    trsvops.leaf_diag_launches = 0
    trsvops.sweep_launches = 0
    trigops.launches = 0
    a, b = _bench_trsv_operand(dev)
    x32 = trsv(a, b, "upper", True)
    xdf = acc_trsv(a, b, "upper", True, ar="df64")
    res = trigops.tri_gemv_df64(a, x32, b, "upper", True)
    torch.cuda.synchronize()
    launches = {"trsv_leaf_diag": trsvops.leaf_diag_launches,
                "trsv_sweep": trsvops.sweep_launches, "tri_gemv": trigops.launches,
                "devgen_draw": drawops.launches}
    MAIN_DRAWS["launches"] += drawops.launches
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
        bk = devgen.gen_f32((n, k), SEED, "trsv_b", device=dev)
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
        prof, *_ = profile_calls(label, fn, trsv_counted)
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
        {"tri_gemv": lambda: trigops.launches})[0]["tri_gemv"][0]
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


# --------------------------------------------------------------------------
# the generic phase: three kernels written once against the device Range
# --------------------------------------------------------------------------

# (storage, arithmetic): the JAX tests' three pairings
GENERIC_PAIRS = (("f32", "f32"), ("bf16", "f32"), ("f32", "df64"))
GENERIC_SHAPE = (16384, 32768)  # the AXPY range and the window's parent: 2^29 elements
GENERIC_WINDOW = (4096, 8192, 8192, 16384)  # row0, col0, m, n
# f32 operations an element: AXPY x*alpha + y; GEMV a product and an add;
# the window an add. df64 (csrc/df64.cuh, an FMA counted as 2): df_mul_f32
# 8 + df_add 11; df_mul 10 + df_add 11; df_add 11.
GENERIC_FLOPS = {"f32": {"axpy": 2, "gemv": 2, "window": 1},
                 "df64": {"axpy": 19, "gemv": 21, "window": 11}}


def device_ms(label: str, call, counted: dict) -> float:
    """Device ms of one call of `call`: the sum over its counted kernels."""
    prof, *_ = profile_calls(label, call, counted, top=0)
    return sum(ms for ms, _ in prof.values())


def phase_generic() -> list[dict]:
    """generic_axpy, generic_gemv and window_sum (csrc/generic.cu, one body
    each against the device Range) at full width, each at the three
    pairings, on operands drawn by the draw kernel: against the plain
    version on the same inputs and against a float64 result of the stored
    values on the card, then timed beside their bytes bound, the plain
    version, the port's acc_gemv for the same GEMV, and the one PyTorch call
    that computes the same f32 function. The launch counters are reset just
    before the phase's calls and read just after."""
    from accblas_tpu_torch import acc_gemv, gemv
    from accblas_tpu_torch.ops import generic as gen
    from accblas_tpu_torch.utils import devgen, tolerance
    from accblas_tpu_torch.utils.bench import benchmark_function

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    chk = Checks()
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    x32 = devgen.gen_f32(GENERIC_SHAPE, SEED, "generic_x", device=dev)
    y32 = devgen.gen_f32(GENERIC_SHAPE, SEED, "generic_y", device=dev)
    gemv_ops = {}
    for m, n in ((N_GEMV, N_GEMV), (N_GEMV - 1, N_GEMV + 1)):
        gemv_ops[(m, n)] = (devgen.gen_f32((m, n), SEED, "generic_a", device=dev),
                            devgen.gen_f32((n,), SEED, "generic_xv", device=dev),
                            devgen.gen_f32((m,), SEED, "generic_r", device=dev))
    row0, col0, wm, wn = GENERIC_WINDOW
    gen.axpy_launches = gen.gemv_launches = gen.window_launches = 0
    rec = {"axpy": {}, "gemv": {}, "window": {}}
    max_abs = {"axpy": 0.0, "gemv": 0.0, "window": 0.0}

    # kernel against plain: bit for bit at every pairing and shape, ragged
    # and f32 ones too (the same operations in the same order, each rounded
    # on its own on both sides)
    def compare(kind, label, got, plain, err, bound):
        same = torch.equal(got, plain)
        diff = float((got.double() - plain.double()).abs().max())
        max_abs[kind] = max(max_abs[kind], diff)
        chk.record(same, f"generic {label}: kernel vs plain "
                         + ("bit-equal" if same else f"max |diff| {diff:.3e}, not bit-equal"))
        chk.record(math.isfinite(err) and err <= bound,
                   f"generic {label}: error against float64 {err:.3e}, bound {bound:.1e}")

    for st, ar in GENERIC_PAIRS:
        pair = f"{st}/{ar}"
        x, y = x32.to(dt[st]), y32.to(dt[st])
        ebytes = x.element_size()
        flops = GENERIC_FLOPS[ar]

        # ---- AXPY: one rounding an element, so correctly rounded ----
        label = f"axpy {pair} {GENERIC_SHAPE}"
        got = gen.axpy(x, y, ar, "f32")
        torch.cuda.synchronize()
        ref = 2.0 * x.double() + y.double()
        err = float(((got.double() - ref).abs() / ref.abs().clamp_min(1e-300)).max())
        del ref
        compare("axpy", label, got, gen._axpy_plain(x, y, ar, "f32", 2.0), err, 2.0**-24)
        del got
        nel = x.numel()
        bnd, by = bound(nel * (2 * ebytes + 4), flops["axpy"] * nel)
        r = {"ms": benchmark_function(lambda: gen.axpy(x, y, ar, "f32")),
             "plain_ms": benchmark_function(lambda: gen._axpy_plain(x, y, ar, "f32", 2.0),
                                            iters=3),
             "bound_ms": bnd, "bound_by": by, "library_ms": None}
        if pair == "f32/f32":
            r["library_ms"] = benchmark_function(lambda: torch.add(y, x, alpha=2.0))
        r["device_ms"] = device_ms(f"generic_axpy {pair}", lambda: gen.axpy(x, y, ar, "f32"),
                                   {"generic_axpy": lambda: gen.axpy_launches})
        rec["axpy"][pair] = r
        torch.cuda.empty_cache()

        # ---- the window sum, through a strided Range of the parent x ----
        label = f"window_sum {pair} ({wm}, {wn}) at ({row0}, {col0}) of {GENERIC_SHAPE}"
        got = gen.window_sum(x, row0, col0, wm, wn, ar)
        w = x[row0:row0 + wm, col0:col0 + wn]
        w64 = w.double()
        ref, scale = float(w64.sum()), float(w64.abs().sum())
        del w64
        err = abs(float(got) - ref) / scale
        # f32: the tier bound; df64: one rounding of the exact sum to f32
        bd_err = tolerance.TOL["f32"] if ar == "f32" else 2.0**-24 * abs(ref) / scale + 1e-12
        compare("window", label, got, gen._window_sum_plain(x, row0, col0, wm, wn, ar), err,
                bd_err)
        nel = wm * wn
        bnd, by = bound(nel * ebytes + 4, flops["window"] * nel)
        r = {"ms": benchmark_function(lambda: gen.window_sum(x, row0, col0, wm, wn, ar)),
             "plain_ms": benchmark_function(
                 lambda: gen._window_sum_plain(x, row0, col0, wm, wn, ar), iters=3),
             "bound_ms": bnd, "bound_by": by, "library_ms": None}
        if ar == "f32":  # the same sum: storage type in, f32 arithmetic and result
            r["library_ms"] = benchmark_function(lambda: w.sum(dtype=torch.float32))
        # a call launches each of the two kernels once, and counts 2
        r["device_ms"] = device_ms(f"window_sum {pair}",
                                   lambda: gen.window_sum(x, row0, col0, wm, wn, ar),
                                   {k: lambda: gen.window_launches // 2
                                    for k in ("window_sum_blocks", "window_sum_final")})
        rec["window"][pair] = r
        del x, y, w
        torch.cuda.empty_cache()

        # ---- GEMV at 16384^2 and at a ragged 16383 x 16385 ----
        for (m, n), (a32, xv32, rv) in gemv_ops.items():
            a, xv = a32.to(dt[st]), xv32.to(dt[st])
            label = f"gemv {pair} {m}x{n} alpha=1.5 beta=-0.5"
            got = gen.gemv_generic(a, xv, rv, ar, "f32")
            a64, x64 = a.double(), xv.double()
            ref = 1.5 * torch.mv(a64, x64) - 0.5 * rv.double()
            scale = 1.5 * torch.mv(a64.abs(), x64.abs()) + 0.5 * rv.double().abs()
            del a64, x64
            err = tolerance.gemv_row_err(got[:, 0], ref, scale, torch.float32)
            bd_err = tolerance.TOL["f32"] if ar == "f32" else tolerance.TOL["df64_precise"]
            compare("gemv", label, got, gen._gemv_generic_plain(a, xv, rv, ar, "f32", 1.5, -0.5),
                    err, bd_err)
            del ref, scale, got
            if m == n:
                nbytes = m * n * ebytes + n * ebytes + 2 * m * 4
                bnd, by = bound(nbytes, flops["gemv"] * m * n)
                r = {"ms": benchmark_function(lambda: gen.gemv_generic(a, xv, rv, ar, "f32")),
                     "plain_ms": benchmark_function(
                         lambda: gen._gemv_generic_plain(a, xv, rv, ar, "f32", 1.5, -0.5),
                         iters=3),
                     "bound_ms": bnd, "bound_by": by, "library_ms": None}
                # the port's own kernel for the same function, the same alpha, beta
                if pair == "f32/f32":
                    r["acc_gemv_ms"] = benchmark_function(lambda: gemv(a, xv, rv, 1.5, -0.5))
                elif pair == "bf16/f32":
                    r["acc_gemv_ms"] = benchmark_function(
                        lambda: acc_gemv(a, xv, rv, 1.5, -0.5, ar="f32"))
                else:
                    r["acc_gemv_ms"] = benchmark_function(
                        lambda: acc_gemv(a, xv, rv, 1.5, -0.5, ar="df64", precise=True))
                if ar == "f32":  # torch.mv: alpha = 1, beta = 0, a cheaper function
                    r["mv_ms"] = benchmark_function(lambda: torch.mv(a, xv))
                if pair == "f32/f32":  # the same function in one call
                    r["library_ms"] = benchmark_function(
                        lambda: torch.addmv(rv, a, xv, beta=-0.5, alpha=1.5))
                r["device_ms"] = device_ms(f"generic_gemv {pair}",
                                           lambda: gen.gemv_generic(a, xv, rv, ar, "f32"),
                                           {"generic_gemv": lambda: gen.gemv_launches})
                rec["gemv"][pair] = r
            del a, xv
            torch.cuda.empty_cache()
    del gemv_ops, x32, y32
    torch.cuda.synchronize()
    launches = {"generic_axpy": gen.axpy_launches, "generic_gemv": gen.gemv_launches,
                "window_sum": gen.window_launches}
    log(f"generic launches: {launches}")
    chk.record(min(launches.values()) >= 1, f"generic phase launched every kernel: {launches}")
    names = {"axpy": "generic_axpy", "gemv": "generic_gemv", "window": "window_sum"}
    for kind, pairs in rec.items():
        for pair, r in pairs.items():
            extra = "".join(f" | {what} {r[key]:.4f} ms" for key, what in
                            (("acc_gemv_ms", "acc_gemv"), ("mv_ms", "torch.mv"))
                            if key in r)
            lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            log(f"time {names[kind]} {pair}: kernel {r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%}"
                f" of the bound), device {r['device_ms']:.4f} ms | plain {r['plain_ms']:.4f} ms"
                f"{extra} | library {lib} | bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"generic phase: {time.perf_counter() - t_phase:.1f} s")
    chk.raise_failures()
    replaces = {"axpy": "tests/test_generic_kernel.py:21", "gemv": "tests/test_generic_kernel.py:68",
                "window": "tests/test_accessor.py:165"}
    return [{"name": names[kind], "route": "cuda", "source": "accblas_tpu_torch/csrc/generic.cu",
             "replaces": replaces[kind], "launches": launches[names[kind]],
             "max_abs_err": max_abs[kind], **rec[kind]["f32/f32"], "pairings": rec[kind]}
            for kind in ("axpy", "gemv", "window")]


# --------------------------------------------------------------------------
# the f8 probe: scripts/probe_r4a.py's port, its column-sum kernel, and the
# other TPU probes' counterparts at their own shapes
# --------------------------------------------------------------------------

N_PROBE = 24576  # scripts/probe_r4a.py:32
PROBE_DOT_NS = (2**27, 2**27 + 17)  # scripts/probe_dot_ragged.py:81
N_PROBE_DF64 = 16384  # scripts/probe_gemv_df64.py:29
# f32 operations an element of the df64 GEMV (csrc/gemv.cu, an FMA counted
# as 2): fast, a product and a Kahan step (4 adds); precise, two_prod (3),
# two_sum (6) and the low word's 2 adds
PROBE_DF64_FLOPS = {False: 5, True: 11}


def _probe_time(label: str, call, plain, lib, nbytes: int, flops: float, counted: dict,
                beside=None) -> dict:
    """A kernel's time at a probe's shape: the call and the one PyTorch call
    `lib` = (name, fn) in turns (call, lib, lib, call), the plain version and
    the device ms (torch.profiler), beside its bound; `beside` = (name, fn)
    is another call timed for reference."""
    from accblas_tpu_torch.utils.bench import benchmark_function

    order = (call, lib[1], lib[1], call) if lib else (call, call)
    t = [benchmark_function(f) for f in order]
    r = {"ms": min(t[0], t[-1]), "library_ms": min(t[1], t[2]) if lib else None,
         "plain_ms": benchmark_function(plain, iters=3),
         "device_ms": device_ms(f"probe {label}", call, counted)}
    r["bound_ms"], r["bound_by"] = bound(nbytes, flops)
    r["text"] = (f"kernel {r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%} of the bound), device "
                 f"{r['device_ms']:.4f} ms | plain {r['plain_ms']:.4f} ms | library "
                 + (f"{lib[0]} {r['library_ms']:.4f} ms" if lib else "none"))
    if beside:
        r["beside_ms"] = benchmark_function(beside[1])
        r["text"] += f" | beside: {beside[0]} {r['beside_ms']:.4f} ms"
    r["text"] += f" | bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
    return r


def _library_or_none(name: str, fn):
    """(name, fn) if one call of fn runs, else None, logging torch's error."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        log(f"library {name}: none ({type(e).__name__}: {str(e).splitlines()[0][:160]})")
        return None
    return name, fn


def _colsum_case(chk: Checks, label: str, a, vec: bool) -> float:
    """col_sums on `a` against its plain version (bit for bit) and against
    float64 (the (d + 1) 2^-24 bound); returns the largest |kernel - plain|."""
    from accblas_tpu_torch.bench.probe_r4a import colsum_bound, colsum_err
    from accblas_tpu_torch.ops import colsum

    got = colsum.col_sums(a)
    plain = colsum._col_sums_plain(a)
    same = torch.equal(got, plain)
    diff = float((got.double() - plain.double()).abs().max())
    path = "16-byte loads" if vec else "element loads"
    chk.record(colsum.vector_path(a) == vec, f"col_sums {label}: takes the {path}")
    chk.record(same, f"col_sums {label} ({path}): kernel vs plain "
                     + ("bit-equal" if same else f"max |diff| {diff:.3e}, not bit-equal"))
    a64 = a.double()
    err = colsum_err(got, a64.sum(0), a64.abs().sum(0))
    del a64
    bnd = colsum_bound(a.shape[0], colsum.ROWS_PER_BLOCK)
    chk.record(math.isfinite(err) and err <= bnd,
               f"col_sums {label}: error against float64 {err:.3e}, bound {bnd:.3e}")
    return diff


def phase_f8_probe() -> tuple[dict, dict]:
    """scripts/probe_r4a.py's port at N = 24576 through its main(), then
    col_sums (csrc/colsum.cu) against its plain version and float64 at
    24576^2, ragged and misaligned, and timed beside its bound, its plain
    version and the one PyTorch call; then the other TPU probes'
    counterparts at their shapes (acc_dot at 2^27 and 2^27 + 17, acc_gemv
    Acc<f32,f8e4m3> at 24576^2, acc_gemv df64 at 16384^2), each checked and
    timed. The col_sums counter is reset just before the phase and read just
    after its col_sums calls. Returns the col_sums record and the probe rows
    by kernel record name."""
    from accblas_tpu_torch import acc_dot, acc_gemv
    from accblas_tpu_torch.bench import probe_r4a
    from accblas_tpu_torch.ops import colsum
    from accblas_tpu_torch.ops import dot as dotops
    from accblas_tpu_torch.ops import gemv as gemvops
    from accblas_tpu_torch.utils import devgen, threefry
    from accblas_tpu_torch.utils.bench import benchmark_function

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    chk = Checks()
    colsum.launches = 0
    # ---- (a) the probe, through its entry point ----
    probe = probe_r4a.main(["--n", str(N_PROBE)])

    # ---- (b) the kernel against its plain version and float64 ----
    a8, x8, r = probe_r4a.operands(N_PROBE, dev)
    f8 = probe_r4a.F8
    max_abs = _colsum_case(chk, f"f8e4m3 {N_PROBE}x{N_PROBE}", a8, vec=True)
    ragged = devgen.gen_f32((1000, 1003), SEED, "p4a_ragged", device=dev).to(f8)
    max_abs = max(max_abs, _colsum_case(chk, "f8e4m3 1000x1003", ragged, vec=False))
    flat = devgen.gen_f32((N_PROBE * N_PROBE + 16,), SEED, "p4a_a", device=dev).to(f8)
    skew = flat[1:1 + N_PROBE * N_PROBE].view(N_PROBE, N_PROBE)
    max_abs = max(max_abs, _colsum_case(chk, f"f8e4m3 {N_PROBE}x{N_PROBE} one byte off", skew,
                                        vec=False))
    torch.cuda.synchronize()

    # ---- (c) its time beside its bound, its plain version, the library ----
    lib = _library_or_none("a8.sum(0, dtype=torch.float32)",
                           lambda: a8.sum(0, dtype=torch.float32))
    per_call = {k: lambda: colsum.launches // 2 for k in ("colsum_partial", "colsum_fold")}
    rec = _probe_time(f"col_sums f8e4m3 {N_PROBE}x{N_PROBE}", lambda: colsum.col_sums(a8),
                      lambda: colsum._col_sums_plain(a8), lib,
                      N_PROBE * N_PROBE + 4 * N_PROBE, N_PROBE * N_PROBE, per_call)
    rec["element_loads_ms"] = benchmark_function(lambda: colsum.col_sums(skew))
    a_ms = probe["A"]["ms"]
    log(f"time col_sums f8e4m3 {N_PROBE}x{N_PROBE}, launches 2 a call: {rec.pop('text')} | "
        f"element loads (one byte off) {rec['element_loads_ms']:.4f} ms | acc_gemv (A) "
        f"{a_ms:.4f} ms ({rec['bound_ms'] / a_ms:.1%} of the same bound)")
    del flat, skew, ragged
    torch.cuda.synchronize()
    launches = colsum.launches
    log(f"f8 probe col_sums launches: {launches}")
    chk.record(launches >= 1, f"f8 probe phase launched col_sums: {launches}")

    # ---- the other probes' counterparts, at their own shapes ----
    rows = {"dot": {}, "gemv": {}, "gemv_fullrow": {}}
    before = {"dot": dotops.launches, "gemv": gemvops.launches}
    dot_counted = {k: lambda: dotops.launches for k in ("dot_partials", "dot_finish")}
    gemv_counted = {"gemv_rows": lambda: gemvops.launches}
    kx, ky = threefry.split(threefry.key(0))  # scripts/probe_dot_ragged.py:82-84
    for n in PROBE_DOT_NS:
        x = threefry.uniform(kx, (n,), -1.0, 1.0, dev)
        y = threefry.uniform(ky, (n,), -1.0, 1.0, dev)
        _dot_case(chk, "probe_dot_ragged Acc<f32,f32>", x, y, "f32")
        rows["dot"][f"acc_dot Acc<f32,f32> n={n}"] = _probe_time(
            f"acc_dot Acc<f32,f32> n={n}", lambda: acc_dot(x, y, "f32"),
            lambda: dotops._dot_plain(x, y, "f32", 0.0), ("torch.dot", lambda: torch.dot(x, y)),
            8 * n + 4, 2 * n, dot_counted)
        del x, y
    # scripts/probe_r4e.py:221-225: f32 x (V1, V3) and f8 x (V2), beta = 0
    x32 = x8.float()
    _gemv_case(chk, "probe_r4e V1/V3 Acc<f32,f8e4m3 A, f32 x>", a8, x32, r, 1.0, 0.0, "f32")
    _gemv_case(chk, "probe_r4e V2 Acc<f32,f8e4m3>", a8, x8, r, 1.0, 0.0, "f32")
    for label, x, lib in (("f32 x", x32, None),
                          ("f8 x", x8, _library_or_none("torch._scaled_mm k=16",
                                                        probe_r4a.scaled_mm_form(a8, x8, 16)))):
        rows["gemv"][f"acc_gemv Acc<f32,f8e4m3> {label} {N_PROBE}^2"] = _probe_time(
            f"acc_gemv Acc<f32,f8e4m3> {label} {N_PROBE}^2",
            lambda: acc_gemv(a8, x, r, 1.0, 0.0, ar="f32"),
            lambda: gemvops._gemv_plain(a8, x, r, 1.0, 0.0, "f32", False), lib,
            N_PROBE * N_PROBE + N_PROBE * x.element_size() + 4 * N_PROBE,
            2 * N_PROBE * N_PROBE, gemv_counted)
    del a8, x8, x32, r
    torch.cuda.empty_cache()
    # scripts/probe_gemv_df64.py:101-108: A and x uniform(-1, 1) under the
    # keys 0 and 1, r = 0, alpha = beta = 1
    nd = N_PROBE_DF64
    a32 = threefry.uniform(threefry.key(0), (nd, nd), -1.0, 1.0, dev)
    xd = threefry.uniform(threefry.key(1), (nd,), -1.0, 1.0, dev)
    r0 = torch.zeros(nd, device=dev)
    for st, st_name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        a, x = a32.to(st), xd.to(st)
        es = a.element_size()
        for precise in (False, True):
            name = f"Acc<df64,{st_name}> {'precise' if precise else 'fast'} {nd}^2"
            _gemv_case(chk, f"probe_gemv_df64 {name}", a, x, r0, 1.0, 1.0, "df64",
                       precise=precise)
            rows["gemv_fullrow"][f"acc_gemv {name}"] = _probe_time(
                f"acc_gemv {name}",
                lambda: acc_gemv(a, x, r0, 1.0, 1.0, ar="df64", precise=precise),
                lambda: gemvops._gemv_plain(a, x, r0, 1.0, 1.0,
                                            "df64_precise" if precise else "df64_fast", False),
                None, nd * nd * es + nd * es + 8 * nd, PROBE_DF64_FLOPS[precise] * nd * nd,
                gemv_counted,
                beside=("torch.mv f32", lambda: torch.mv(a32, xd)) if es == 4 else None)
        del a, x
    del a32, xd
    torch.cuda.synchronize()
    for label, r in ((label, r) for group in rows.values() for label, r in group.items()):
        log(f"time probe {label}: {r.pop('text')}")
    probe_launches = {"dot": dotops.launches - before["dot"],
                      "gemv": gemvops.launches - before["gemv"]}
    log(f"f8 probe phase: the probes' counterparts launched {probe_launches}")
    chk.record(min(probe_launches.values()) >= 1,
               f"the probes' counterparts launched DOT and GEMV: {probe_launches}")
    log(f"f8 probe phase: {time.perf_counter() - t_phase:.1f} s")
    chk.raise_failures()
    record = {"name": "col_sums", "route": "cuda", "source": "accblas_tpu_torch/csrc/colsum.cu",
              "replaces": "scripts/probe_r4a.py:93", "launches": launches,
              "max_abs_err": max_abs, **rec,
              "probe": {k: {f: v for f, v in res.items() if f != "out"}
                        for k, res in probe.items() if res is not None}}
    return record, rows


# --------------------------------------------------------------------------
# phase 6: the benchmark drivers at their default sizes
# --------------------------------------------------------------------------

# (driver, mode, arguments): each module's main() runs in this process
DRIVER_RUNS = (
    ("dot", "speed", ["--sweep", "single"]),
    # the reference's 10 randomizations: a relative DOT error scales with
    # sum|x_i y_i| / |x . y|, and with 2 the median is the mean of two draws,
    # one of which (r = 1, |x . y| = 63.8 against sqrt(n)/3 = 3862) lifts
    # every tier 60-fold
    ("dot", "error", ["--sweep", "single", "--error"]),
    ("gemv", "speed", ["--sweep", "single"]),
    ("gemv", "error", ["--sweep", "single", "--error"]),
    # the drawn shape of the v5e GEMV error CSV's run (its sweep's largest
    # size): the only GEMV row whose operands are the CSV's
    ("gemv", "error", ["--sweep", "single", "--error", "--size", "24576"]),
    ("trsv", "speed", ["--sweep", "single"]),
    # unit-upper on an LU factor is ill-conditioned: error studies take the
    # non-unit triangle, as the JAX package's error campaigns do
    ("trsv", "error", ["--sweep", "single", "--error", "--no-unit"]),
    ("trsv", "speed k=8", ["--sweep", "single", "--nrhs", "8"]),
)
# bounds of the error columns against the fp64 master: f32 storage under
# f32 arithmetic, df64 over f32 storage, TRSV over f32 storage, the oracles;
# a narrow-storage column is held to 4 x max(the JAX package's v5e error at
# the same size, 2^-8), the envelope of utils.tolerance.narrow_bound
F32_BOUND, DF64_BOUND, TRSV_F32_BOUND = 1e-5, 5e-7, 1e-4
ORACLE_BOUND = {"dot": 1e-12, "gemv": 1e-12, "trsv": 1e-11}
# The port draws the JAX package's operands, so where a driver's drawn
# shape is the v5e CSV run's (DOT: any n, a 1-D draw's leading slice is a
# shorter draw; GEMV: only the CSV sweep's largest size, 24576, since
# element (i, j) of an (m, n) draw has counter i·n + j), the data-set
# columns, whose error is the storage rounding's, reproduce the v5e cell:
# each is held to |cell / v5e - 1| <= DATASET_TOL. A different draw moves
# them by 10-30%.
COMPARABLE = {"dot": lambda size: True, "gemv": lambda size: size == 24576}
DATASET_COLS = ("Acc<df64,bf16>", "Acc<df64,f32> precise")
DATASET_TOL = 1e-3
# f32 arithmetic over narrow storage, where the summation order adds to
# the storage error, on the same data: |cell / v5e - 1| <= NARROW_TOL, set
# from the first sound reading on the H100 (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md, Findings), on top of the envelope of _error_bound. DOT at 2^27
# read 2.96e-4 (bf16), 9.37e-4 (f16) and 6.6e-6 (f8e4m3); another draw of
# the same distribution read 0.168, 0.286 and 0.599. GEMV at 24576 read
# 8.3e-7, 3.6e-6 and 3e-8; the 16384^2 draw, other data, 1.9e-3 to 7.1e-3.
NARROW_COLS = ("Acc<f32,bf16>", "Acc<f32,f16>", "Acc<f32,f8e4m3>")
NARROW_TOL = {"dot": 2e-3, "gemv": 1e-4}


def _v5e_row(csv: str, size: int) -> dict:
    """The row at `size` of one of the JAX package's CSVs (bench_results/,
    v5e), keyed by the port's column names."""
    from accblas_tpu_torch.bench.common import DELIM, vendor_name

    with open(Path(__file__).resolve().parent / "bench_results" / csv) as f:
        rows = [ln.strip().split(DELIM) for ln in f if ln.strip()]
    for row in rows[1:]:
        if int(row[0]) == size:
            return {vendor_name(k): float(v) for k, v in zip(rows[0][1:], row[1:])}
    raise AssertionError(f"bench_results/{csv} has no row at {size}")


def _error_bound(driver: str, col: str, jax_row: dict) -> float:
    if "oracle" in col:
        return ORACLE_BOUND[driver]
    if not any(st in col for st in ("bf16", "f16", "f8")):
        if driver == "trsv":
            return TRSV_F32_BOUND
        return DF64_BOUND if "df64" in col else F32_BOUND
    return 4 * max(jax_row[col], 2.0**-8)


def _check_draws(dev) -> list[str]:
    """The drivers' largest 2-D draw against its numpy replay, bit for bit,
    on the first and last 2^20 elements; the df64 split against the host
    master there (phase_draws checks the 2^29 DOT draw)."""
    from accblas_tpu_torch.utils import devgen

    bad = []
    k = 2**20
    shape = (N_GEMV, N_GEMV)
    t = devgen.gen_f32(shape, SEED, "gemv_a", 0, device=dev).view(-1)
    n = t.numel()
    for lo, hi in ((0, k), (n - k, n)):
        want = devgen.replay_f32(shape, SEED, "gemv_a", 0, lo, hi)
        same = np.array_equal(t[lo:hi].cpu().numpy().view(np.uint32), want.view(np.uint32))
        log(f"draw gemv_a {shape} elements [{lo}, {hi}): bits equal to the numpy "
            f"replay={same}")
        if not same:
            bad.append(f"gen_f32 gemv_a [{lo}, {hi}) differs from its numpy replay")
    del t
    xh, xl = devgen.split_df64(None, (k,), SEED, "dot_x", 0, dev)
    m = devgen.master_f64((k,), SEED, "dot_x", 0)
    same = np.array_equal(xh.cpu().numpy(), m.astype(np.float32))
    gap = float(np.max(np.abs(xh.double().cpu().numpy() + xl.double().cpu().numpy() - m)
                       / np.abs(m)))
    log(f"split_df64 dot_x: hi equals fl32(master)={same}, max |hi + lo - master| / |master| "
        f"= {gap:.3e} (bound 2^-45)")
    if not (same and gap < 2.0**-45):
        bad.append("split_df64 does not carry the master")
    return bad


def draw_bound(n: int, blocks: int, out_bytes: int) -> dict:
    """The least time in ms of a draw of `n` elements with `blocks` threefry
    blocks (each one uniform) and `out_bytes` written an element: the bytes
    written over the memory rate, and the integer ALU operations over the
    SMs' 64 integer lanes at the card's top SM clock (nvidia-smi
    clocks.max.sm)."""
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops = n * blocks * (DRAW_ALU_OPS_PER_BLOCK + DRAW_ALU_OPS_PER_UNIFORM)
    tb = n * out_bytes / PEAK_BYTES * 1e3
    to = ops / (sms * INT_LANES_PER_SM * clock) * 1e3
    return {"bytes_ms": tb, "ops_ms": to, "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations", "ops": ops, "clock_hz": clock,
            "sms": sms}


def phase_draws() -> dict:
    """The draw kernel (csrc/devgen.cu) on the main path's largest draw, the
    2^29 elements of bench.py's DOT operand (gen_f32 dot_x): its bits
    against the numpy replay on the first, the last and every 512th 2^20 of
    them, and against the native replay on all of them; each mode against
    its plain torch version on the card over 2^24 elements from a counter
    that carries past 2^32; then its time beside its plain version and its
    two bounds."""
    from accblas_tpu_torch.native import host
    from accblas_tpu_torch.ops import draw as drawops
    from accblas_tpu_torch.utils import devgen, threefry
    from accblas_tpu_torch.utils.bench import benchmark_function

    dev = torch.device("cuda", 0)
    chk = Checks()
    n, k = N_DOT, 2**20
    ka, kb = threefry.split(devgen.key(SEED, "dot_x", 0))
    t0 = time.perf_counter()
    xs = devgen.gen_f32((n,), SEED, "dot_x", 0, device=dev).cpu().numpy()
    for label, lo, hi, step in (("first", 0, k, 1), ("last", n - k, n, 1),
                                ("every 512th", 0, n, n // k)):
        want = drawops.replay_np("f32", ka, kb, lo, hi, step=step)
        chk.record(np.array_equal(xs[lo:hi:step].view(np.uint32), want.view(np.uint32)),
                   f"draw gen_f32 dot_x ({n},), the {label} {k} elements: bits equal to the "
                   f"numpy replay")
    if host.available():
        m = host.master_f64(0, n, ka, kb).astype(np.float32)
        chk.record(np.array_equal(xs.view(np.uint32), m.view(np.uint32)),
                   f"draw gen_f32 dot_x ({n},), all {n} elements: bits equal to fl32 of the "
                   f"native master replay ({host.describe()})")
        del m
    else:
        chk.record(False, f"native master replay unavailable: {host.describe()}")
    del xs
    log(f"draw replays: {time.perf_counter() - t0:.1f} s")

    start, m = 2**32 - 2**23, 2**24
    max_abs = 0.0
    for mode, lo, hi in (("f32", -1.0, 1.0), ("df64", -1.0, 1.0), ("uniform", 0.0, 1.0),
                         ("uniform", threefry.NORMAL_LO, 1.0)):
        got = drawops.draw(mode, ka, kb, (m,), lo, hi, device=dev, start=start)
        plain = drawops._draw_plain(mode, ka, kb, start, start + m, lo, hi, dev)
        pairs = list(zip(got, plain)) if mode == "df64" else [(got, plain)]
        same = all(torch.equal(g.view(torch.int32), p.view(torch.int32)) for g, p in pairs)
        max_abs = max([max_abs] + [float((g - p).abs().max()) for g, p in pairs])
        chk.record(same, f"draw kernel {mode} [{lo:.9g}, {hi:g}) elements [{start}, "
                         f"{start + m}): bits equal to the plain torch version on the card")
        del got, plain
    chk.raise_failures()

    def kernel():
        return drawops.draw("f32", ka, kb, (n,), device=dev)

    def plain():
        for i0 in range(0, n, threefry.CHUNK):
            drawops._draw_plain("f32", ka, kb, i0, i0 + threefry.CHUNK, -1.0, 1.0, dev)

    k1 = benchmark_function(kernel)
    p1 = benchmark_function(plain, iters=3)
    k2 = benchmark_function(kernel)
    ms, plain_ms = min(k1, k2), p1
    torch.cuda.empty_cache()
    bd = draw_bound(n, 2, 4)
    log(f"time devgen_draw gen_f32 n={n}: kernel {ms:.4f} ms, {bd['ops'] / ms / 1e9:.1f} "
        f"int32 ALU Gop/s | plain (torch int64, in {threefry.CHUNK}-element passes) "
        f"{plain_ms:.4f} ms | bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}): operations "
        f"{bd['ops_ms']:.4f} ms ({bd['ops']:.3e} int32 ALU ops over {bd['sms']} SMs x "
        f"{INT_LANES_PER_SM} lanes x {bd['clock_hz'] / 1e6:.0f} MHz), bytes "
        f"{bd['bytes_ms']:.4f} ms ({n * 4} B over {PEAK_BYTES:.3g} B/s); "
        f"{bd['bound_ms'] / ms:.1%} of the bound")
    return {"name": "devgen_draw", "route": "cuda", "source": "accblas_tpu_torch/csrc/devgen.cu",
            "replaces": "accblas_tpu/utils/devgen.py:73", "launches": MAIN_DRAWS["launches"],
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"], "library_ms": None, "bound_bytes_ms": bd["bytes_ms"],
            "bound_ops_ms": bd["ops_ms"]}


def phase_drivers() -> None:
    """The benchmark drivers (accblas_tpu_torch.bench) at their default sizes
    through their main(): each CSV printed, every cell finite, every error
    cell within its bound, and the draws checked against their replay. The
    launch counters are reset just before the drivers and read just after:
    the DOT, GEMV and both TRSV kernels must have run."""
    import contextlib
    import io

    from accblas_tpu_torch.bench import dot_benchmark, gemv_benchmark, trsv_benchmark
    from accblas_tpu_torch.native import host
    from accblas_tpu_torch.ops import dot as dotops
    from accblas_tpu_torch.ops import draw as drawops
    from accblas_tpu_torch.ops import gemv as gemvops
    from accblas_tpu_torch.ops import trsv as trsvops

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    log(f"drivers: host data from {host.describe()}")
    bad = _check_draws(dev)
    modules = {"dot": dot_benchmark, "gemv": gemv_benchmark, "trsv": trsv_benchmark}
    dotops.launches = gemvops.launches = drawops.launches = 0
    trsvops.leaf_diag_launches = trsvops.sweep_launches = 0
    t_phase = time.perf_counter()
    for driver, mode, argv in DRIVER_RUNS:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            modules[driver].main(argv)
        torch.cuda.synchronize()
        lines = out.getvalue().strip().splitlines()
        for line in lines:
            log(f"csv {driver} {mode}: {line}")
        log(f"driver {driver} {mode}: {time.perf_counter() - t0:.1f} s")
        header = lines[0].split(";")
        for row in lines[1:]:
            cells = row.split(";")
            size = int(cells[0])
            jax_row = _v5e_row(f"{driver}_error.csv", size) if mode == "error" else {}
            same_data = mode == "error" and COMPARABLE.get(driver, lambda _: False)(size)
            if mode == "error" and driver in COMPARABLE:
                log(f"v5e {driver} error at {size}: the drawn shape "
                    + ("is the CSV run's: the data-set columns are held to the v5e cells"
                       if same_data else "is not the CSV run's: ratios for reading only"))
            for col, cell in zip(header[1:], cells[1:]):
                v = float(cell)
                if mode != "error":
                    ok, what = math.isfinite(v) and v > 0, "GFLOP/s not finite and positive"
                else:
                    b = _error_bound(driver, col, jax_row)
                    ok, what = v <= b, f"error above {b:.3e}"  # NaN fails too
                    if col in jax_row:
                        ratio = v / jax_row[col]
                        log(f"ratio {driver} {col} at {size}: {v:.10e} / v5e "
                            f"{jax_row[col]:.10e} = {ratio:.8f}")
                        tol = (DATASET_TOL if col.endswith(DATASET_COLS) else
                               NARROW_TOL.get(driver) if col.endswith(NARROW_COLS) else None)
                        if same_data and tol is not None and ok:
                            ok = abs(ratio - 1) <= tol
                            what = f"{ratio:.8f} x the v5e cell, not within {tol:g}"
                if not ok:
                    bad.append(f"{driver} {mode} {col} at {size}: {cell} ({what})")
    launches = {"dot": dotops.launches, "gemv": gemvops.launches,
                "trsv_leaf_diag": trsvops.leaf_diag_launches,
                "trsv_sweep": trsvops.sweep_launches, "devgen_draw": drawops.launches}
    log(f"drivers launches: {launches}; phase {time.perf_counter() - t_phase:.1f} s")
    bad += [f"the drivers never launched {k}" for k, v in launches.items() if v < 1]
    if bad:
        raise AssertionError("drivers phase failed:\n" + "\n".join(bad))


# --------------------------------------------------------------------------
# phase 7: the TRSM routes side by side
# --------------------------------------------------------------------------

ROUTE_NS = (4096, 8192, 16384)
ROUTE_KS = (1, 8, 16, 32, 64, 128)
# the sweep against its plain version (trsv_plain), column by column, at
# this point of the timed routes, in every tier
SWEEP_PLAIN_N, SWEEP_PLAIN_K = 16384, 64
# the composition at n = 1024 on the JAX tests' operand (the packed LU of a
# diagonally dominant matrix), held to their bounds (tests/test_trsv.py):
# f32 arithmetic 5e-5, bf16 storage 1e-3, df64 5e-6
ROUTE_SMALL_N = 1024
SMALL_BOUND = {("f32", "f32"): 5e-5, ("bf16", "f32"): 1e-3, ("f32", "df64"): 5e-6}
# Bounds of the timed routes' errors against the float64 solve of the
# stored triangle (the LU factor of the TRSV driver's master, upper,
# non-unit). The reference solves the stored values, so bf16 storage takes
# the f32 tier's bounds. Each was set from a sound reading at n = 16384 and
# sits below a fault's (NVIDIA H100 80GB HBM3, 700 W; PERF.md, Findings):
# - the sweep, f32 tier: the drivers' 1e-4. It reads 6.05e-5; an earlier
#   f32 order of the kernel (one chain of n/4 adds a lane) read 2.13e-4.
# - the sweep, df64 tier: 2e-5. It reads 5.51e-6; a df64 route computing in
#   f32 reads as the f32 sweep, 6.0e-5.
# - the refined compositions (df64; f32 storage at k < 32, by the JAX
#   refinement gate): 1.5 x the largest reading, 1.13e-4. The f32
#   composition unrefined reads 2.13e-4, and at k = 1 with TF32 products
#   2.33e-4 (scripts/torch_trsm_routes.py).
# - the unrefined f32-tier composition and xla_trsm: max(1e-4, 4 x the v5e
#   TRSM CSV's cell of their column), the repo's envelope for a reference's
#   error (3.4e-4 and 2.2e-4). They read 2.2e-4 and 1.8e-4, the class of
#   512-row block inverses and of cuBLAS's blocked trsm (ROADMAP C); the
#   composition with TF32 products reads 1.0e-1 at k = 64.
# The sweep's plain version (trsv_plain) keeps the JAX kernel's arithmetic,
# whose df64 tier rounds each 512-term block product in f32: it reads
# 5.3e-5 in the f32 tier and 5.2e-5 in df64 (the v5e TRSM CSV's df64 cell
# is 5.6e-5), so it and its gap to the kernel are held to the drivers'
# TRSV bound and twice it, in both tiers.
ROUTE_DF64_BOUND = 2e-5
REFINED_COMPOSITION_BOUND = 1.5 * 1.13e-4
# The composition's card run against its CPU run on the same operand: the
# largest gap read at n = 16384, refined (1.77e-4) and unrefined (3.19e-4,
# on bf16 storage), scaled by n / 16384 (4096 read at most 2.7e-5 and
# 8.4e-5, 8192 6.1e-5 and 1.49e-4), times GAP_MARGIN.
CARD_CPU_GAP = {True: 1.77e-4, False: 3.19e-4}
GAP_MARGIN = 1.5


def _rel1_cols(got, ref) -> float:
    """The largest relative 1-norm gap over the columns of (n, k) results."""
    got, ref = got.double().reshape(got.shape[0], -1), ref.double().reshape(ref.shape[0], -1)
    return float(((got - ref).abs().sum(0) / ref.abs().sum(0)).max())


def trsm_routes(dev, ns=ROUTE_NS, ks=ROUTE_KS, timed: bool = True) -> list[str]:
    """The three routes of a TRSM (upper, non-unit) at each n and k: the
    sweep (resident=False), the blocked composition (resident=True; in df64
    _trsm_small_df64 called directly) and, for f32 storage in the f32 tier,
    xla_trsm; for f32 and bf16 storage in the f32 tier, and f32 storage in
    the df64 tier. Timed, the operand is the LU factor of the TRSV driver's
    fp64 master (its disk cache) and the bounds are those above; at
    SWEEP_PLAIN_N and SWEEP_PLAIN_K the sweep is also held against its
    plain version column by column, within twice the drivers' TRSV bound
    (the plain version's df64 tier errs in the f32 class). A line per
    point gives each route's event ms (the minimum of 10), its device
    records and device ms (torch.profiler), its event and host ms (medians
    of the same calls) and the route resident=None takes. Untimed, the
    operand is the JAX tests' and every route is held to their bounds
    (SMALL_BOUND). The composition is also held against its own run on the
    CPU on the same operand: timed within CARD_CPU_GAP, untimed within
    twice its bound. Returns the failures."""
    import accblas_tpu_torch
    from accblas_tpu_torch.bench import trsv_benchmark
    from accblas_tpu_torch.ops import trsv as trsvops
    from accblas_tpu_torch.utils import devgen
    from accblas_tpu_torch.utils.bench import benchmark_function

    bad = []
    lu64 = trsv_benchmark.lu_cached(max(N_TRSV, *ns), SEED, dev) if timed else None
    sweep_counted = {"trsv_sweep": lambda: trsvops.sweep_launches,
                     "leaf_diag": lambda: trsvops.leaf_diag_launches}
    kmax = max(ks)
    for n in ns:
        if timed:
            a32 = torch.from_numpy(lu64[:n, :n].astype(np.float32)).to(dev)
            jax_trsm = _v5e_row("trsm_error.csv", n)
        else:
            a32 = _packed_lu(n, SEED, dev)[0]
        storages = {"f32": a32, "bf16": a32.to(torch.bfloat16)}
        cpu = {st: a.cpu() for st, a in storages.items()}
        bmax = devgen.gen_f32((n, kmax), SEED, "trsv_b", device=dev)
        refs = {st: _solve64(a, bmax, "upper", False) for st, a in storages.items()}
        for k in ks:
            b = bmax[:, :k].contiguous()
            line = []
            for st, ar in (("f32", "f32"), ("bf16", "f32"), ("f32", "df64")):
                a, ref = storages[st], refs[st][:, :k]
                if timed:
                    refined = ar == "df64" or (st == "f32" and k < 32)
                    bnd = ROUTE_DF64_BOUND if ar == "df64" else TRSV_F32_BOUND
                    blocked = (REFINED_COMPOSITION_BOUND if refined
                               else max(TRSV_F32_BOUND, 4 * jax_trsm["TRSM fp32"]))
                    vendor = max(TRSV_F32_BOUND, 4 * jax_trsm["torch TRSM fp32"])
                    gap_tol = GAP_MARGIN * CARD_CPU_GAP[refined] * n / N_TRSV
                else:
                    bnd = blocked = vendor = SMALL_BOUND[(st, ar)]
                    gap_tol = 2 * blocked
                if ar == "df64":
                    comp = lambda a=a: trsvops._trsm_small_df64(a, b, "upper", False, "f32")
                    comp_cpu = lambda: trsvops._trsm_small_df64(cpu[st], b.cpu(), "upper",
                                                                False, "f32")
                else:
                    comp = lambda a=a: accblas_tpu_torch.acc_trsm(
                        a, b, "upper", False, ar="f32", resident=True, unstable_ok=True)
                    comp_cpu = lambda: trsvops._trsv_small(cpu[st], b.cpu(), "upper", False,
                                                           "f32")
                routes = {"sweep": (lambda a=a, ar=ar: accblas_tpu_torch.acc_trsm(
                    a, b, "upper", False, ar=ar, resident=False, unstable_ok=True), bnd,
                    sweep_counted),
                    "composition": (comp, blocked, {})}
                if st == "f32" and ar == "f32":
                    routes["xla"] = (lambda a=a: accblas_tpu_torch.xla_trsm(a, b, "upper", False),
                                     vendor, {})
                label = f"{st}/{ar}"
                for name, (fn, tol, _) in routes.items():
                    x = fn()
                    err = _rel1(x, ref)
                    ok = bool(torch.isfinite(x).all()) and err < tol
                    msg = f"trsm routes n={n} k={k} {label} {name}: err={err:.3e} bound={tol:.1e}"
                    if name == "composition":
                        gap = _rel1(x.cpu(), comp_cpu())
                        ok = ok and gap < gap_tol
                        msg += f" card_vs_cpu={gap:.3e} bound={gap_tol:.1e}"
                    if name == "sweep" and timed and (n, k) == (SWEEP_PLAIN_N, SWEEP_PLAIN_K):
                        xp = trsv_plain(a, b, "upper", False, ar, x.dtype)
                        p_err, kp = _rel1(xp, ref), _rel1_cols(x, xp)
                        ok = ok and p_err < TRSV_F32_BOUND and kp < 2 * TRSV_F32_BOUND
                        msg += (f" plain_err={p_err:.3e} bound={TRSV_F32_BOUND:.1e} "
                                f"kernel_vs_plain_by_column={kp:.3e} "
                                f"bound={2 * TRSV_F32_BOUND:.1e}")
                    log(("ok   " if ok else "FAIL ") + msg)
                    if not ok:
                        bad.append(msg)
                    del x
                if not timed:
                    continue
                cells = []
                for name, (fn, _, counted) in routes.items():
                    ms = benchmark_function(fn)
                    ev, host = paired_ms(fn)
                    _, dev_ms, records = profile_calls(f"route {label} {name}", fn, counted,
                                                       calls=3, top=0)
                    cells.append(f"{name} {ms:.4f} ms {records:g} records device {dev_ms:.4f} "
                                 f"median event {ev:.4f} host {host:.4f}")
                auto = trsvops._route(n, k, st, ar, "cuda")
                line.append(f"{label}: " + "; ".join(cells) + f"; resident=None: {auto}")
            for entry in line:
                log(f"route n={n} k={k} {entry}")
        del storages, cpu, refs, bmax, a32
        torch.cuda.empty_cache()
    return bad


def phase_trsm_routes() -> None:
    """The routes at the smoke sizes, timed, then the composition at the
    small size, checked only."""
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    bad = trsm_routes(dev)
    bad += trsm_routes(dev, ns=(ROUTE_SMALL_N,), timed=False)
    log(f"trsm routes: {time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError("trsm routes failed:\n" + "\n".join(bad))


# --------------------------------------------------------------------------
# phase 8: the solvers
# --------------------------------------------------------------------------

def cg_split(run, iters_lo: int, iters_hi: int, label: str = "cg") -> dict:
    """One iteration's time of a CG solve `run(iters)`, as the slope between
    `iters_lo` and `iters_hi` iterations: event and host ms (medians of the
    same calls, paired_ms; the loop reads nothing back, so the host ms is
    the time to enqueue), device busy ms and device records
    (torch.profiler)."""
    from accblas_tpu_torch.ops import dot as dotops
    from accblas_tpu_torch.ops import gemv as gemvops

    counted = {"dot_partials": lambda: dotops.launches, "dot_finish": lambda: dotops.launches,
               "gemv_rows": lambda: gemvops.launches}
    out = {}
    for it in (iters_lo, iters_hi):
        fn = lambda it=it: run(it)  # noqa: E731
        ev, host = paired_ms(fn)
        _, dev_ms, records = profile_calls(f"{label} {it} iterations", fn, counted, calls=3,
                                           top=0)
        out[it] = (ev, host, dev_ms, records)
    d = iters_hi - iters_lo
    ev, host, dev_ms, records = ((out[iters_hi][i] - out[iters_lo][i]) / d for i in range(4))
    return {"event_ms": ev, "host_ms": host, "device_ms": dev_ms, "records": records}


def solvers_checks(dev) -> list[str]:
    """For each of the solver driver's four variants, on its system at its
    n and budget: the matvec and a dot of the CG loop through the kernels
    against the plain versions and float64, to the tier bounds (_gemv_case,
    _dot_case: the f32 and df64-fast GEMV, the f32 and df64-precise DOT);
    then CG through the kernels against CG with the plain versions injected
    (matvec=, dot=) on the same tensors, for f32 storage, x within the f32
    tier's bound (the CG state is f32) and the same iteration count. On bf16
    storage CG rounds p to bf16 in every matvec, so two correct summation
    orders flip roundings and their x part by 3.3-4.3e-4 (NVIDIA H100 80GB
    HBM3, 700 W; PERF.md, Findings): that gap is logged, and the variant is
    held through its matvec, its dot and the driver's resid."""
    from accblas_tpu_torch.bench import solvers_benchmark as sb
    from accblas_tpu_torch.models import solvers
    from accblas_tpu_torch.ops import _build
    from accblas_tpu_torch.ops import df64 as dfm
    from accblas_tpu_torch.ops import dot as dotops
    from accblas_tpu_torch.ops import gemv as gemvops
    from accblas_tpu_torch.utils import tolerance

    chk = Checks()
    n, iters = sb.DEFAULT_SIZE, sb.ITERS_HI
    a32, b = sb.spd_system(n, SEED, dev)
    res = torch.empty(n, device=dev)
    tol = tolerance.TOL["f32"]
    for name in sb.NAMES:
        st, ar = name.split()[1].split("/")
        a = a32 if st == "f32" else a32.to(torch.bfloat16)
        _gemv_case(chk, f"{name} matvec", a, b.to(a.dtype), res, 1.0, 0.0, ar)
        _dot_case(chk, f"{name} dot", b, solvers._matvec(a, b, ar), ar, precise=ar == "df64")
        gtier, dtier = _build.tier(ar, False, "gemv"), _build.tier(ar, ar == "df64", "dot")
        xk, _, itk = solvers.cg(a, b, iters=iters, ar=ar)
        xp, _, itp = solvers.cg(
            a, b, iters=iters,
            matvec=lambda p, a=a, gtier=gtier: gemvops._gemv_plain(
                a, p.to(a.dtype), res, 1.0, 0.0, gtier, False),
            dot=lambda u, v, dtier=dtier: dfm.df_to_f32(dfm.DF(*dotops._dot_plain(u, v, dtier,
                                                                                  0.0))))
        gap = float((xk.double() - xp.double()).norm() / xp.double().norm())
        msg = (f"{name} n={n}, {iters} iterations, kernels against the plain versions "
               f"injected: |x_k - x_p| / |x_p| = {gap:.3e}, iterations {int(itk)} and "
               f"{int(itp)}")
        if st == "bf16":
            log(f"info {msg} (not bounded: bf16 rounding of p)")
            continue
        chk.record(gap <= tol and int(itk) == int(itp) == iters, f"{msg} bound={tol:.1e}")
    return chk.failures


def phase_solvers() -> None:
    """The solver driver at its default size (n = 8192, full width: A takes
    256 MiB in f32), its CSV printed; every it_per_s finite and positive,
    every resid within 4 x the v5e cell at the same size
    (bench_results/solvers.csv), the DOT and GEMV kernels launched in the
    driver's run; the kernels against the plain versions at the driver's
    shapes (solvers_checks); one CG iteration split into host and device
    time."""
    import contextlib
    import io

    from accblas_tpu_torch.bench import solvers_benchmark as sb
    from accblas_tpu_torch.ops import dot as dotops
    from accblas_tpu_torch.ops import gemv as gemvops

    dev = torch.device("cuda", 0)
    bad = []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dotops.launches = gemvops.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sb.main(["--sweep", "single"])
    torch.cuda.synchronize()
    launches = {"dot": dotops.launches, "gemv": gemvops.launches}
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        log(f"csv solvers speed: {line}")
    log(f"driver solvers: {time.perf_counter() - t0:.1f} s; launches {launches}")
    bad += [f"the solver driver never launched {k}" for k, v in launches.items() if v < 1]
    header = lines[0].split(";")
    for row in lines[1:]:
        cells = row.split(";")
        size = int(cells[0])
        v5e = _v5e_row("solvers.csv", size)
        for col, cell in zip(header[1:], cells[1:]):
            v = float(cell)
            if col.endswith("it_per_s"):
                ok, what = math.isfinite(v) and v > 0, "not finite and positive"
            else:
                b = 4 * v5e[col]
                ok, what = v <= b, f"above 4 x the v5e cell, {b:.3e}"
                # the JAX driver's system, drawn bit for bit: read beside the v5e cell
                log(f"ratio solvers {col} at {size}: {v:.10e} / v5e {v5e[col]:.10e} = "
                    f"{v / v5e[col]:.8f}")
            if not ok:
                bad.append(f"solvers {col} at {size}: {cell} ({what})")
    bad += solvers_checks(dev)
    from accblas_tpu_torch.models import solvers

    a, b = sb.spd_system(sb.DEFAULT_SIZE, SEED, dev)
    for label, op, ar in (("f32/f32", a, "f32"), ("bf16/df64", a.to(torch.bfloat16), "df64")):
        sp = cg_split(lambda it, op=op, ar=ar: solvers.cg(op, b, iters=it, ar=ar), sb.ITERS_LO,
                      sb.ITERS_HI)
        log(f"split cg {label} n={sb.DEFAULT_SIZE}, one iteration: median event ms "
            f"{sp['event_ms']:.4f} | median host ms {sp['host_ms']:.4f} | device ms "
            f"{sp['device_ms']:.4f} | {sp['records']:g} device records")
    log(f"solvers phase: {time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError("solvers phase failed:\n" + "\n".join(bad))


# --------------------------------------------------------------------------
# phase 9: the sharded layer
# --------------------------------------------------------------------------

SHARDED_RANKS = 4
N_PDOT_DF64 = 2**27
N_PCG, PCG_ITERS = 8192, 120
K_PTRSM = 64


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def _bits_equal(a, b) -> bool:
    """Tensors, or tuples of them (a DF, pcg's result), equal bit for bit."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_bits_equal(u, v) for u, v in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _main_operands(dev):
    """The main path's full-width inputs (phases 4 and 8)."""
    from accblas_tpu_torch.bench import solvers_benchmark as sb
    from accblas_tpu_torch.utils import devgen

    bf = torch.bfloat16
    ops = {
        "xb": devgen.gen_f32((N_DOT,), SEED, "dot_x", device=dev).to(bf),
        "yb": devgen.gen_f32((N_DOT,), SEED, "dot_y", device=dev).to(bf),
        "x27": devgen.gen_f32((N_PDOT_DF64,), SEED, "dot_x", device=dev),
        "y27": devgen.gen_f32((N_PDOT_DF64,), SEED, "dot_y", device=dev),
        "ab": devgen.gen_f32((N_GEMV, N_GEMV), SEED, "gemv_a", device=dev).to(bf),
        "xg": devgen.gen_f32((N_GEMV,), SEED, "gemv_x", device=dev).to(bf),
        "rg": devgen.gen_f32((N_GEMV,), SEED, "gemv_res", device=dev),
        "bm": devgen.gen_f32((N_TRSV, K_PTRSM), SEED, "trsv_b", device=dev),
    }
    ops["at"], ops["bt"] = _bench_trsv_operand(dev)
    ops["acg"], ops["bcg"] = sb.spd_system(N_PCG, SEED, dev)
    return ops


def sharded_one_rank() -> list[str]:
    """(a) a 1 x 1 mesh over NCCL in this process, at the main path's full
    widths: each sharded op against its single-card op bit for bit (a sum
    of one term, and a df_sum of one pair, is the identity), the kernels of
    the path launched, and the layer's overhead per call (CUDA events, 1
    warm-up, 10 reps, minimum) and per pcg iteration (event, host and device
    ms, cg_split)."""
    import tempfile

    from accblas_tpu_torch import acc_dot, acc_gemv, acc_trsm, acc_trsv
    from accblas_tpu_torch.models import solvers
    from accblas_tpu_torch.ops import dot as dotops
    from accblas_tpu_torch.ops import gemv as gemvops
    from accblas_tpu_torch.ops import trsv as trsvops
    from accblas_tpu_torch.parallel import collectives, make_mesh, pcg, pdot, pgemv, ptrsm, ptrsv
    from accblas_tpu_torch.parallel import shard
    from accblas_tpu_torch.utils.bench import benchmark_function

    dev = torch.device("cuda", 0)
    bad = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as store:
        collectives.init(0, 1, store, "nccl")
        try:
            mesh = make_mesh()
            o = _main_operands(dev)
            ab_s, xg_s, rg_s = (shard(o["ab"], mesh, ("rows", "cols")),
                                shard(o["xg"], mesh, ("cols",)), shard(o["rg"], mesh, ("rows",)))
            at_s = shard(o["at"], mesh, ("rows", None), identity_tail=True)
            acg_s, bcg_s = shard(o["acg"], mesh, ("rows", "cols")), shard(o["bcg"], mesh, ("cols",))
            pairs = [
                ("pdot Acc<f32,bf16> n=2^29",
                 lambda: pdot(o["xb"], o["yb"], mesh, ar="f32"),
                 lambda: acc_dot(o["xb"], o["yb"], ar="f32")),
                ("pdot Acc<df64,f32> precise n=2^27",
                 lambda: pdot(o["x27"], o["y27"], mesh, ar="df64", precise=True),
                 lambda: acc_dot(o["x27"], o["y27"], ar="df64", precise=True)),
                (f"pgemv Acc<f32,bf16> {N_GEMV}^2 beta=0",
                 lambda: pgemv(ab_s, xg_s, rg_s, 1.0, 0.0, ar="f32", mesh=mesh),
                 lambda: acc_gemv(o["ab"], o["xg"], o["rg"], 1.0, 0.0, ar="f32")),
                (f"pgemv Acc<df64,bf16> {N_GEMV}^2 beta=0",
                 lambda: pgemv(ab_s, xg_s, rg_s, 1.0, 0.0, ar="df64", mesh=mesh),
                 lambda: acc_gemv(o["ab"], o["xg"], o["rg"], 1.0, 0.0, ar="df64")),
                (f"ptrsv f32 n={N_TRSV} upper unit",
                 lambda: ptrsv(at_s, o["bt"], "upper", True, "f32", mesh=mesh),
                 lambda: acc_trsv(o["at"], o["bt"], "upper", True, ar="f32")),
                (f"ptrsm f32 n={N_TRSV} k={K_PTRSM} upper unit",
                 lambda: ptrsm(o["at"], o["bm"], "upper", True, "f32", mesh=mesh),
                 lambda: acc_trsm(o["at"], o["bm"], "upper", True, ar="f32")),
            ]
            for ar in ("f32", "df64"):
                pairs.append((f"pcg f32/{ar} n={N_PCG} {PCG_ITERS} iterations",
                              lambda ar=ar: pcg(acg_s, bcg_s, mesh=mesh, iters=PCG_ITERS, ar=ar),
                              lambda ar=ar: solvers.cg(o["acg"], o["bcg"], iters=PCG_ITERS,
                                                       ar=ar)))
            torch.cuda.synchronize()

            # ---- the sharded path, its launches counted ----
            dotops.launches = gemvops.launches = 0
            trsvops.leaf_diag_launches = trsvops.sweep_launches = 0
            collectives.counts.clear()
            got = [sharded() for _, sharded, _ in pairs]
            torch.cuda.synchronize()
            launches = {"dot": dotops.launches, "gemv": gemvops.launches,
                        "trsv_leaf_diag": trsvops.leaf_diag_launches,
                        "trsv_sweep": trsvops.sweep_launches}
            log(f"sharded 1x1 nccl launches: {launches}; collectives "
                f"{ {'/'.join(k): v for k, v in sorted(collectives.counts.items())} }")
            bad += [f"the sharded path never launched {k}" for k, v in launches.items() if v < 1]

            # ---- each against its single-card op, bit for bit ----
            for (label, sharded, single), g in zip(pairs, got):
                want = single()
                same = _bits_equal(g, want)
                log(f"sharded 1x1 {label}: bit-equal to the single-card op: {same}")
                if not same:
                    bad.append(f"sharded 1x1 {label} differs from its single-card op")
            del got

            # ---- the layer's overhead ----
            for label, sharded, single in pairs:
                if label.startswith("pcg"):
                    continue
                ms, ms1 = benchmark_function(sharded), benchmark_function(single)
                log(f"time sharded 1x1 {label}: {ms:.4f} ms, single-card {ms1:.4f} ms, "
                    f"overhead {ms - ms1:+.4f} ms per call")
            for ar in ("f32", "df64"):
                sp = cg_split(lambda it, ar=ar: pcg(acg_s, bcg_s, mesh=mesh, iters=it, ar=ar),
                              20, PCG_ITERS, "pcg")
                sc = cg_split(lambda it, ar=ar: solvers.cg(o["acg"], o["bcg"], iters=it, ar=ar),
                              20, PCG_ITERS)
                log(f"split pcg f32/{ar} n={N_PCG}, one iteration 1x1: median event ms "
                    f"{sp['event_ms']:.4f} | median host ms {sp['host_ms']:.4f} | device ms "
                    f"{sp['device_ms']:.4f} | {sp['records']:g} device records; single-card cg "
                    f"{sc['event_ms']:.4f} | {sc['host_ms']:.4f} | {sc['device_ms']:.4f} | "
                    f"{sc['records']:g}; overhead {sp['event_ms'] - sc['event_ms']:+.4f} ms "
                    f"per iteration")
            del o, pairs, ab_s, xg_s, rg_s, at_s, acg_s, bcg_s
        finally:
            collectives.shutdown()
    torch.cuda.empty_cache()
    return bad


def _cancel_inputs(cols: int, n: int = 8192):
    """tests/test_parallel.py's cancellation DOT with one sign block per
    cols shard: partials of +-n/(32 cols) that cancel across the ranks."""
    rng = np.random.default_rng(7)
    base = np.repeat([1.0, -1.0] * (cols // 2), n // cols) / 32.0
    return (base + rng.uniform(-1.0, 1.0, n) * 1e-2).astype(np.float32)


def _cancel_gemv(cols: int, m: int = 64, n: int = 8192):
    rng = np.random.default_rng(11)
    base = np.repeat([1.0, -1.0] * (cols // 2), n // cols)[None, :] / 32.0
    return (base + rng.uniform(-1.0, 1.0, (m, n)) * 1e-3).astype(np.float32)


def sharded_rank_checks() -> dict:
    """(b), run by each rank of a launch (here 4 ranks sharing cuda:0 over
    gloo; scripts/torch_sharded_cards.py runs it one rank a card): the
    port's dryrun, then every sharded op at full width on the 2-D mesh,
    gathered to every rank; rank 0 holds each result to the JAX tests'
    bound against float64 on the stored values and against the single-card
    op on its card, and times the calls. Returns {"lines", "bad"} (rank
    0's; the others' are empty)."""
    from accblas_tpu_torch import acc_dot, acc_gemv, acc_trsm, acc_trsv
    from accblas_tpu_torch.models import solvers
    from accblas_tpu_torch.parallel import collectives, dryrun, make_mesh, pcg, pdot, pgemv
    from accblas_tpu_torch.parallel import ptrsm, ptrsv, shard, unshard
    from accblas_tpu_torch.utils import interop, tolerance

    lead = collectives.rank() == 0
    lines, bad = [], []

    def note(ok: bool, line: str):
        if lead:
            lines.append(f"sharded {tag} {line}: {'ok' if ok else 'FAILED'}")
            if not ok:
                bad.append(line)

    def timed(fn):
        """fn's result and its host ms (3 calls, each synchronised, min)."""
        best, out = float("inf"), None
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return out, best

    t0 = time.perf_counter()
    line = dryrun.dryrun_rank()
    if lead:
        lines.append(f"{line} ({time.perf_counter() - t0:.1f} s)")
    mesh = make_mesh()
    dev, cols = mesh.device, mesh.cols
    tag = f"{mesh.rows}x{mesh.cols}"
    ms, ms1 = {}, {}  # host ms a call: the sharded op, and rank 0's single-card op

    # pdot df64 precise on the cancellation construction, a sign block per shard
    x = _cancel_inputs(cols)
    xt = interop.from_numpy(x, device=dev)
    ones = torch.ones_like(xt)
    got, ms["pdot df64 cancel"] = timed(lambda: pdot(shard(xt, mesh, ("cols",)),
                                                     shard(ones, mesh, ("cols",)), mesh,
                                                     ar="df64", precise=True))
    if lead:
        ref = math.fsum(x.astype(np.float64))
        single, ms1["pdot df64 cancel"] = timed(lambda: acc_dot(xt, ones, ar="df64",
                                                                precise=True))
        v = float(got.hi.double() + got.lo.double())
        e, gap = abs(v - ref) / abs(ref), abs(v - float(single.hi.double() + single.lo.double()))
        note(e < 1e-12 and gap / abs(ref) < 1e-12,
             f"pdot df64 precise cancellation n={x.size} ({cols} sign blocks): "
             f"err={e:.3e} vs_single={gap / abs(ref):.3e} bound=1.0e-12")

    # pdot df64 precise at 2^27, uniform
    x27 = shard(_gen((N_PDOT_DF64,), "dot_x", dev), mesh, ("cols",))
    y27 = shard(_gen((N_PDOT_DF64,), "dot_y", dev), mesh, ("cols",))
    got, ms["pdot df64 2^27"] = timed(lambda: pdot(x27, y27, mesh, ar="df64", precise=True))
    del x27, y27
    if lead:
        xf, yf = _gen((N_PDOT_DF64,), "dot_x", dev), _gen((N_PDOT_DF64,), "dot_y", dev)
        ref = float(torch.dot(xf.double(), yf.double()))
        single, ms1["pdot df64 2^27"] = timed(lambda: acc_dot(xf, yf, ar="df64", precise=True))
        v = float(got.hi.double() + got.lo.double())
        e, gap = abs(v - ref) / abs(ref), abs(v - float(single.hi.double() + single.lo.double())) \
            / abs(ref)
        note(e < 1e-12 and gap < 1e-12, f"pdot df64 precise n=2^27: err={e:.3e} "
             f"vs_single={gap:.3e} bound=1.0e-12")
        del xf, yf

    # pgemv df64 on the cancellation construction, against the f32 tier
    a = _cancel_gemv(cols)
    at = interop.from_numpy(a, device=dev)
    m, n = a.shape
    xo, r0 = torch.ones(n, device=dev), torch.zeros(m, device=dev)
    errs = {}
    for ar in ("df64", "f32"):
        y = pgemv(shard(at, mesh, ("rows", "cols")), shard(xo, mesh, ("cols",)),
                  shard(r0, mesh, ("rows",)), 1.0, 0.0, ar=ar, mesh=mesh)
        y = unshard(y, mesh, ("rows",), (m,))
        if lead:
            ref = at.double().sum(1)
            errs[ar] = float((y.double() - ref).abs().sum() / ref.abs().sum())
    if lead:
        note(errs["df64"] < 2e-4 and errs["df64"] < errs["f32"] / 5,
             f"pgemv df64 cancellation {m}x{n}: err={errs['df64']:.3e} (f32 tier "
             f"{errs['f32']:.3e}) bound=2.0e-04 and a fifth of the f32 tier's")

    # pgemv at 16384^2: Acc<f32,bf16>, f32 and df64 (fast) on f32 storage
    a32 = _gen((N_GEMV, N_GEMV), "gemv_a", dev)
    xg, rg = _gen((N_GEMV,), "gemv_x", dev), _gen((N_GEMV,), "gemv_res", dev)
    for label, st, ar, tol in (("Acc<f32,bf16>", torch.bfloat16, "f32", tolerance.TOL["f32"]),
                               ("f32", torch.float32, "f32", tolerance.TOL["f32"]),
                               ("Acc<df64,f32>", torch.float32, "df64",
                                tolerance.TOL["df64_fast"])):
        a_s = shard(a32.to(st), mesh, ("rows", "cols"))
        x_s, r_s = shard(xg.to(st), mesh, ("cols",)), shard(rg, mesh, ("rows",))
        y, ms[f"pgemv {label}"] = timed(lambda: pgemv(a_s, x_s, r_s, 1.0, 1.0, ar=ar, mesh=mesh))
        y = unshard(y, mesh, ("rows",), (N_GEMV,))
        del a_s
        if lead:
            ast, xst = a32.to(st), xg.to(st)
            single, ms1[f"pgemv {label}"] = timed(lambda: acc_gemv(ast, xst, rg, 1.0, 1.0,
                                                                    ar=ar))
            a64, x64 = ast.double(), xst.double()
            ref = torch.mv(a64, x64) + rg.double()
            scale = torch.mv(a64.abs(), x64.abs()) + rg.double().abs()
            del a64, ast
            e = tolerance.gemv_row_err(y, ref, scale, y.dtype)
            gap = tolerance.gemv_row_err(y, single, scale, y.dtype)
            note(e <= tol and gap <= 2 * tol, f"pgemv {label} {N_GEMV}^2 beta=1: err={e:.3e} "
                 f"vs_single={gap:.3e} bound={tol:.1e}")
            del ref, scale
    del a32

    # ptrsv and ptrsm f32 on the main path's operand (unit upper,
    # uniform(-1, 1)/n, b = ones; k = 64 seeded right-hand sides)
    at = _gen((N_TRSV, N_TRSV), "trsv_a", dev).mul_(1.0 / N_TRSV)
    bt = torch.ones(N_TRSV, device=dev)
    bm = _gen((N_TRSV, K_PTRSM), "trsv_b", dev)
    a_rows = shard(at, mesh, ("rows", None), identity_tail=True)
    xv, ms["ptrsv f32"] = timed(lambda: ptrsv(a_rows, shard(bt, mesh, ("rows",)), "upper", True,
                                              "f32", mesh=mesh))
    xv = unshard(xv, mesh, ("rows",), (N_TRSV,))
    del a_rows
    xm, ms[f"ptrsm f32 k={K_PTRSM}"] = timed(lambda: ptrsm(at, shard(bm, mesh, (None, "cols")),
                                                           "upper", True, "f32", mesh=mesh))
    xm = unshard(xm, mesh, (None, "cols"), (N_TRSV, K_PTRSM))
    if lead:
        ref = _solve64(at, bt, "upper", True)
        single, ms1["ptrsv f32"] = timed(lambda: acc_trsv(at, bt, "upper", True, ar="f32"))
        e, gap = _rel1(xv, ref), _rel1(xv, single)
        note(e < 3e-5 and gap < 6e-5, f"ptrsv f32 n={N_TRSV} upper unit: err={e:.3e} "
             f"vs_single={gap:.3e} bound=3.0e-05")
        ref = _solve64(at, bm, "upper", True)
        single, ms1[f"ptrsm f32 k={K_PTRSM}"] = timed(lambda: acc_trsm(at, bm, "upper", True,
                                                                        ar="f32"))
        e, gap = _rel1_cols(xm, ref), _rel1_cols(xm, single)
        note(e < 1e-4 and gap < 2e-4, f"ptrsm f32 n={N_TRSV} k={K_PTRSM} (panels of "
             f"{K_PTRSM // cols}, the sweep): err={e:.3e} vs_single={gap:.3e} bound=1.0e-04")
        del ref, single
    del at, bm, xv, xm

    # pcg at n = 8192, 120 iterations, against single-card cg's |r|^2
    from accblas_tpu_torch.bench import solvers_benchmark as sb

    acg, bcg = sb.spd_system(N_PCG, SEED, dev)
    for ar in ("f32", "df64"):
        (_, rp, itp), ms[f"pcg f32/{ar}"] = timed(
            lambda ar=ar: pcg(shard(acg, mesh, ("rows", "cols")), shard(bcg, mesh, ("cols",)),
                              mesh=mesh, iters=PCG_ITERS, ar=ar))
        if lead:
            (_, rs, its), ms1[f"pcg f32/{ar}"] = timed(
                lambda ar=ar: solvers.cg(acg, bcg, iters=PCG_ITERS, ar=ar))
            rp, rs = float(rp), float(rs)
            note(math.isfinite(rp) and rp <= rs * 10 + 1e-12 and rs <= rp * 10 + 1e-12
                 and int(itp) == int(its) == PCG_ITERS,
                 f"pcg f32/{ar} n={N_PCG} {PCG_ITERS} iterations: |r|^2 {rp:.4e}, single-card "
                 f"cg {rs:.4e}, bound 10x either way")
    if lead:
        how = ("ranks time-share one card over gloo: not a scaling number" if mesh.host_staged
               else f"one rank a card over {mesh.transport}")
        lines.append(f"time sharded {tag} ({how}), host ms a call, min of 3, sharded / "
                     "single-card on rank 0's card: "
                     + ", ".join(f"{k} {v:.3f} / {ms1[k]:.3f}" for k, v in ms.items()))
    return {"lines": lines, "bad": bad}


def _gen(shape, role: str, dev) -> torch.Tensor:
    from accblas_tpu_torch.utils import devgen

    return devgen.gen_f32(shape, SEED, role, device=dev)


def phase_sharded() -> None:
    """The sharded layer (accblas_tpu_torch.parallel): (a) a 1 x 1 mesh over
    NCCL in this process (sharded_one_rank); (b) 4 ranks sharing cuda:0 over
    gloo with host-staged collectives (NCCL refuses two ranks on one GPU):
    the dryrun and every op at full width (sharded_rank_checks); (c) the
    solver driver's --pcg table at n = 8192, 120 iterations, over the 4
    ranks, each pcg resid within 4 x the single-card cg resid."""
    from accblas_tpu_torch.bench import solvers_benchmark as sb
    from accblas_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    bad = sharded_one_rank()
    log(f"sharded 1x1: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    res = launch.run(sharded_rank_checks, SHARDED_RANKS, device="cuda", timeout=600)[0]
    for line in res["lines"]:
        log(line)
    bad += res["bad"]
    log(f"sharded 2x2: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    rows = sb.pcg_table(N_PCG, PCG_ITERS, SHARDED_RANKS, "cuda")
    for row in rows:
        _, variant, rp, rs = row.split(";")
        ok = float(rp) <= 4 * float(rs)
        log(f"pcg row {variant}: pcg resid {float(rp):.4e}, cg resid {float(rs):.4e}, "
            f"bound 4 x cg: {'ok' if ok else 'FAILED'}")
        if not ok:
            bad.append(f"--pcg {variant}: pcg resid {rp} above 4 x cg resid {rs}")
    log(f"pcg table: {time.perf_counter() - t1:.1f} s; sharded phase "
        f"{time.perf_counter() - t0:.1f} s")
    if bad:
        raise AssertionError("sharded phase failed:\n" + "\n".join(bad))


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
    kernels.append(_run("draws", phase_draws))
    kernels += _run("generic", phase_generic)
    col_sums, probe_rows = _run("f8 probe", phase_f8_probe)
    for k in kernels:  # the probes' counterparts beside their kernels' records
        if k["name"] in probe_rows:
            k["probe_rows"] = probe_rows[k["name"]]
    kernels.append(col_sums)
    _run("drivers", phase_drivers)
    _run("trsm routes", phase_trsm_routes)
    _run("solvers", phase_solvers)
    _run("sharded", phase_sharded)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
