"""The f8 GEMV probe: GEMV Acc<f32,f8e4m3> at N = 24576 in the port's form
and three torch forms, and the f8 -> f32 column-sum stream, on one card.

    python -m accblas_tpu_torch.bench.probe_r4a [--n N] [--device cuda|cpu]

Counterpart of ``scripts/probe_r4a.py``, on its operands: ``gen_f32((N, N),
42, "p4a_a")``, ``(N,) "p4a_x"`` and ``(N,) "p4a_r"``, drawn on the device
(the JAX probe's bits) and A, x cast to float8_e4m3fn. The forms:

  A  ``acc_gemv(a8, x8, r, 1.0, 0.0, ar="f32")``, the kernel of csrc/gemv.cu;
  B  ``(a8.float() * x8.float()).sum(1)``;
  C  the two-contracting-dimension form, one ``torch.einsum`` over the f32
     upcast of A as (N, N/8, 8) and x as (N/8, 8);
  D  the k-column embed (column 0 of an (N, k) f8 operand is x, the rest
     zero) as ``torch._scaled_mm``, Hopper's f8 GEMM, at k = 16 and 32
     (cuBLASLt takes no k below 16): a yardstick, not a port; a call that
     raises prints "D unavailable: <error>";
  E  ``ops.colsum.col_sums`` (csrc/colsum.cu), the TPU probe's Pallas
     convert stream, at three chunk heights (rows a CTA).

Each form is first checked against float64 on the stored values, then
timed with the CUDA-event protocol (``utils.bench.benchmark_function``) and
reported as GB/s of the bytes it must move (A once, x once, the result
once) and as a share of the H100's 3.35 TB/s. With ``--device cpu`` the
forms run their plain torch versions, are checked and not timed. Without a
card and without ``--device cpu`` the probe exits 2.
"""

from __future__ import annotations

import argparse
import math

import torch

from ..ops import colsum
from ..ops.gemv import acc_gemv
from ..utils import devgen, tolerance
from ..utils.bench import benchmark_function

N_DEFAULT = 24576
SEED = 42
F8 = torch.float8_e4m3fn
PEAK_BYTES = 3.35e12  # the H100 SXM's device memory rate (data sheet)
D_KCOLS = (16, 32)
E_ROWS = (64, colsum.ROWS_PER_BLOCK, 1024)
# bound of the GEMV forms against float64, per row over sum_j |a_ij x_j|:
# the f32 tier's for A, B and C (exact products, f32 sums); D accumulates
# in the tensor cores, which keep fewer bits than f32 between promotions,
# so it is held only to the narrow tiers' floor
GEMV_BOUND = {"A": tolerance.TOL["f32"], "B": tolerance.TOL["f32"],
              "C": tolerance.TOL["f32"], "D": tolerance.NARROW_FLOOR}


def operands(n: int, device):
    """The JAX probe's a8 (n, n), x8 (n,) as float8_e4m3fn and r (n,) f32."""
    a8 = devgen.gen_f32((n, n), SEED, "p4a_a", device=device).to(F8)
    x8 = devgen.gen_f32((n,), SEED, "p4a_x", device=device).to(F8)
    r = devgen.gen_f32((n,), SEED, "p4a_r", device=device)
    return a8, x8, r


def colsum_bound(m: int, rows: int) -> float:
    """The float64 bound of a column sum of m rows in chunks of `rows`,
    relative to sum_i |a_ij|: (d + 1) 2^-24 with d the longest add chain,
    the rows of a chunk then the chunks."""
    d = min(rows, m) + -(-m // rows)
    return (d + 1) * 2.0**-24


def colsum_err(got, ref, scale) -> float:
    """max_j |got_j - ref_j| / scale_j in float64 (0 where the scale is 0
    and the two agree)."""
    diff = (got.double().reshape(-1) - ref).abs()
    return float((diff / scale.clamp_min(torch.finfo(torch.float64).tiny)).max()) \
        if diff.numel() else 0.0


def scaled_mm_form(a8, x8, k: int):
    """Form D at k columns: x as column 0 of a column-major (n, k) f8
    operand, the rest zero, through torch._scaled_mm at unit scales."""
    n = x8.shape[0]
    xe = torch.zeros((k, n), dtype=torch.float32, device=x8.device)
    xe[0] = x8.float()
    xe = xe.to(F8)
    one = torch.ones((), dtype=torch.float32, device=x8.device)
    return lambda: torch._scaled_mm(a8, xe.t(), scale_a=one, scale_b=one,
                                    out_dtype=torch.float32)[:, 0]


def _timed(fn, nbytes: int, on_card: bool) -> dict:
    if not on_card:
        return {"ms": None, "gbps": None, "share": None}
    ms = benchmark_function(fn)
    gbps = nbytes / (ms * 1e-3) / 1e9
    return {"ms": ms, "gbps": gbps, "share": gbps * 1e9 / PEAK_BYTES}


def _line(tag: str, r: dict) -> str:
    head = f"{tag:38s} err {r['err']:.3e} (bound {r['bound']:.1e})"
    if r["ms"] is None:
        return head + "  not timed on the CPU"
    return (head + f"  {r['ms']:.4f} ms  {r['gbps']:8.1f} GB/s  "
            f"({r['share']:.1%} of 3.35 TB/s)")


def main(argv=None) -> dict:
    """Run the probe; returns {form: result}, E as "E<rows a CTA>".
    Raises if a form's check fails."""
    p = argparse.ArgumentParser(prog="probe_r4a", description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=N_DEFAULT,
                   help=f"rows and columns of A, a multiple of 16 (default {N_DEFAULT})")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda); 'cpu' runs the plain versions, untimed")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        p.error(f"--device {dev}: no CUDA device (torch.cuda.is_available() is False); "
                "pass --device cpu to run the plain torch versions")
    n = args.n
    if n < 16 or n % 16:
        p.error(f"--n {n}: needs a multiple of 16 (the f8 GEMM's and the einsum's tiling)")
    on_card = dev.type == "cuda"
    where = torch.cuda.get_device_name(dev) if on_card else "cpu"
    print(f"probe_r4a: N = {n}, GEMV Acc<f32,f8e4m3> and the f8 column sums on {where}",
          flush=True)

    a8, x8, r = operands(n, dev)
    # float64 references on the stored values
    a64 = a8.double()
    x64 = x8.double()
    ref, scale = torch.mv(a64, x64), torch.mv(a64.abs(), x64.abs())
    col_ref, col_scale = a64.sum(0), a64.abs().sum(0)
    del a64

    gemv_bytes = n * n + n + 4 * n  # A and x in f8, the f32 result
    forms = {
        "A": ("A acc_gemv Acc<f32,f8e4m3>", lambda: acc_gemv(a8, x8, r, 1.0, 0.0, ar="f32")),
        "B": ("B (a8.float() * x8.float()).sum(1)", lambda: (a8.float() * x8.float()).sum(1)),
        "C": ("C einsum over the f32 upcast", lambda: torch.einsum(
            "ikl,kl->i", a8.float().view(n, n // 8, 8), x8.float().view(n // 8, 8))),
    }
    for k in D_KCOLS:
        forms[f"D{k}"] = (f"D torch._scaled_mm k={k} embed", scaled_mm_form(a8, x8, k))

    out = {}
    for key, (tag, fn) in forms.items():
        try:
            got = fn()
        except (RuntimeError, NotImplementedError) as e:
            if not key.startswith("D"):
                raise
            print(f"D unavailable: {type(e).__name__}: {str(e).splitlines()[0][:200]}",
                  flush=True)
            out[key] = None
            continue
        bound = GEMV_BOUND[key[0]]
        err = tolerance.gemv_row_err(got.reshape(-1), ref, scale, torch.float32)
        if not (math.isfinite(err) and err <= bound and got.numel() == n):
            raise AssertionError(f"probe_r4a {tag}: error {err:.3e} against float64 is past "
                                 f"its bound {bound:.1e}")
        res = {"err": err, "bound": bound, **_timed(fn, gemv_bytes, on_card)}
        print(_line(tag, res), flush=True)
        out[key] = res

    e_bytes = n * n + 4 * n  # A in f8, the f32 row
    for rows in E_ROWS:
        tag = f"E col_sums rows={rows}"
        got = colsum.col_sums(a8, rows)
        bound = colsum_bound(n, rows)
        err = colsum_err(got, col_ref, col_scale)
        if not (math.isfinite(err) and err <= bound and got.shape == (1, n)):
            raise AssertionError(f"probe_r4a {tag}: error {err:.3e} against float64 is past "
                                 f"its bound {bound:.3e}")
        res = {"err": err, "bound": bound, "out": got,
               **_timed(lambda rows=rows: colsum.col_sums(a8, rows), e_bytes, on_card)}
        print(_line(tag, res), flush=True)
        out[f"E{rows}"] = res
    return out


if __name__ == "__main__":
    main()
