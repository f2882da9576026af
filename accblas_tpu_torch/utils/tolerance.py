"""Error bounds of each tier, shared by the tests and ``chip_smoke.py``.

Each tier is held to the bound the JAX package's tests hold it to against a
float64 oracle on the *stored* values (tests/test_dot.py):

- f32 arithmetic: relative error ≤ 1e-5 (products of narrow storage are
  exact; only the order of the f32 sum differs between implementations);
- df64 fast: ≤ 5e-7, the f32 product-rounding floor;
- df64 precise: ≤ 1e-12;
- bf16 / f16 fixed tiers round every add, in an order that differs between
  implementations, so only the envelope can match: the error is at most
  4 × max(the reference implementation's error, 2^-8).

Two implementations of one tier must also agree within twice the bound.
GEMV applies the bounds per row against the row's scale
|alpha|·(|A|·|x|)_i + |beta|·|res_i|, after allowing for the rounding of the
result to the storage of res (``OUT_ULP``).
"""

from __future__ import annotations

import torch

TOL = {"f32": 1e-5, "df64_fast": 5e-7, "df64_precise": 1e-12}

# the envelope floor of the rounded-add tiers, relative to |result|: the
# reference's bf16 floor, 2^-8. The f16 tier, which the reference's tests
# never bound, takes the same floor: with the cancellation of a long dot
# product (|result| far below sum |x_i y_i|), a floor of f16's own 2^-11
# sits inside the spread of two correct summation orders.
NARROW_FLOOR = 2.0**-8

# unit roundoff of a result stored in each storage type (None: unrounded DF)
OUT_ULP = {None: 0.0, torch.float32: 2.0**-24, torch.bfloat16: 2.0**-8,
           torch.float16: 2.0**-11}


def narrow_bound(ref_err: float) -> float:
    """Bound on a bf16/f16 tier's error, given the reference's error."""
    return 4.0 * max(ref_err, NARROW_FLOOR)


def gemv_row_err(got: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor,
                 out_dtype=None) -> float:
    """max_i (|got_i - ref_i| - u_out·|ref_i|)^+ / scale_i, in float64: the
    per-row error against the row scale, net of the result's own rounding
    to its storage (u_out = OUT_ULP[out_dtype])."""
    got, ref, scale = got.double(), ref.double(), scale.double()
    excess = ((got - ref).abs() - OUT_ULP[out_dtype] * ref.abs()).clamp_min(0.0)
    return float((excess / scale.clamp_min(torch.finfo(torch.float64).tiny)).max()) \
        if got.numel() else 0.0
