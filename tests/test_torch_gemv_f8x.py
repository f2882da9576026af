"""GEMV with x stored in f8: every f8 code against the JAX package, and the
choice of kernel.

On the CPU the port runs its plain torch version and the JAX side its Pallas
kernels in interpret mode, as tests/test_gemv.py runs them. On a card A and
x stored in f8 take ``gemv_staged`` (x widened once a CTA into shared
memory) up to ``STAGED_MAX_N`` columns, in the f32 and df64 tiers, on the
vector steps, and ``gemv_rows`` otherwise, as csrc/gemv.cu's C entry
chooses (``staged_route`` of tests/test_torch_cuda.py states it, and every
GEMV launch there is held to it); the two kernels are held to each other
bit for bit, and to the plain version, there.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from accblas_tpu.ops import df64 as jdf
from accblas_tpu.ops import gemv as jgemv
from accblas_tpu_torch.ops import df64 as tdf
from accblas_tpu_torch.ops import gemv as tgemv
from accblas_tpu_torch.utils import MatrixInfo, gen_mtx, interop, tolerance
from test_torch_cuda import STAGED_MAX_N, route_of, staged_route

import chip_smoke

torch.set_num_threads(1)

_NP = {"f8e4m3": ml_dtypes.float8_e4m3fn, "f8e5m2": ml_dtypes.float8_e5m2,
       "bf16": ml_dtypes.bfloat16, "f32": np.float32}
F8 = ("f8e4m3", "f8e5m2")


# x's codes: every one (NaN reaches every row), the finite ones, and for
# e5m2 the finite ones with its two infinities
CASES = [(st, keep) for st in F8 for keep in ("every", "finite")] + [("f8e5m2", "not NaN")]


def _codes(st: str, keep: str) -> np.ndarray:
    """The codes of an f8 storage that `keep` names, then the same codes in
    reverse: each value, subnormals and -0 included, twice over."""
    codes = np.arange(256, dtype=np.uint8).view(_NP[st])
    v = codes.astype(np.float32)
    codes = codes[{"every": np.ones(256, bool), "finite": np.isfinite(v),
                   "not NaN": ~np.isnan(v)}[keep]]
    return np.concatenate([codes, codes[::-1]])


def _f64(out) -> np.ndarray:
    if isinstance(out, tdf.DF):
        return tdf.df_to_f64(out).numpy()
    if isinstance(out, jdf.DF):
        return np.asarray(jdf.df_to_f64(out))
    if isinstance(out, torch.Tensor):
        return out.double().numpy()
    return np.asarray(jnp.asarray(out, jnp.float32), np.float64)


@pytest.mark.parametrize("xst,keep", CASES)
@pytest.mark.parametrize("ast", ["f32", "bf16", "f8"])
@pytest.mark.parametrize("tier", ["f32", "bf16", "df64_fast", "df64_precise"])
def test_acc_gemv_every_f8_code_of_x(tier, ast, xst, keep):
    """x holding every code of its f8 storage, A and res seeded: the port
    and the JAX package give NaN and the signed infinities in the same rows,
    and finite rows within the tier's bound of float64 and of each other
    (the per-row bounds of tests/test_torch_gemv.py)."""
    x = _codes(xst, keep)
    m, n = 24, x.shape[0]
    a = gen_mtx(MatrixInfo(m, n), seed=5).astype(np.float32).astype(
        _NP[xst if ast == "f8" else ast])
    r = gen_mtx(MatrixInfo(1, m), seed=6)[0].astype(np.float32)
    ar, precise = ("df64", tier == "df64_precise") if tier.startswith("df64") else (tier, False)
    got = _f64(tgemv.acc_gemv(*(interop.from_numpy(v) for v in (a, x, r)), 1.5, 0.5, ar,
                              precise=precise))
    want = _f64(jgemv.acc_gemv(*(jnp.asarray(v) for v in (a, x, r)), 1.5, 0.5, ar,
                               precise=precise))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(got)
    np.testing.assert_array_equal(inf, np.isinf(want))
    np.testing.assert_array_equal(got[inf], want[inf])
    fin = np.isfinite(got)
    assert fin.all() if keep == "finite" else not fin.all()
    a64, x64, r64 = a.astype(np.float64), x.astype(np.float64), r.astype(np.float64)
    with np.errstate(invalid="ignore"):  # inf - inf in the rows left out
        ref = torch.from_numpy(1.5 * (a64 @ x64) + 0.5 * r64)[fin]
    scale = torch.from_numpy(1.5 * (np.abs(a64) @ np.abs(x64)) + 0.5 * np.abs(r64))[fin]
    g, w = torch.from_numpy(got)[fin], torch.from_numpy(want)[fin]
    err = tolerance.gemv_row_err(g, ref, scale, torch.float32)
    jerr = tolerance.gemv_row_err(w, ref, scale, torch.float32)
    if tier in tolerance.TOL:
        tol = tolerance.TOL[tier]
        assert err <= tol and jerr <= tol, (err, jerr, tol)
        assert tolerance.gemv_row_err(g, w, scale, torch.float32) <= 2 * tol
    else:
        assert err <= tolerance.narrow_bound(jerr), (err, jerr)


STORAGES = ("f32", "bf16", "f16", "f8e4m3", "f8e5m2")


@pytest.mark.parametrize("xst", STORAGES)
def test_staged_route_is_a_function_of_n_and_x_storage(xst):
    """gemv_staged takes A and x both stored in f8 on the vector steps (n a
    multiple of 16) up to STAGED_MAX_N columns; past it, off the vector
    steps, and for any other storage of A or x, gemv_rows."""
    for ast in STORAGES:
        both = ast in F8 and xst in F8
        for n in (16, 1024, 4096, 24576, STAGED_MAX_N - 16, STAGED_MAX_N):
            assert staged_route(n, ast, xst, "f32") == both
        for n in (STAGED_MAX_N + 16, 2**20, 17, 1016, 24576 + 8):
            assert not staged_route(n, ast, xst, "f32")


@pytest.mark.parametrize("case,staged", [
    ("f8 A", True), ("e5m2 A", True), ("bf16 A", False), ("f32 A", False), ("f32 x", False),
    ("bf16 tier", False), ("f16 tier", False), ("A one element off", False),
    ("x one element off", False), ("n not a multiple of V", False), ("past the edge", False)])
def test_staged_takes_the_calls_it_wins(case, staged):
    """gemv_staged within the width edge, for A and x stored in f8, in the
    f32 and df64 tiers, on the vector steps (A and x 16-byte aligned, n a
    multiple of 16); every other call gemv_rows."""
    n = {"past the edge": STAGED_MAX_N + 16, "n not a multiple of V": 1016}.get(case, 1024)
    ad = {"bf16 A": torch.bfloat16, "f32 A": torch.float32,
          "e5m2 A": torch.float8_e5m2}.get(case, torch.float8_e4m3fn)
    xd = torch.float32 if case == "f32 x" else torch.float8_e5m2
    a_off, x_off = int(case == "A one element off"), int(case == "x one element off")
    a = torch.zeros(4 * n + 16, dtype=ad)
    a = a[(-a.data_ptr() // a.element_size()) % (16 // a.element_size()):][a_off:a_off + 4 * n]
    x = torch.zeros(n + 16, dtype=xd)
    x = x[(-x.data_ptr() // x.element_size()) % (16 // x.element_size()):][x_off:x_off + n]
    tier = {"bf16 tier": "bf16", "f16 tier": "f16"}.get(case, "f32")
    assert route_of(a.view(4, n), x, tier) == staged
    for t in ("df64_fast", "df64_precise"):
        assert route_of(a.view(4, n), x, t) == (staged or case in ("bf16 tier", "f16 tier"))


def test_staged_edge_is_the_shared_memory_limit():
    """STAGED_MAX_N is the widest n at which csrc/gemv.cu's staged x fits
    in the shared memory its C entry allows: n / 16 rows of 16 XStage
    values, a 16-byte gap after each row wider than 16 bytes; and the
    wrapper, the C source and chip_smoke.py state the same edge."""
    src = (Path(__file__).resolve().parents[1] / "accblas_tpu_torch" / "csrc"
           / "gemv.cu").read_text()
    limit = int(re.search(r"constexpr int64_t kMaxStagedBytes = (\d+);", src)[1])
    size = {"float": 4, "__half": 2}[re.search(r"using XStage = (\w+);", src)[1]]
    assert "constexpr int kStagedPiece = 16 / sizeof(XStage);" in src
    assert "return V * sizeof(XStage) > 16 ? V + kStagedPiece : V;" in src
    assert "return n / V * staged_stride<V>() * int64_t{sizeof(XStage)};" in src

    def staged_bytes(n: int) -> int:
        row = 16 * size
        return n // 16 * (row + 16 if row > 16 else row)

    assert staged_bytes(STAGED_MAX_N) <= limit < staged_bytes(STAGED_MAX_N + 16)
    assert STAGED_MAX_N % 16 == 0 and staged_bytes(24576) == 24576 // 16 * 80
    assert f"n <= {STAGED_MAX_N}" in src and f"n = {STAGED_MAX_N}" in tgemv.__doc__
    assert chip_smoke.STAGED_MAX_N == STAGED_MAX_N
