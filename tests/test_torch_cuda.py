"""The port's CUDA kernels against their plain torch versions, on a card.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is False: a CUDA kernel has no CPU mode. The file imports no JAX, so it also
runs on a GPU machine without it (``--noconftest`` skips the JAX set-up of
tests/conftest.py):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import accblas_tpu_torch
from accblas_tpu_torch.ops import df64 as tdf
from accblas_tpu_torch.ops import dot as tdot
from accblas_tpu_torch.ops import gemv as tgemv
from accblas_tpu_torch.ops import tri_gemv as ttri
from accblas_tpu_torch.ops import trsv as ttrsv
from accblas_tpu_torch.utils import MatrixInfo, devgen, gen_mtx, interop, tolerance

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16,
           "f8e4m3": torch.float8_e4m3fn, "f8e5m2": torch.float8_e5m2}
TIERS = ("f32", "bf16", "f16", "df64_fast", "df64_precise")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ar(tier):
    return ("df64", tier == "df64_precise") if tier.startswith("df64") else (tier, False)


def _value(out) -> torch.Tensor:
    return tdf.df_to_f64(out) if isinstance(out, tdf.DF) else out.double()


def _dot_check(tier, got, plain, ref):
    den = float(ref.abs())
    err, perr = float((got - ref).abs()) / den, float((plain - ref).abs()) / den
    if tier in tolerance.TOL:
        tol = tolerance.TOL[tier]
        assert err <= tol and perr <= tol, (err, perr, tol)
        assert float((got - plain).abs()) / den <= 2 * tol
    else:
        assert err <= tolerance.narrow_bound(perr), (err, perr)


def _run_dot(x, y, tier, init=0.5):
    ar, precise = _ar(tier)
    before = tdot.launches
    got = _value(tdot.acc_dot(x, y, ar, precise=precise, init=init))
    assert tdot.launches == before + 1
    hi, lo = tdot._dot_plain(x, y, tier, init)
    ref = torch.dot(x.double(), y.double()) + init
    _dot_check(tier, got, hi.double() + lo.double(), ref)
    return got


@pytest.mark.parametrize("st", list(STORAGE))
@pytest.mark.parametrize("tier", TIERS)
def test_dot_kernel_every_tier_and_storage(cuda, tier, st):
    # a draw of typical conditioning, |x.y + 0.5| = 111 against sqrt(n)/3 =
    # 105: the tiers' bounds are stated for such data (seed 1's draw cancels,
    # see test_dot_kernel_on_a_cancelling_draw)
    x = devgen.gen_f32((100_003,), 4, "dot_x", device=cuda).to(STORAGE[st])
    y = devgen.gen_f32((100_003,), 4, "dot_y", device=cuda).to(STORAGE[st])
    _run_dot(x, y, tier)


def test_dot_kernel_on_a_cancelling_draw(cuda):
    """Seed 1's draw cancels to |x.y + 0.5| = 2.3 (sqrt(n)/3 = 105), where the
    df64-fast tier's f32 product rounding alone is 1.0e-6 of the result,
    above the 5e-7 its bound assumes of typical data (the plain version
    errs the same). The kernel agrees with the plain version within that
    bound, and both stay within 3 x 2^-24 x ||x o y||_2 of float64, the
    rounding of the products; the precise tier keeps its own bound."""
    x = devgen.gen_f32((100_003,), 1, "dot_x", device=cuda)
    y = devgen.gen_f32((100_003,), 1, "dot_y", device=cuda)
    ref = torch.dot(x.double(), y.double()) + 0.5
    den = float(ref.abs())
    assert den < 3.0
    got = _value(tdot.acc_dot(x, y, "df64", init=0.5))
    hi, lo = tdot._dot_plain(x, y, "df64_fast", 0.5)
    plain = hi.double() + lo.double()
    assert float((got - plain).abs()) / den <= 2 * tolerance.TOL["df64_fast"]
    scale = 3 * 2.0**-24 * float((x.double() * y.double()).norm())
    for v in (got, plain):
        assert float((v - ref).abs()) <= scale, (float((v - ref).abs()), scale)
    _run_dot(x, y, "df64_precise")


@pytest.mark.parametrize("n", [0, 1, 7, 33, 4096 + 5])
@pytest.mark.parametrize("tier", ["f32", "bf16", "df64_precise"])
def test_dot_kernel_small_and_unaligned(cuda, tier, n):
    base = devgen.gen_f32((n + 1,), 2, "dot_x", device=cuda).to(torch.bfloat16)
    y = devgen.gen_f32((n,), 2, "dot_y", device=cuda).to(torch.bfloat16)
    x = base[1:]  # 2 bytes past a 16-byte boundary: the element-wise path
    if n:
        _run_dot(x, y, tier)
    else:
        assert float(_value(tdot.acc_dot(x, y, "f32", init=0.5))) == 0.5


def test_dot_kernel_repeats_its_bits(cuda):
    x = devgen.gen_f32((3_000_001,), 3, "dot_x", device=cuda)
    y = devgen.gen_f32((3_000_001,), 3, "dot_y", device=cuda)
    first = tdot.acc_dot(x, y, "df64")
    for _ in range(3):
        again = tdot.acc_dot(x, y, "df64")
        assert torch.equal(first.hi, again.hi) and torch.equal(first.lo, again.lo)


def _gemv_check(tier, got, plain, ref, scale, out_dtype):
    err = tolerance.gemv_row_err(got, ref, scale, out_dtype)
    perr = tolerance.gemv_row_err(plain, ref, scale, out_dtype)
    if tier in tolerance.TOL:
        tol = tolerance.TOL[tier]
        assert err <= tol and perr <= tol, (err, perr, tol)
        assert tolerance.gemv_row_err(got, plain, scale, out_dtype) <= 2 * tol
    else:
        assert err <= tolerance.narrow_bound(perr), (err, perr)


def _run_gemv(a, x, r, tier, alpha, beta, df_out=False):
    ar, precise = _ar(tier)
    before = tgemv.launches
    got = tgemv.acc_gemv(a, x, r, alpha, beta, ar, precise=precise, df_out=df_out)
    assert tgemv.launches == before + 1
    plain = tgemv._gemv_plain(a, x, r, alpha, beta, tier, df_out)
    a64, x64 = a.double(), x.double()
    ref = alpha * (a64 @ x64) + (0.0 if beta == 0 else beta * r.double())
    scale = abs(alpha) * (a64.abs() @ x64.abs())
    if beta != 0:
        scale = scale + abs(beta) * r.double().abs()
    out_dtype = None if df_out else r.dtype
    g = _value(got)
    assert torch.isfinite(g).all()
    _gemv_check(tier, g, _value(plain), ref, scale, out_dtype)
    return got


@pytest.mark.parametrize("st", list(STORAGE))
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("m,n", [(300, 1234), (64, 4096)])
def test_gemv_kernel_every_tier_and_storage(cuda, tier, st, m, n):
    a = devgen.gen_f32((m, n), 4, "gemv_a", device=cuda).to(STORAGE[st])
    x = devgen.gen_f32((n,), 4, "gemv_x", device=cuda).to(STORAGE[st])
    r = devgen.gen_f32((m,), 4, "gemv_res", device=cuda)
    _run_gemv(a, x, r, tier, 1.5, 0.5)


@pytest.mark.parametrize("tier", TIERS)
def test_gemv_kernel_beta0_nan_res_and_bf16_out(cuda, tier):
    a = devgen.gen_f32((96, 2048), 5, "gemv_a", device=cuda).to(torch.bfloat16)
    x = devgen.gen_f32((2048,), 5, "gemv_x", device=cuda).to(torch.bfloat16)
    nan = torch.full((96,), float("nan"), device=cuda)
    _run_gemv(a, x, nan, tier, 1.0, 0.0)
    rb = devgen.gen_f32((96,), 5, "gemv_res", device=cuda).to(torch.bfloat16)
    assert _run_gemv(a, x, rb, tier, 1.0, 1.0).dtype == torch.bfloat16


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("m,n,st,x_off", [
    # m not a multiple of a CTA's 4 rows
    (1, 1236, "f32", 0), (7, 1236, "f32", 0), (301, 1236, "f32", 0),
    # vector steps a lane takes that leave a ragged rest after the unrolled
    # ones (16392 bf16 columns: 2049 steps of 8; 1236 f32: 309 of 4), and n
    # not a multiple of the vector width (1234 f32): the element loads
    (7, 16384 + 8, "bf16", 0), (9, 1234, "f32", 0),
    # n > 1024 and not a multiple of the bf16/f16 tiers' 1024-column block
    (37, 3000, "f16", 0),
    # x one element off a 16-byte boundary: the element loads
    (33, 2048, "bf16", 1), (9, 1236, "f32", 1),
])
def test_gemv_kernel_edges(cuda, tier, m, n, st, x_off):
    a = devgen.gen_f32((m, n), 8, "gemv_a", device=cuda).to(STORAGE[st])
    buf = devgen.gen_f32((n + x_off,), 8, "gemv_x", device=cuda).to(STORAGE[st])
    x = buf[x_off:]
    r = devgen.gen_f32((m,), 8, "gemv_res", device=cuda)
    _run_gemv(a, x, r, tier, 1.5, 0.5)


@pytest.mark.parametrize("tier", TIERS)
def test_gemv_kernel_repeats_its_bits(cuda, tier):
    """20 calls queued on one stream without a synchronisation: every sum
    runs in a fixed order, so each result has the first one's bits."""
    a = devgen.gen_f32((1003, 5000), 9, "gemv_a", device=cuda).to(torch.bfloat16)
    x = devgen.gen_f32((5000,), 9, "gemv_x", device=cuda).to(torch.bfloat16)
    r = devgen.gen_f32((1003,), 9, "gemv_res", device=cuda)
    ar, precise = _ar(tier)
    df_out = tier == "df64_precise"
    outs = [tgemv.acc_gemv(a, x, r, 1.5, 0.5, ar, precise=precise, df_out=df_out)
            for _ in range(20)]
    torch.cuda.synchronize()
    if df_out:
        assert all(torch.equal(outs[0].hi, o.hi) and torch.equal(outs[0].lo, o.lo)
                   for o in outs[1:])
    else:
        assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("tier", ["df64_fast", "df64_precise"])
@pytest.mark.parametrize("m,n", [(40, 777), (41, 2048), (4, 140_000)])
def test_gemv_kernel_df_out(cuda, tier, m, n):
    a = devgen.gen_f32((m, n), 6, "gemv_a", device=cuda)
    x = devgen.gen_f32((n,), 6, "gemv_x", device=cuda)
    r = devgen.gen_f32((m,), 6, "gemv_res", device=cuda)
    out = _run_gemv(a, x, r, tier, 2.0, 0.5, df_out=True)
    assert isinstance(out, tdf.DF) and out.hi.dtype == torch.float32


def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tdot.acc_dot(x[::2], x[::2], "f32")
    with pytest.raises(ValueError, match="different devices"):
        tdot.acc_dot(x, x.cpu(), "f32")
    a = torch.zeros(8, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tgemv.acc_gemv(a.t(), x[:8], x[:8], ar="f32")
    with pytest.raises(ValueError, match="kernel storage type"):
        tgemv.acc_gemv(a.double(), x[:8].double(), x[:8], ar="df64")


def test_flagship_slice_on_cuda(cuda):
    """The entry() operands (seeded host data) through the public API."""
    m, n = 1024, 2048
    a = interop.from_numpy(gen_mtx(MatrixInfo(m, n), seed=42).astype(np.float32), "bf16", cuda)
    x = interop.from_numpy(gen_mtx(MatrixInfo(1, n), seed=43)[0].astype(np.float32), "bf16", cuda)
    r = interop.from_numpy(gen_mtx(MatrixInfo(1, m), seed=44)[0].astype(np.float32), device=cuda)
    before = (tdot.launches, tgemv.launches)
    out = accblas_tpu_torch.acc_gemv(a, x, r, 1.0, 1.0, ar="f32")
    d = accblas_tpu_torch.acc_dot(x, x, ar="f32")
    assert (tdot.launches, tgemv.launches) == (before[0] + 1, before[1] + 1)
    a64, x64 = a.double(), x.double()
    err = tolerance.gemv_row_err(out, a64 @ x64 + r.double(), a64.abs() @ x64.abs()
                                 + r.double().abs(), torch.float32)
    assert err <= tolerance.TOL["f32"]
    ref = float(x64 @ x64)
    assert abs(float(d) - ref) / ref <= tolerance.TOL["f32"]


# ---- TRSV/TRSM: the leaf gather and the sweep ----

def _packed_lu(n, seed, device):
    """The JAX tests' operand: the packed LU factor of a diagonally dominant
    seeded matrix (float64 on the host), and a right-hand side."""
    import scipy.linalg

    a64 = gen_mtx(MatrixInfo(n, n), seed=seed) + np.eye(n) * (0.25 * n)
    lu, _ = scipy.linalg.lu_factor(a64)
    b = gen_mtx(MatrixInfo(1, n), seed=seed + 1)[0]
    return (interop.from_numpy(lu.astype(np.float32), device=device),
            interop.from_numpy(b.astype(np.float32), device=device))


def _ldu(a):
    """U's strict upper triangle scaled by U's diagonal (the LDU form): the
    unit-upper operand. On the raw factor, unit-upper drops U's large
    diagonal and is ill-conditioned (leaf inverses reach 1e4), outside the
    envelope the JAX package's df64 tests hold."""
    return torch.tril(a) + torch.triu(a, 1) / a.diagonal()[:, None]


def _tri64(a, uplo, unit):
    t = a.double()
    t = torch.tril(t) if uplo == "lower" else torch.triu(t)
    if unit:
        t.fill_diagonal_(1.0)
    return t


def _solve64(a, b, uplo, unit):
    """float64 solve of the stored triangle, on the card."""
    b2 = b.double().reshape(b.shape[0], -1)
    x = torch.linalg.solve_triangular(_tri64(a, uplo, unit), b2, upper=uplo != "lower")
    return x.reshape(b.shape)


def _rel1(got, ref):
    got, ref = got.double().reshape(-1), ref.double().reshape(-1)
    return float((got - ref).abs().sum() / ref.abs().sum())


def _run_trsv(a, b, uplo, unit, ar, tol):
    """The public acc_trsm/acc_trsv through the kernels, against the plain
    sweep on the same inputs and against float64."""
    vec = b.dim() == 1
    before = (ttrsv.leaf_diag_launches, ttrsv.sweep_launches)
    fn = accblas_tpu_torch.acc_trsv if vec else accblas_tpu_torch.acc_trsm
    got = fn(a, b, uplo, unit, ar=ar, unstable_ok=True)
    assert (ttrsv.leaf_diag_launches, ttrsv.sweep_launches) == (before[0] + 1, before[1] + 1)
    n = a.shape[0]
    nb = -(-n // ttrsv.BLOCK)
    d = ttrsv._extract_leaf_diag_plain(a, nb * ttrsv.BLOCK // ttrsv.LEAF, uplo == "lower", unit)
    inv = ttrsv._leaf_inverses(d, uplo == "lower")
    bt = ttrsv._rhs_panels(b.reshape(n, -1), nb)
    plain = ttrsv._trsv_sweep_plain(a, inv, bt, uplo == "lower", ar, got.dtype)
    ref = _solve64(a, b, uplo, unit)
    assert torch.isfinite(got).all()
    err, perr = _rel1(got, ref), _rel1(plain, ref)
    assert err < tol and perr < tol, (err, perr, tol)
    assert _rel1(got, plain.reshape(got.shape)) < 2 * tol
    return got


_TRSV_TOL = {("f32", "f32"): 1e-4, ("df64", "f32"): 5e-6}


def _trsv_tol(ar, st):
    return _TRSV_TOL.get((ar, st), 1e-3)  # narrow storage: the bf16 bound


@pytest.mark.parametrize("ar", ["f32", "df64"])
@pytest.mark.parametrize("uplo,unit", [("upper", True), ("lower", True), ("upper", False),
                                       ("lower", False)])
@pytest.mark.parametrize("n", [512, 700])
def test_trsv_kernel_every_mode(cuda, n, uplo, unit, ar):
    a, b = _packed_lu(n, 42, cuda)
    if (uplo, unit) == ("upper", True):
        a = _ldu(a)
    _run_trsv(a, b, uplo, unit, ar, _trsv_tol(ar, "f32"))


@pytest.mark.parametrize("ar", ["f32", "df64"])
@pytest.mark.parametrize("st", list(STORAGE))
@pytest.mark.parametrize("uplo,unit", [("upper", False), ("lower", True)])
def test_trsv_kernel_every_storage(cuda, st, uplo, unit, ar):
    a, b = _packed_lu(1000, 7, cuda)
    _run_trsv(a.to(STORAGE[st]), b, uplo, unit, ar, _trsv_tol(ar, st))


@pytest.mark.parametrize("n", [1, 100, 1024, 2600])
def test_trsv_kernel_sizes(cuda, n):
    a, b = _packed_lu(n, 11, cuda)
    for ar in ("f32", "df64"):
        _run_trsv(a, b, "upper", False, ar, _trsv_tol(ar, "f32"))


@pytest.mark.parametrize("uplo,unit", [("upper", False), ("lower", True), ("lower", False)])
@pytest.mark.parametrize("n", [63, 64, 65, 127, 129])
def test_trsv_kernel_block_row_boundaries(cuda, n, uplo, unit):
    """A block row of the sweep is one 64-row leaf: one, two and three
    block rows, full and ragged."""
    a, b = _packed_lu(n, 43, cuda)
    for ar in ("f32", "df64"):
        _run_trsv(a, b, uplo, unit, ar, _trsv_tol(ar, "f32"))


@pytest.mark.parametrize("ar", ["f32", "df64"])
@pytest.mark.parametrize("k", [3, 5, 8])
def test_trsm_kernel_matches_trsv_per_column(cuda, k, ar):
    """Right-hand sides are independent, and the kernel sums each one in
    the same order: a column of TRSM is the TRSV of that column, bit for bit."""
    a, _ = _packed_lu(1000, 13, cuda)
    bm = devgen.gen_f32((1000, k), 13, "trsv_b", device=cuda)
    x = _run_trsv(a, bm, "lower", True, ar, _trsv_tol(ar, "f32"))
    for c in range(k):
        xc = accblas_tpu_torch.acc_trsv(a, bm[:, c].contiguous(), "lower", True, ar=ar)
        assert torch.equal(x[:, c], xc)


def test_trsv_kernel_result_storage_and_repeats(cuda):
    a, b = _packed_lu(1000, 17, cuda)
    for ar in ("f32", "df64"):
        first = accblas_tpu_torch.acc_trsv(a, b, "upper", False, ar=ar)
        for _ in range(3):
            assert torch.equal(first, accblas_tpu_torch.acc_trsv(a, b, "upper", False, ar=ar))
    bh = b.to(torch.float16)
    got = _run_trsv(a.to(torch.float16), bh, "upper", False, "df64", 1e-3)
    assert got.dtype == torch.float16
    assert accblas_tpu_torch.trsv(a, b.to(torch.bfloat16), unit=False).dtype == torch.bfloat16


def test_trsv_kernel_back_to_back_sweeps_repeat(cuda):
    """50 sweeps queued on one stream without a synchronisation: each resets
    its counters, and every result has the first one's bits."""
    a, b = _packed_lu(1000, 47, cuda)
    bm = devgen.gen_f32((1000, 5), 47, "trsv_b", device=cuda)
    for ar in ("f32", "df64"):
        before = ttrsv.sweep_launches
        xs = [accblas_tpu_torch.acc_trsv(a, b, "lower", False, ar=ar) for _ in range(50)]
        ms = [accblas_tpu_torch.acc_trsm(a, bm, "upper", False, ar=ar) for _ in range(50)]
        assert ttrsv.sweep_launches == before + 100
        torch.cuda.synchronize()
        assert all(torch.equal(xs[0], x) for x in xs[1:])
        assert all(torch.equal(ms[0], m) for m in ms[1:])
        _run_trsv(a, b, "lower", False, ar, _trsv_tol(ar, "f32"))


def test_trsv_kernel_grid_beyond_the_resident_ctas(cuda):
    """More block rows than the card holds CTAs at once: the tickets keep
    the sweep advancing whatever order the CTAs start in."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    resident = ttrsv.sweep_occupancy(torch.float32, "f32", 1) * sms
    n = max(20000, ttrsv.LEAF * (resident + 49) + 17)
    assert -(-n // ttrsv.LEAF) > resident
    a = devgen.gen_f32((n, n), 53, "trsv_a", device=cuda).mul_(1.0 / n)
    b = torch.ones(n, device=cuda)
    x = accblas_tpu_torch.trsv(a, b, "upper", True)
    ref = _solve64(a, b, "upper", True)
    assert torch.isfinite(x).all()
    assert _rel1(x, ref) < 1e-4


def test_trsv_kernel_unaligned_matrix(cuda):
    """A 4 bytes past a 16-byte boundary: the element-wise loads."""
    a, b = _packed_lu(640, 19, cuda)
    buf = torch.empty(640 * 640 + 1, device=cuda)
    buf[1:] = a.reshape(-1)
    _run_trsv(buf[1:].view(640, 640), b, "upper", False, "df64", 5e-6)


@pytest.mark.parametrize("st", list(STORAGE))
@pytest.mark.parametrize("n", [1000, 1024])
def test_leaf_gather_kernel_bits(cuda, st, n):
    """The masked gather against tri_mask of the plain gather, bit for bit,
    in every mode; the unaligned A takes the element loads."""
    a = devgen.gen_f32((n, n), 23, "gemv_a", device=cuda).to(STORAGE[st])
    buf = torch.empty(n * n + 1, dtype=a.dtype, device=cuda)
    buf[1:] = a.reshape(-1)
    m = -(-n // ttrsv.BLOCK) * ttrsv.BLOCK // ttrsv.LEAF
    for lower in (False, True):
        for unit in (False, True):
            want = ttrsv._extract_leaf_diag_plain(a, m, lower, unit)
            for op in (a, buf[1:].view(n, n)):
                before = ttrsv.leaf_diag_launches
                got = ttrsv._extract_leaf_diag(op, m, lower, unit)
                assert ttrsv.leaf_diag_launches == before + 1
                assert torch.equal(got, want)


def test_trsv_kernels_reject_what_they_do_not_take(cuda):
    a, b = _packed_lu(64, 29, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        accblas_tpu_torch.trsv(a.t(), b)
    with pytest.raises(ValueError, match="different devices"):
        accblas_tpu_torch.trsv(a, b.cpu())


# ---- the triangular residual ----

@pytest.mark.parametrize("st", list(STORAGE))
@pytest.mark.parametrize("uplo,unit", [("upper", True), ("lower", True), ("upper", False),
                                       ("lower", False)])
@pytest.mark.parametrize("n", [1000, 4096])
def test_tri_gemv_kernel(cuda, n, uplo, unit, st):
    a = devgen.gen_f32((n, n), 31, "gemv_a", device=cuda).to(STORAGE[st])
    x = devgen.gen_f32((n,), 31, "gemv_x", device=cuda)
    b = devgen.gen_f32((n,), 31, "trsv_b", device=cuda)
    before = ttri.launches
    got = ttri.tri_gemv_df64(a, x, b, uplo, unit)
    assert ttri.launches == before + 1
    plain = ttri._tri_gemv_plain(a, x, b, uplo == "lower", unit)
    tx = _tri64(a, uplo, unit) @ x.double()
    ref, den = b.double() - tx, float(tx.abs().sum())
    err = float((got.double() - ref).abs().sum()) / den
    perr = float((plain.double() - ref).abs().sum()) / den
    assert err < 1e-6 and perr < 1e-6, (err, perr)
    assert float((got.double() - plain.double()).abs().sum()) / den < 2e-6
    assert torch.equal(got, ttri.tri_gemv_df64(a, x, b, uplo, unit))


def test_tri_gemv_kernel_unaligned_and_poisoned(cuda):
    """Element-wise loads on an unaligned A; NaN outside the triangle and on
    a unit diagonal never reaches the result."""
    n = 777
    a = devgen.gen_f32((n, n), 37, "gemv_a", device=cuda)
    x = devgen.gen_f32((n,), 37, "gemv_x", device=cuda)
    b = devgen.gen_f32((n,), 37, "trsv_b", device=cuda)
    want = ttri.tri_gemv_df64(a, x, b, "upper", True)
    poisoned = torch.where(torch.ones(n, n, dtype=torch.bool, device=cuda).triu(1), a,
                           float("nan"))
    buf = torch.empty(n * n + 1, device=cuda)
    buf[1:] = poisoned.reshape(-1)
    got = ttri.tri_gemv_df64(buf[1:].view(n, n), x, b, "upper", True)
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# the benchmark harness on the card: the draw, SR, the oracle, the drivers
# --------------------------------------------------------------------------

def test_device_draw_equals_numpy_replay(cuda, monkeypatch):
    """The card's int64 draw against its numpy replay, bit for bit, across
    chunk boundaries; the df64 split carries the host master."""
    monkeypatch.setattr(devgen, "CHUNK", 2**20 + 3)
    for shape in ((3_000_001,), (1000, 1237)):
        flat = devgen.gen_f32(shape, 42, "gemv_a", 1, device=cuda).view(-1)
        n = flat.numel()
        for lo, hi in ((0, 2**20), (2**20 - 5, 2**20 + 9), (n - 2**20, n)):
            want = devgen.replay_f32(shape, 42, "gemv_a", 1, lo, hi)
            np.testing.assert_array_equal(flat[lo:hi].cpu().numpy().view(np.uint32),
                                          want.view(np.uint32))
    hi, lo = devgen.split_df64(None, (2**21,), 42, "dot_x", 3, device=cuda)
    m = devgen.master_f64((2**21,), 42, "dot_x", 3)
    np.testing.assert_array_equal(hi.cpu().numpy(), m.astype(np.float32))
    rec = hi.double().cpu().numpy() + lo.double().cpu().numpy()
    assert np.max(np.abs(rec - m) / np.abs(m)) < 2.0**-45


def test_sr_round_device_chunked_2d_on_card(cuda):
    """Chunked SR of a 2-D operand on the card: the flat result reshaped,
    and each chunk replays on the host with the generator's uniforms."""
    from accblas_tpu_torch.utils import sr

    x = devgen.gen_f32((1024, 1000), 5, "gemv_a", device=cuda)
    out = sr.sr_round_device_chunked(x, "f8e4m3", devgen.generator(5, "sr", 0, 0, cuda),
                                     chunk=300_000)
    assert out.shape == x.shape and out.dtype == torch.float8_e4m3fn and out.device == x.device
    flat = sr.sr_round_device_chunked(x.reshape(-1), "f8e4m3",
                                      devgen.generator(5, "sr", 0, 0, cuda), chunk=300_000)
    assert torch.equal(out.view(torch.uint8), flat.view(torch.uint8).reshape(x.shape))
    g = devgen.generator(5, "sr", 0, 0, cuda)
    xs, got = x.reshape(-1), out.reshape(-1).double().cpu().numpy()
    mismatch = 0
    for i0 in range(0, xs.numel(), 300_000):
        chunk = xs[i0 : i0 + 300_000]
        u = torch.rand(chunk.shape, generator=g, device=cuda).double().cpu().numpy()
        want = sr.sr_round(chunk.cpu().numpy(), "f8e4m3", u=u).astype(np.float64)
        mismatch += int(np.sum(got[i0 : i0 + chunk.numel()] != want))
    assert mismatch < 1e-3 * xs.numel()
    # zero-mean: the mean conversion error is far below half a gap
    assert abs(float((out.double() - x.double()).mean())) < 1e-4


def test_oracle_on_card(cuda):
    """The three oracle functions on the card, at the df64 floor against the
    numpy fp64 master."""
    from accblas_tpu_torch.ops import oracle

    n = 2**22
    xh, xl = devgen.split_df64(None, (n,), 42, "dot_x", 0, device=cuda)
    yh, yl = devgen.split_df64(None, (n,), 42, "dot_y", 0, device=cuda)
    ref = devgen.master_f64((n,), 42, "dot_x") @ devgen.master_f64((n,), 42, "dot_y")
    before = tdot.launches
    got = float(tdf.df_to_f64(oracle.dot_df64(xh, xl, yh, yl)))
    assert tdot.launches == before + 3
    assert abs(got - ref) / abs(ref) < 1e-12

    m = 2048
    ah, al = devgen.split_df64(None, (m, m), 42, "gemv_a", 0, device=cuda)
    vh, vl = devgen.split_df64(None, (m,), 42, "gemv_x", 0, device=cuda)
    ref = devgen.master_f64((m, m), 42, "gemv_a") @ devgen.master_f64((m,), 42, "gemv_x")
    g = oracle.gemv_df64(ah, al, vh, vl)
    g64 = (g.hi.double() + g.lo.double()).cpu().numpy()
    assert np.max(np.abs(g64 - ref)) / np.max(np.abs(ref)) < 1e-12

    import scipy.linalg

    lu, _ = scipy.linalg.lu_factor(gen_mtx(MatrixInfo(m, m), seed=42))
    t = np.triu(lu)
    b64 = gen_mtx(MatrixInfo(1, m), seed=43)[0]
    ref = scipy.linalg.solve_triangular(t, b64)
    th = t.astype(np.float32)
    ops = [torch.from_numpy(v).to(cuda) for v in
           (th, (t - th).astype(np.float32), b64.astype(np.float32),
            (b64 - b64.astype(np.float32)).astype(np.float32))]
    before = ttrsv.sweep_launches
    x = oracle.trsv_df64(*ops, "upper", False)
    assert ttrsv.sweep_launches == before + 4
    x64 = (x.hi.double() + x.lo.double()).cpu().numpy()
    assert np.max(np.abs(x64 - ref)) / np.max(np.abs(ref)) < 1e-11


@pytest.mark.parametrize("driver,argv,bounds", [
    ("dot", ["--size=4194304", "--randomizations=1"],
     {"DOT Acc<df64,f32>": 1e-6, "DOT fp32": 1e-5, "DOT df64 oracle (device)": 1e-12}),
    ("gemv", ["--size=1024"],
     {"GEMV Acc<df64,f32>": 5e-7, "GEMV fp32": 1e-5, "GEMV df64 oracle (device)": 1e-12}),
    ("trsv", ["--size=1024", "--no-unit"],
     {"TRSV fp32": 1e-4, "torch TRSV fp32": 1e-4, "TRSV df64 oracle (device)": 1e-11}),
])
def test_driver_rows_on_card(cuda, driver, argv, bounds, capsys, tmp_path, monkeypatch):
    """One speed row and one error row per driver on the card: every speed
    cell positive, every error cell finite, the f32 and df64 tiers and the
    oracle within the JAX driver tests' bounds."""
    import importlib

    monkeypatch.setenv("ACCBLAS_TORCH_CACHE", str(tmp_path))
    mod = importlib.import_module(f"accblas_tpu_torch.bench.{driver}_benchmark")
    for mode in ([], ["--error"]):
        mod.main(argv + ["--sweep=single"] + mode)
        cap = capsys.readouterr()
        header, row = (ln.split(";") for ln in cap.out.strip().splitlines())
        vals = dict(zip(header[1:], map(float, row[1:])))
        assert "FAILED" not in cap.err, cap.err
        if not mode:
            assert "CUDA events" in cap.err
            assert all(v > 0 for v in vals.values()), vals
            continue
        assert all(np.isfinite(v) for v in vals.values()), vals
        for col, bound in bounds.items():
            assert vals[col] < bound, (col, vals[col])


def test_trsv_f32_sweep_error_in_the_plain_class(cuda):
    """On the non-unit LU factor the f32 sweep's error against the fp64
    solve of the master stays within 1.5x the plain version's, which sums
    as the JAX kernel does (a lane's one sequential f32 chain over n / 4
    columns erred 2.5x the plain version at n = 4096)."""
    import scipy.linalg

    from accblas_tpu_torch.utils.compare import relative_error
    from accblas_tpu_torch.utils.memory import lu_factor64

    n = 4096
    lu = lu_factor64(gen_mtx(MatrixInfo(n, n), seed=42), cuda)
    b64 = gen_mtx(MatrixInfo(1, n), seed=43)[0]
    ref = scipy.linalg.solve_triangular(np.triu(lu), b64)
    a = torch.from_numpy(lu.astype(np.float32))
    b = torch.from_numpy(b64.astype(np.float32))
    for k in (1, 3):
        bk = b[:, None].expand(n, k).contiguous()
        got = ttrsv.trsm(a.to(cuda), bk.to(cuda), "upper", False).cpu()
        plain = ttrsv.trsm(a, bk, "upper", False)
        for q in range(k):
            err = relative_error(got[:, q].double().numpy(), ref)
            perr = relative_error(plain[:, q].double().numpy(), ref)
            assert err <= 1.5 * perr, (k, err, perr)
