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
    x = devgen.gen_f32((100_003,), 1, "dot_x", cuda).to(STORAGE[st])
    y = devgen.gen_f32((100_003,), 1, "dot_y", cuda).to(STORAGE[st])
    _run_dot(x, y, tier)


@pytest.mark.parametrize("n", [0, 1, 7, 33, 4096 + 5])
@pytest.mark.parametrize("tier", ["f32", "bf16", "df64_precise"])
def test_dot_kernel_small_and_unaligned(cuda, tier, n):
    base = devgen.gen_f32((n + 1,), 2, "dot_x", cuda).to(torch.bfloat16)
    y = devgen.gen_f32((n,), 2, "dot_y", cuda).to(torch.bfloat16)
    x = base[1:]  # 2 bytes past a 16-byte boundary: the element-wise path
    if n:
        _run_dot(x, y, tier)
    else:
        assert float(_value(tdot.acc_dot(x, y, "f32", init=0.5))) == 0.5


def test_dot_kernel_repeats_its_bits(cuda):
    x = devgen.gen_f32((3_000_001,), 3, "dot_x", cuda)
    y = devgen.gen_f32((3_000_001,), 3, "dot_y", cuda)
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
    a = devgen.gen_f32((m, n), 4, "gemv_a", cuda).to(STORAGE[st])
    x = devgen.gen_f32((n,), 4, "gemv_x", cuda).to(STORAGE[st])
    r = devgen.gen_f32((m,), 4, "gemv_res", cuda)
    _run_gemv(a, x, r, tier, 1.5, 0.5)


@pytest.mark.parametrize("tier", TIERS)
def test_gemv_kernel_beta0_nan_res_and_bf16_out(cuda, tier):
    a = devgen.gen_f32((96, 2048), 5, "gemv_a", cuda).to(torch.bfloat16)
    x = devgen.gen_f32((2048,), 5, "gemv_x", cuda).to(torch.bfloat16)
    nan = torch.full((96,), float("nan"), device=cuda)
    _run_gemv(a, x, nan, tier, 1.0, 0.0)
    rb = devgen.gen_f32((96,), 5, "gemv_res", cuda).to(torch.bfloat16)
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
    a = devgen.gen_f32((m, n), 8, "gemv_a", cuda).to(STORAGE[st])
    buf = devgen.gen_f32((n + x_off,), 8, "gemv_x", cuda).to(STORAGE[st])
    x = buf[x_off:]
    r = devgen.gen_f32((m,), 8, "gemv_res", cuda)
    _run_gemv(a, x, r, tier, 1.5, 0.5)


@pytest.mark.parametrize("tier", TIERS)
def test_gemv_kernel_repeats_its_bits(cuda, tier):
    """20 calls queued on one stream without a synchronisation: every sum
    runs in a fixed order, so each result has the first one's bits."""
    a = devgen.gen_f32((1003, 5000), 9, "gemv_a", cuda).to(torch.bfloat16)
    x = devgen.gen_f32((5000,), 9, "gemv_x", cuda).to(torch.bfloat16)
    r = devgen.gen_f32((1003,), 9, "gemv_res", cuda)
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
    a = devgen.gen_f32((m, n), 6, "gemv_a", cuda)
    x = devgen.gen_f32((n,), 6, "gemv_x", cuda)
    r = devgen.gen_f32((m,), 6, "gemv_res", cuda)
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
    bm = devgen.gen_f32((1000, k), 13, "trsv_b", cuda)
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
    bm = devgen.gen_f32((1000, 5), 47, "trsv_b", cuda)
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
    a = devgen.gen_f32((n, n), 53, "trsv_a", cuda).mul_(1.0 / n)
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
    a = devgen.gen_f32((n, n), 23, "gemv_a", cuda).to(STORAGE[st])
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
    a = devgen.gen_f32((n, n), 31, "gemv_a", cuda).to(STORAGE[st])
    x = devgen.gen_f32((n,), 31, "gemv_x", cuda)
    b = devgen.gen_f32((n,), 31, "trsv_b", cuda)
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
    a = devgen.gen_f32((n, n), 37, "gemv_a", cuda)
    x = devgen.gen_f32((n,), 37, "gemv_x", cuda)
    b = devgen.gen_f32((n,), 37, "trsv_b", cuda)
    want = ttri.tri_gemv_df64(a, x, b, "upper", True)
    poisoned = torch.where(torch.ones(n, n, dtype=torch.bool, device=cuda).triu(1), a,
                           float("nan"))
    buf = torch.empty(n * n + 1, device=cuda)
    buf[1:] = poisoned.reshape(-1)
    got = ttri.tri_gemv_df64(buf[1:].view(n, n), x, b, "upper", True)
    assert torch.equal(got, want)
