"""The port's CUDA kernels against their plain torch versions, on a card.

Every test here is marked `cuda` and skips where torch.cuda.is_available()
is False: a CUDA kernel has no CPU mode. The file imports no JAX, so it also
runs on a GPU machine without it (``--noconftest`` skips the JAX set-up of
tests/conftest.py):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import ctypes

import numpy as np
import pytest
import torch

import accblas_tpu_torch
from accblas_tpu_torch.ops import _build
from accblas_tpu_torch.ops import colsum as tcol
from accblas_tpu_torch.ops import df64 as tdf
from accblas_tpu_torch.ops import dot as tdot
from accblas_tpu_torch.ops import generic as tgen
from accblas_tpu_torch.ops import gemv as tgemv
from accblas_tpu_torch.ops import tri_gemv as ttri
from accblas_tpu_torch.ops import trsv as ttrsv
from accblas_tpu_torch.ops.common import pow2_tree_sum
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
    # a draw of typical conditioning, |x.y + 0.5| = 109 against sqrt(n)/3 =
    # 105: the tiers' bounds are stated for such data (seed 12's draw
    # cancels, see test_dot_kernel_on_a_cancelling_draw)
    x = devgen.gen_f32((100_003,), 4, "dot_x", device=cuda).to(STORAGE[st])
    y = devgen.gen_f32((100_003,), 4, "dot_y", device=cuda).to(STORAGE[st])
    _run_dot(x, y, tier)


def test_dot_kernel_on_a_cancelling_draw(cuda):
    """Seed 12's draw cancels to |x.y + 0.5| = 0.93 (sqrt(n)/3 = 105), where
    the df64-fast tier's f32 product rounding alone is 3.3e-6 of the
    result, above the 5e-7 its bound assumes of typical data (the plain
    version errs the same). The kernel agrees with the plain version within
    that bound, and both stay within 3 x 2^-24 x ||x o y||_2 of float64, the
    rounding of the products; the precise tier keeps its own bound."""
    x = devgen.gen_f32((100_003,), 12, "dot_x", device=cuda)
    y = devgen.gen_f32((100_003,), 12, "dot_y", device=cuda)
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


# ---- the DOT's one launch: the last block's fold, the scratch, the ticket ----

def _dot_blocks(x, y) -> int:
    """The DOT kernel's grid (csrc/dot.cu accblas_dot): one block for each
    256 vector steps of 16 bytes of the wider operand (single elements
    where either operand is not 16-byte aligned), 1 to 1024 blocks."""
    v = 16 // max(x.element_size(), y.element_size())
    aligned = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    work = x.numel() // v if aligned else x.numel()
    return max(1, min(1024, -(-work // 256)))


def _finish_replica(partials, nblocks: int, tier: str, init: float):
    """The former second pass dot_finish's order over the block partials, in
    float32 torch ops that each round (df_add for df64): 1024 threads, t
    holding 0 + partial t (0 past nblocks), a halving shuffle tree in each
    warp of 32, a halving tree over the 32 warp sums, then init. (hi, lo)."""
    p = partials[:2 * nblocks].view(nblocks, 2).cpu()
    pad = torch.zeros(1024 - nblocks)
    zero = torch.zeros(1024)
    if tier.startswith("df64"):
        v = tdf.df_add(tdf.DF(zero, zero), tdf.DF(torch.cat([p[:, 0], pad]),
                                                  torch.cat([p[:, 1], pad])))
        total = pow2_tree_sum(pow2_tree_sum(v.reshape(32, 32), 1))
        out = tdf.df_add(total, tdf.DF(torch.tensor(init), torch.tensor(0.0)))
        return out.hi, out.lo
    total = pow2_tree_sum(pow2_tree_sum((zero + torch.cat([p[:, 0], pad])).view(32, 32), 1))
    if tier == "f32":
        return torch.tensor(init) + total, torch.tensor(0.0)
    dt = STORAGE[tier]
    return (torch.tensor(init).to(dt).float() + total).to(dt).float(), torch.tensor(0.0)


def _dot_and_partials(x, y, tier, init=0.5):
    """(hi, lo) of one kernel call and the block partials it left in the
    current stream's scratch."""
    ar, precise = _ar(tier)
    before = tdot.launches
    out = tdot.acc_dot(x, y, ar, precise=precise, init=init)
    assert tdot.launches == before + 1
    hi, lo = (out.hi, out.lo) if isinstance(out, tdf.DF) else (out, torch.zeros(()))
    torch.cuda.synchronize()
    buf = _build._scratch[(x.get_device(), _build.stream(x))]
    return hi.float().cpu(), lo.cpu(), buf.view(torch.float32)[:2048].clone()


@pytest.mark.parametrize("st", ["f32", "bf16"])
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("n", ["0", "1", "one block", "2^20 + 3", "2^24 + 1"])
def test_dot_one_launch_folds_in_the_finish_order(cuda, n, tier, st):
    """The last block's fold of the partials the kernel left in its scratch
    equals the former dot_finish pass, bit for bit, in every tier: at n = 0
    and 1 (one block), one block's worth of vector steps, 2^20 + 3 (every
    block a partial, a ragged tail) and 2^24 + 1 (1024 blocks of many
    steps). The result within the tier's bound of float64 relative to
    sum |x y| (these draws may cancel: 2^24 + 1 at seed 5 does), for the
    narrow tiers 2^-p log2 n of it (p = 8 for bf16, 11 for f16)."""
    size = {"0": 0, "1": 1, "one block": 256 * (16 // STORAGE[st].itemsize),
            "2^20 + 3": 2**20 + 3, "2^24 + 1": 2**24 + 1}[n]
    x = devgen.gen_f32((size,), 5, "dot_x", device=cuda).to(STORAGE[st])
    y = devgen.gen_f32((size,), 5, "dot_y", device=cuda).to(STORAGE[st])
    hi, lo, partials = _dot_and_partials(x, y, tier)
    rhi, rlo = _finish_replica(partials, _dot_blocks(x, y), tier, 0.5)
    assert torch.equal(hi, rhi) and torch.equal(lo, rlo), (hi, rhi, lo, rlo)
    if size == 0:
        assert float(hi) + float(lo) == 0.5
        return
    p = x.double() * y.double()
    ref, scale = float(p.sum()) + 0.5, float(p.abs().sum()) + 0.5
    bound = tolerance.TOL.get(tier) or {"bf16": 2**-8, "f16": 2**-11}[tier] * np.log2(size + 1)
    assert abs(float(hi.double() + lo.double()) - ref) <= bound * scale


@pytest.mark.parametrize("tier", ["f32", "df64_precise"])
def test_dot_one_launch_unaligned_fold(cuda, tier):
    """x one element past a 16-byte boundary: the element-wise body, its
    grid from single elements; the fold still dot_finish's."""
    base = devgen.gen_f32((300_001,), 6, "dot_x", device=cuda)
    x, y = base[1:], devgen.gen_f32((300_000,), 6, "dot_y", device=cuda)
    hi, lo, partials = _dot_and_partials(x, y, tier)
    assert _dot_blocks(x, y) == 1024
    rhi, rlo = _finish_replica(partials, 1024, tier, 0.5)
    assert torch.equal(hi, rhi) and torch.equal(lo, rlo)


def test_dot_ticket_resets_on_one_and_on_two_streams(cuda):
    """Calls back to back on one stream, of two sizes (1024 blocks and 20)
    and two tiers, then 50 calls on each of two side streams at once: every
    result bit-equal to the first of its kind, so each call's last block
    left its stream's ticket at 0; each stream has its own scratch."""
    big = (devgen.gen_f32((2**20 + 3,), 7, "dot_x", device=cuda),
           devgen.gen_f32((2**20 + 3,), 7, "dot_y", device=cuda))
    small = (big[0][:20_000], big[1][:20_000])
    calls = [lambda: tdot.acc_dot(*big, "f32"), lambda: tdot.acc_dot(*small, "df64"),
             lambda: tdot.acc_dot(*small, "f32"), lambda: tdot.acc_dot(*big, "df64")]

    def bits(out):
        return torch.stack(list(out)) if isinstance(out, tdf.DF) else out.reshape(1)

    first = [bits(c()) for c in calls]
    outs = [bits(calls[i % 4]()) for i in range(100)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, first[i % 4]) for i, o in enumerate(outs))
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    side = [[], []]
    for i in range(50):
        for k, st in enumerate(streams):
            with torch.cuda.stream(st):
                side[k].append(bits(calls[(i + k) % 4]()))
    torch.cuda.synchronize()
    for k in (0, 1):
        assert all(torch.equal(o, first[(i + k) % 4]) for i, o in enumerate(side[k]))
    keys = {(big[0].get_device(), st.cuda_stream) for st in streams}
    assert keys <= set(_build._scratch)
    assert len({_build._scratch[k].data_ptr() for k in keys}) == 2


def test_the_scratch_size_is_the_kernels(cuda):
    """The scratch the wrappers make holds what both libraries that fold
    across blocks in one launch take (csrc/reduce.cuh kScratchBytes)."""
    for lib in ("dot", "generic"):
        assert _build.function(lib, "accblas_scratch_bytes", [])() == _build.SCRATCH_BYTES


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
    before = (tgemv.launches, tgemv.staged_launches)
    got = tgemv.acc_gemv(a, x, r, alpha, beta, ar, precise=precise, df_out=df_out)
    staged = route_of(a, x, tier)
    assert (tgemv.launches, tgemv.staged_launches) == (before[0] + (not staged),
                                                       before[1] + staged)
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


# ---- gemv_staged: A and x stored in f8, x widened once a CTA into shared memory ----

F8 = ("f8e4m3", "f8e5m2")
STAGED_TIERS = ("f32", "df64_fast", "df64_precise")
# the widest n whose staged x fits in a CTA's shared memory (csrc/gemv.cu;
# tests/test_torch_gemv_f8x.py derives it from that file's layout)
STAGED_MAX_N = 46480


def staged_route(n: int, a_st: str, x_st: str, tier: str, aligned: bool = True) -> bool:
    """The kernel csrc/gemv.cu's C entry chooses, as a function of the
    call: gemv_staged (True) for A and x both stored in f8, in the f32 and
    df64 tiers, on the vector steps (A and x 16-byte aligned, n a multiple
    of 16), up to STAGED_MAX_N columns; gemv_rows (False) for every other
    call. _run_gemv holds every GEMV launch of these tests to it."""
    return (a_st in F8 and x_st in F8 and tier in STAGED_TIERS and aligned and n % 16 == 0
            and n <= STAGED_MAX_N)


def route_of(a, x, tier: str) -> bool:
    """staged_route of a call on these tensors."""
    name = {dt: st for st, dt in STORAGE.items()}
    return staged_route(a.shape[1], name[a.dtype], name[x.dtype], tier,
                        (a.data_ptr() | x.data_ptr()) % 16 == 0)


def _routes(a, x, r, tier, alpha=1.5, beta=0.5, df_out=False):
    """The staged and the per-row kernel on the same operands, each forced
    through the wrapper's launch (_gemv_cuda), with its launch counters
    checked."""
    ar, precise = _ar(tier)
    codes = tgemv._codes(a, x, r, _build.tier(ar, precise, "gemv"))
    before = (tgemv.launches, tgemv.staged_launches)
    outs = [tgemv._gemv_cuda(a, x, r, alpha, beta, df_out, codes, force)
            for force in ("staged", "rows")]
    assert (tgemv.launches, tgemv.staged_launches) == (before[0] + 1, before[1] + 1)
    return outs


def _same_bits(u, v) -> bool:
    words = ((u.hi, v.hi), (u.lo, v.lo)) if isinstance(u, tdf.DF) else ((u, v),)
    return all(torch.equal(p.view(torch.int32), q.view(torch.int32)) for p, q in words)


# x's codes: every one (NaN reaches every row), the finite ones, and for
# e5m2 the finite ones with its two infinities
F8_CODES = [(st, keep) for st in F8 for keep in ("every", "finite")] + [("f8e5m2", "not NaN")]


def _f8_codes(st, keep, cuda) -> torch.Tensor:
    """The codes of an f8 storage that `keep` names, then the same codes in
    reverse: each value, subnormals and -0 included, twice over; +0 codes
    after them to a multiple of 16 (gemv_staged's vector steps)."""
    codes = torch.arange(256, dtype=torch.uint8)
    v = codes.view(STORAGE[st]).float()
    codes = codes[{"every": torch.ones(256, dtype=torch.bool), "finite": torch.isfinite(v),
                   "not NaN": ~torch.isnan(v)}[keep]]
    codes = torch.cat([codes, codes.flip(0)])
    codes = torch.cat([codes, codes.new_zeros(-codes.numel() % 16)])
    return codes.view(STORAGE[st]).to(cuda)


@pytest.mark.parametrize("xst", F8)
@pytest.mark.parametrize("ast", F8)
@pytest.mark.parametrize("tier", STAGED_TIERS)
@pytest.mark.parametrize("m,n", [
    # m past a CTA's 16 warps, and more rows a warp than one; the ragged
    # rest of a lane's steps after the unrolled ones (3008 = 188 steps of 16)
    (300, 4096), (5000, 1024), (37, 3008),
])
def test_gemv_staged_equals_per_row_bits(cuda, tier, ast, xst, m, n):
    a = devgen.gen_f32((m, n), 11, "gemv_a", device=cuda).to(STORAGE[ast])
    x = devgen.gen_f32((n,), 11, "gemv_x", device=cuda).to(STORAGE[xst])
    r = devgen.gen_f32((m,), 11, "gemv_res", device=cuda)
    assert route_of(a, x, tier)
    staged, per_row = _routes(a, x, r, tier)
    assert _same_bits(staged, per_row)
    _run_gemv(a, x, r, tier, 1.5, 0.5)


@pytest.mark.parametrize("tier", ["df64_fast", "df64_precise"])
@pytest.mark.parametrize("xst", F8)
def test_gemv_staged_df_out_bits(cuda, tier, xst):
    a = devgen.gen_f32((77, 4096), 12, "gemv_a", device=cuda).to(STORAGE[xst])
    x = devgen.gen_f32((4096,), 12, "gemv_x", device=cuda).to(STORAGE[xst])
    r = devgen.gen_f32((77,), 12, "gemv_res", device=cuda)
    staged, per_row = _routes(a, x, r, tier, 2.0, 0.5, df_out=True)
    assert _same_bits(staged, per_row)


@pytest.mark.parametrize("xst,keep", F8_CODES)
@pytest.mark.parametrize("ast", ["f32", "bf16", "f8"])
@pytest.mark.parametrize("tier", STAGED_TIERS)
def test_gemv_staged_every_f8_code(cuda, tier, ast, xst, keep):
    """x holding every code of its f8 storage, through acc_gemv: the
    plain version's results, NaN and the signed infinities in the same
    rows, and the finite rows within the tier's bound of it and of float64;
    with f8 A (gemv_staged) the bits of gemv_rows too."""
    x = _f8_codes(xst, keep, cuda)
    n = x.shape[0]
    ad = STORAGE[xst if ast == "f8" else ast]
    a = devgen.gen_f32((64, n), 13, "gemv_a", device=cuda).to(ad)
    r = devgen.gen_f32((64,), 13, "gemv_res", device=cuda)
    ar, precise = _ar(tier)
    before = (tgemv.launches, tgemv.staged_launches)
    out = tgemv.acc_gemv(a, x, r, 1.5, 0.5, ar, precise=precise)
    staged = route_of(a, x, tier)
    assert staged == (ast == "f8")
    assert (tgemv.launches, tgemv.staged_launches) == (before[0] + (not staged),
                                                       before[1] + staged)
    if staged:
        assert _same_bits(out, _routes(a, x, r, tier)[1])
    plain = tgemv._gemv_plain(a, x, r, 1.5, 0.5, tier, False)
    got, want = out.double(), plain.double()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    inf = torch.isinf(got)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(got)
    assert bool(fin.all()) if keep == "finite" else not bool(fin.all())
    if fin.any():
        a64, x64 = a.double(), x.double()
        ref = 1.5 * (a64 @ x64) + 0.5 * r.double()
        scale = 1.5 * (a64.abs() @ x64.abs()) + 0.5 * r.double().abs()
        _gemv_check(tier, got[fin], want[fin], ref[fin], scale[fin], torch.float32)


@pytest.mark.parametrize("xst", F8)
def test_gemv_staged_width_edge(cuda, xst):
    """The widest n the C entry stages, and 16 columns past it (the
    per-row kernel), through acc_gemv."""
    for n, staged in ((STAGED_MAX_N, True), (STAGED_MAX_N + 16, False)):
        a = devgen.gen_f32((48, n), 14, "gemv_a", device=cuda).to(torch.float8_e4m3fn)
        x = devgen.gen_f32((n,), 14, "gemv_x", device=cuda).to(STORAGE[xst])
        r = devgen.gen_f32((48,), 14, "gemv_res", device=cuda)
        assert route_of(a, x, "f32") == staged
        _run_gemv(a, x, r, "f32", 1.5, 0.5)


@pytest.mark.parametrize("case", ["past the edge", "bf16 A", "f32 A", "bf16 tier", "f16 tier",
                                  "A one element off", "x one element off",
                                  "n not a multiple of V", "f32 x"])
def test_gemv_staged_refuses_what_it_does_not_take(cuda, case):
    """A call the C entry sends to gemv_rows, forced onto gemv_staged (2
    in bits 16-17 of its codes): an error, nothing launched."""
    n = STAGED_MAX_N + 16 if case == "past the edge" else 1024
    n -= 8 if case == "n not a multiple of V" else 0
    a_off, x_off = int(case == "A one element off"), int(case == "x one element off")
    ad = {"bf16 A": torch.bfloat16, "f32 A": torch.float32}.get(case, torch.float8_e4m3fn)
    abuf = devgen.gen_f32((8 * n + 1,), 15, "gemv_a", device=cuda).to(ad)
    xbuf = devgen.gen_f32((n + 1,), 15, "gemv_x", device=cuda)
    xbuf = xbuf if case == "f32 x" else xbuf.to(torch.float8_e4m3fn)
    a = abuf[a_off:a_off + 8 * n].view(8, n)
    x = xbuf[x_off:x_off + n]
    r = torch.zeros(8, device=cuda)
    tier = {"bf16 tier": "bf16", "f16 tier": "f16"}.get(case, "f32")
    assert not route_of(a, x, tier)
    before = (tgemv.launches, tgemv.staged_launches)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tgemv._gemv_cuda(a, x, r, 1.0, 0.0, False, tgemv._codes(a, x, r, tier), "staged")
    assert (tgemv.launches, tgemv.staged_launches) == before


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


# the kernel each launch span launches, by a part of its name
_LAUNCHED = {"accblas.dot.launch": "dot_reduce", "accblas.gemv.launch": "gemv_rows",
             "accblas.trsv.leaf_gather": "leaf_diag", "accblas.trsv.sweep": "trsv_sweep"}


def _profiled_calls(a, x, calls: int):
    """(host, device) events, (start, end, name) each, of a profile around
    `calls` rounds of acc_dot, acc_gemv and trsv on a card."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            accblas_tpu_torch.acc_dot(x, x, ar="f32")
            accblas_tpu_torch.acc_gemv(a, x, x, ar="f32")
            accblas_tpu_torch.trsv(a, x)
        torch.cuda.synchronize()
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        (host if e.device_type().name == "CPU" else device).append(rec)
    return sorted(host), sorted(device)


def test_launch_spans_on_the_device_trace_clock(cuda):
    """On a card each public call's span holds its launch span (the TRSV's
    its four phases), no span is copied onto the device's timeline, and
    each kernel starts after the start of the span that launched it, one
    kernel a span, in order: the spans share the device trace's clock."""
    n, calls = 1024, 3
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.rand(n, n, device=cuda, generator=g) / n
    x = torch.rand(n, device=cuda, generator=g)
    _profiled_calls(a, x, 1)  # loads the libraries, starts the tracer
    for _ in range(3):  # the profiler drops a device record now and then
        host, device = _profiled_calls(a, x, calls)
        if all(sum(k in d[2] for d in device) == calls for k in _LAUNCHED.values()):
            break
    spans = [h for h in host if h[2].startswith("accblas.")]
    assert not [d for d in device if d[2].startswith("accblas.")]
    for top, kids in (("accblas.dot", ["accblas.dot.launch"]),
                      ("accblas.gemv", ["accblas.gemv.launch"]),
                      ("accblas.trsv", ["accblas.trsv.leaf_gather", "accblas.trsv.leaf_inverse",
                                        "accblas.trsv.panels", "accblas.trsv.sweep"])):
        tops = [s for s in spans if s[2] == top]
        assert len(tops) == calls
        for c in tops:
            assert [s[2] for s in spans if s[2] in kids and c[0] <= s[0] and s[1] <= c[1]] == kids
    for span_name, kernel in _LAUNCHED.items():
        starts = [s[0] for s in spans if s[2] == span_name]
        recs = [d for d in device if kernel in d[2]]
        assert len(recs) == len(starts) == calls, (span_name, len(recs))
        assert all(k[0] > s0 for k, s0 in zip(recs, starts)), span_name


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

def test_device_draw_equals_numpy_replay(cuda):
    """The card's draw kernel against its numpy replay, bit for bit, at the
    ends and inside large draws; the df64 split carries the host master."""
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


@pytest.mark.parametrize("mode,lo,hi", [("f32", -1.0, 1.0), ("df64", -1.0, 1.0),
                                        ("uniform", 0.0, 1.0), ("uniform", -1.0, 1.0)])
def test_draw_kernel_equals_plain_and_replay(cuda, mode, lo, hi):
    """Each mode of the draw kernel against its plain torch version on the
    card and its numpy replay, from a counter that carries past 2^32."""
    from accblas_tpu_torch.ops import draw
    from accblas_tpu_torch.utils import threefry

    ka, kb = threefry.split(threefry.key(17))
    start, n = 2**32 - 2**19, 2**20
    before = draw.launches
    got = draw.draw(mode, ka, kb, (n,), lo, hi, device=cuda, start=start)
    assert draw.launches == before + 1
    plain = draw._draw_plain(mode, ka, kb, start, start + n, lo, hi, cuda)
    want = draw.replay_np(mode, ka, kb, start, start + n, lo, hi)
    pairs = zip(got, plain, want) if mode == "df64" else ((got, plain, want),)
    for g, p, w in pairs:
        assert torch.equal(g.view(torch.int32), p.view(torch.int32))
        np.testing.assert_array_equal(g.cpu().numpy().view(np.uint32), w.view(np.uint32))


def test_sr_round_device_chunked_2d_on_card(cuda):
    """Chunked SR of a 2-D operand on the card: the flat result reshaped,
    bit for bit the CPU's under the same key, and zero-mean."""
    from accblas_tpu_torch.utils import sr, threefry

    x = devgen.gen_f32((1024, 1000), 5, "gemv_a", device=cuda)
    k = threefry.split(devgen.key(5, "sr", 0))[0]
    out = sr.sr_round_device_chunked(x, "f8e4m3", k, chunk=300_000)
    assert out.shape == x.shape and out.dtype == torch.float8_e4m3fn and out.device == x.device
    flat = sr.sr_round_device_chunked(x.reshape(-1), "f8e4m3", k, chunk=300_000)
    assert torch.equal(out.view(torch.uint8), flat.view(torch.uint8).reshape(x.shape))
    host = sr.sr_round_device_chunked(x.cpu(), "f8e4m3", k, chunk=300_000)
    assert torch.equal(out.view(torch.uint8).cpu(), host.view(torch.uint8))
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


# ---- the blocked compositions, their route, and the solvers ----

@pytest.mark.parametrize("ar", ["f32", "df64"])
@pytest.mark.parametrize("k", [1, 64])
@pytest.mark.parametrize("n", [1024, 1664])
def test_composition_on_card_against_its_cpu_run(cuda, n, k, ar):
    """The composition on the card (cuBLAS products in genuine f32) against
    its own run on the CPU on the same operand, and both against float64:
    each within the tier's bound (f32 1e-4, df64 5e-6), the two within
    twice it."""
    lu, _ = _packed_lu(n, 42, cuda)
    bm = devgen.gen_f32((n, k), 7, "trsv_b", device=cuda)
    small = ttrsv._trsm_small_df64 if ar == "df64" else ttrsv._trsv_small
    got = small(lu, bm, "upper", False, "f32")
    cpu = small(lu.cpu(), bm.cpu(), "upper", False, "f32")
    ref = _solve64(lu, bm, "upper", False)
    tol = _trsv_tol(ar, "f32")
    assert torch.isfinite(got).all()
    assert _rel1(got, ref) < tol and _rel1(cpu, ref.cpu()) < tol
    assert _rel1(got.cpu(), cpu) < 2 * tol


@pytest.mark.parametrize("n,k,st,ar", [(16384, 64, "f32", "f32"), (16384, 16, "f32", "f32"),
                                       (4096, 128, "bf16", "f32"), (2048, 64, "f32", "df64")])
def test_resident_none_takes_the_gate_route(cuda, n, k, st, ar):
    """On a CUDA tensor resident=None takes _route's choice: the sweep's two
    kernels launch exactly when the gate says sweep, and the result equals
    the forced route's bit for bit."""
    a = devgen.gen_f32((n, n), 5, "trsv_a", device=cuda).mul_(1.0 / n).to(STORAGE[st])
    bm = devgen.gen_f32((n, k), 5, "trsv_b", device=cuda)
    route = ttrsv._route(n, k, st, ar, "cuda")
    before = ttrsv.sweep_launches
    got = accblas_tpu_torch.acc_trsm(a, bm, "upper", True, ar=ar, unstable_ok=True)
    assert (ttrsv.sweep_launches - before == 1) == (route == "sweep")
    if route == "sweep":
        forced = accblas_tpu_torch.acc_trsm(a, bm, "upper", True, ar=ar, resident=False,
                                            unstable_ok=True)
    else:
        forced = accblas_tpu_torch.acc_trsm(a, bm, "upper", True, ar=ar, resident=True,
                                            unstable_ok=True)
    assert torch.equal(got, forced)


@pytest.mark.parametrize("ar", ["f32", "df64"])
def test_cg_kernels_against_plain_injected(cuda, ar):
    """CG through the DOT and GEMV kernels against CG with their plain
    versions injected (matvec=, dot=) on the same CUDA tensors: x within the
    f32 tier's bound, the same iteration count, and both kernels launched."""
    from accblas_tpu_torch.bench import solvers_benchmark as sb
    from accblas_tpu_torch.models import solvers

    n, iters = 1024, 120
    a, b = sb.spd_system(n, 42, cuda)
    res = torch.empty(n, device=cuda)
    tier = _build.tier(ar, ar == "df64", "dot")
    before = (tdot.launches, tgemv.launches)
    xk, _, itk = solvers.cg(a, b, iters=iters, ar=ar)
    assert tdot.launches > before[0] and tgemv.launches > before[1]
    gtier = _build.tier(ar, False, "gemv")
    xp, _, itp = solvers.cg(
        a, b, iters=iters,
        matvec=lambda p: tgemv._gemv_plain(a, p, res, 1.0, 0.0, gtier, False),
        dot=lambda u, v: tdf.df_to_f32(tdf.DF(*tdot._dot_plain(u, v, tier, 0.0))))
    assert int(itk) == int(itp) == iters
    gap = float((xk.double() - xp.double()).norm() / xp.double().norm())
    assert gap <= tolerance.TOL["f32"], gap
    assert sb.df64_residual(a, b, xk) < 4 * 3.5373781116606202e-06


# --------------------------------------------------------------------------
# the sharded layer (accblas_tpu_torch.parallel) on the card
# --------------------------------------------------------------------------

def _bits(t):
    return t.contiguous().view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def _same_bits(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_same_bits(u, v) for u, v in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def test_sharded_one_rank_nccl_equals_single_card(cuda, tmp_path):
    """On a 1 x 1 mesh over NCCL every sharded op equals its single-card op
    bit for bit: a sum of one term, and a df_sum of one pair, is the
    identity."""
    from accblas_tpu_torch.models import solvers
    from accblas_tpu_torch.parallel import collectives, make_mesh, pcg, pdot, pgemv, ptrsm, ptrsv
    from accblas_tpu_torch.parallel import shard

    collectives.init(0, 1, str(tmp_path), "nccl")
    try:
        mesh = make_mesh()
        assert mesh.transport == "nccl" and not mesh.host_staged
        x = devgen.gen_f32((100_003,), 7, "dot_x", device=cuda)
        y = devgen.gen_f32((100_003,), 7, "dot_y", device=cuda)
        a = devgen.gen_f32((1000, 3000), 7, "gemv_a", device=cuda).to(torch.bfloat16)
        xg = devgen.gen_f32((3000,), 7, "gemv_x", device=cuda).to(torch.bfloat16)
        rg = devgen.gen_f32((1000,), 7, "gemv_res", device=cuda)
        t = devgen.gen_f32((1000, 1000), 7, "trsv_a", device=cuda) / 1000
        bt = torch.ones(1000, device=cuda)
        bm = devgen.gen_f32((1000, 8), 7, "trsv_b", device=cuda)
        m = devgen.gen_f32((512, 512), 7, "gemv_a", device=cuda)
        spd = m @ m.T / 512 + 2 * torch.eye(512, device=cuda)
        pairs = [
            (pdot(x, y, mesh, ar="f32"), accblas_tpu_torch.acc_dot(x, y, ar="f32")),
            (pdot(x, y, mesh, ar="df64", precise=True),
             accblas_tpu_torch.acc_dot(x, y, ar="df64", precise=True)),
            (pgemv(a, xg, rg, 1.5, 0.5, ar="f32", mesh=mesh),
             accblas_tpu_torch.acc_gemv(a, xg, rg, 1.5, 0.5, ar="f32")),
            (pgemv(a, xg, rg, 1.5, 0.5, ar="df64", mesh=mesh),
             accblas_tpu_torch.acc_gemv(a, xg, rg, 1.5, 0.5, ar="df64")),
            (ptrsv(shard(t, mesh, ("rows", None), identity_tail=True), bt, mesh=mesh),
             accblas_tpu_torch.acc_trsv(t, bt)),
            (ptrsm(t, bm, mesh=mesh), accblas_tpu_torch.acc_trsm(t, bm)),
            (pcg(spd, bt[:512], mesh=mesh, iters=40, ar="df64"),
             solvers.cg(spd, bt[:512], iters=40, ar="df64")),
        ]
        for i, (got, want) in enumerate(pairs):
            assert _same_bits(got, want), i
    finally:
        collectives.shutdown()


def test_sharded_four_ranks_share_one_card(cuda):
    """4 ranks on one card over gloo, host-staged (NCCL refuses two ranks on
    one GPU): the kernels run on the card, the results meet the JAX tests'
    bounds against float64."""
    import scipy.linalg

    from accblas_tpu_torch.parallel import launch
    from accblas_tpu_torch.parallel.launch import Call, Sharded

    p = "accblas_tpu_torch.parallel.blas:"
    rng = np.random.default_rng(7)
    n = 8192
    x = (np.repeat([1.0, -1.0], n // 2) / 32.0 + rng.uniform(-1, 1, n) * 1e-2).astype(np.float32)
    ones = np.ones(n, np.float32)
    a = gen_mtx(MatrixInfo(300, 1001), seed=3).astype(np.float32)
    xv = gen_mtx(MatrixInfo(1, 1001), seed=4)[0].astype(np.float32)
    r = gen_mtx(MatrixInfo(1, 300), seed=5)[0].astype(np.float32)
    t = (np.triu(gen_mtx(MatrixInfo(777, 777), seed=6)) / 777 + np.eye(777)).astype(np.float32)
    b = gen_mtx(MatrixInfo(1, 777), seed=8)[0].astype(np.float32)
    calls = [
        Call(p + "pdot", (Sharded(x, ("cols",)), Sharded(ones, ("cols",))),
             {"ar": "df64", "precise": True}),
        Call(p + "pgemv", (Sharded(a, ("rows", "cols")), Sharded(xv, ("cols",)),
                           Sharded(r, ("rows",)), 1.5, -0.5), {"ar": "df64"},
             out=((("rows",), (300,)),)),
        Call(p + "ptrsv", (Sharded(t, ("rows", None), identity_tail=True), Sharded(b, ("rows",)),
                           "upper", False), {}, out=((("rows",), (777,)),)),
    ]
    res = launch.run(launch.apply, 4, calls, "cuda", device="cuda", timeout=300)[0]
    dot, gv, tv = (c["values"][0] for c in res)
    ref = float(x.astype(np.float64).sum())
    assert abs(float(dot) - ref) / abs(ref) < 1e-12
    gref = 1.5 * a.astype(np.float64) @ xv - 0.5 * r
    assert np.abs(gv - gref).sum() / np.abs(gref).sum() < 3e-6
    tref = scipy.linalg.solve_triangular(t.astype(np.float64), b)
    assert np.abs(tv - tref).sum() / np.abs(tref).sum() < 3e-5


# ---- the generic kernels, written once against the device Range ----

GENERIC_PAIRS = [("f32", "f32"), ("bf16", "f32"), ("f32", "df64")]


def _draw(shape, role, st, device, seed=11):
    return devgen.gen_f32(shape, seed, role, device=device).to(STORAGE[st])


@pytest.mark.parametrize("st,ar", GENERIC_PAIRS)
@pytest.mark.parametrize("rows,cols", [(1, 1), (64, 256), (37, 301), (3, 70_001)])
def test_generic_axpy_kernel(cuda, rows, cols, st, ar):
    """The kernel against its plain version, bit for bit (one rounding per
    element, the same operations), on dense rows and on a window of a wider
    parent (row stride 2 cols + 5, at column 3)."""
    x = _draw((rows, cols), "generic_x", st, cuda)
    y = _draw((rows, 2 * cols + 5), "generic_y", st, cuda)[:, 3:cols + 3]
    before = tgen.axpy_launches
    got = tgen.axpy(x, y, ar, "f32")
    assert tgen.axpy_launches == before + 1
    assert torch.equal(got, tgen._axpy_plain(x, y, ar, "f32", 2.0))
    ref = 2.0 * x.double() + y.double()
    assert float((got.double() - ref).abs().max()) <= float(ref.abs().max()) * 2**-23


@pytest.mark.parametrize("out_st", list(STORAGE))
@pytest.mark.parametrize("st,ar", GENERIC_PAIRS)
def test_generic_axpy_both_instantiations(cuda, st, ar, out_st):
    """The vector body (rows at a multiple of V: 16-byte reads, V-wide
    evict-first stores of every output storage) on rows spanning whole
    tiles and a ragged last one; the V = 1 body on the window one column on
    and on an odd row stride: each bit-equal to the plain version."""
    v = tgen.vector_width(STORAGE[st], ar)
    rows, cols = 5, 16_408  # a multiple of 8 columns: two f32 tiles and 24 more
    xp = _draw((rows, cols + 8), "generic_x", st, cuda)
    yp = _draw((rows, cols + 8), "generic_y", st, cuda)
    odd = (_draw((rows, 4099), "generic_x", st, cuda), _draw((rows, 4099), "generic_y", st, cuda))
    for x, y, want in ((xp[:, :cols], yp[:, :cols], v), (xp[:, 1:cols], yp[:, 1:cols], 1),
                       (*odd, 1)):
        before = tgen.axpy_launches
        got = tgen.axpy(x, y, ar, out_st, alpha=-0.75)
        assert tgen.axpy_launches == before + 1
        assert tgen.axpy_vector(x, y, got, ar) == want
        assert got.dtype == STORAGE[out_st]
        assert torch.equal(got.float(), tgen._axpy_plain(x, y, ar, out_st, -0.75).float())


@pytest.mark.parametrize("out_st", list(STORAGE))
def test_generic_axpy_kernel_every_output_storage(cuda, out_st):
    x = _draw((33, 129), "generic_x", "f32", cuda)
    y = _draw((33, 129), "generic_y", "f32", cuda)
    for ar in ("f32", "df64"):
        got = tgen.axpy(x, y, ar, out_st, alpha=-0.75)
        assert got.dtype == STORAGE[out_st]
        assert torch.equal(got.float(), tgen._axpy_plain(x, y, ar, out_st, -0.75).float())


@pytest.mark.parametrize("st,ar", GENERIC_PAIRS)
@pytest.mark.parametrize("m,n", [(1, 1), (5, 3), (64, 256), (37, 300), (300, 1025),
                                 (4, 65_537)])
def test_generic_gemv_kernel(cuda, m, n, st, ar):
    """_reduce_last's order zero-padded, the same in kernel and plain
    version: bit for bit at every (m, n), ragged ones too; within the JAX
    test's bound of float64 on the stored values."""
    a = _draw((m, n), "generic_a", st, cuda)
    x = _draw((n,), "generic_xv", st, cuda)
    r = _draw((m,), "generic_r", "f32", cuda)
    before = tgen.gemv_launches
    got = tgen.gemv_generic(a, x, r, ar, "f32")
    assert tgen.gemv_launches == before + 1
    assert torch.equal(got, tgen._gemv_generic_plain(a, x, r, ar, "f32", 1.5, -0.5))
    ref = 1.5 * (a.double() @ x.double()) - 0.5 * r.double()
    scale = 1.5 * (a.double().abs() @ x.double().abs()) + 0.5 * r.double().abs()
    bound = 2e-6 if ar == "df64" else 2**-24 * (np.log2(max(n, 2)) + 3)
    assert float(((got[:, 0].double() - ref).abs() / scale).max()) <= bound


@pytest.mark.parametrize("st,ar", GENERIC_PAIRS)
@pytest.mark.parametrize("shape,window", [
    ((16, 256), (8, 128, 8, 128)),
    ((37, 301), (5, 9, 13, 77)),
    ((9, 11), (4, 7, 1, 1)),
    ((1000, 3001), (3, 5, 997, 2990)),
    ((4096, 4096), (0, 0, 4096, 4096)),
])
def test_window_sum_kernel(cuda, shape, window, st, ar):
    """Block partials folded by the last block, one launch, in the plain
    version's order: bit for bit, at odd offsets and strides and a (1, 1)
    window."""
    parent = _draw(shape, "generic_w", st, cuda)
    before = tgen.window_launches
    got = tgen.window_sum(parent, *window, ar)
    assert tgen.window_launches == before + 1
    assert torch.equal(got, tgen._window_sum_plain(parent, *window, ar))
    row0, col0, m, n = window
    w = parent[row0:row0 + m, col0:col0 + n].double()
    depth = np.log2(max(m * n, 2)) + 2
    bound = 2**-24 * (1 if ar == "df64" else depth) * float(w.abs().sum())
    assert abs(float(got) - float(w.sum())) <= bound


def _gemv_case(a, x, ar, v):
    r = _draw((a.shape[0],), "generic_r", "f32", a.device)
    assert tgen.gemv_vector(a, x, ar) == v
    before = tgen.gemv_launches
    got = tgen.gemv_generic(a, x, r, ar, "f32")
    assert tgen.gemv_launches == before + 1
    assert torch.equal(got, tgen._gemv_generic_plain(a, x, r, ar, "f32", 1.5, -0.5))


@pytest.mark.parametrize("st,ar", GENERIC_PAIRS)
@pytest.mark.parametrize("n", [4 * 32 - 1, 4 * 32 + 1, 8 * 32 - 1, 8 * 32 + 1, 16_384])
def test_generic_gemv_both_instantiations(cuda, n, st, ar):
    """The vector instantiation (rows at a stride that is a multiple of V)
    and the V = 1 one (A one element off, an odd stride, x one element off)
    on the same values: each bit-equal to the plain version."""
    v = tgen.vector_width(STORAGE[st], ar)
    m = 40
    wide = _draw((m, n + 31 - (n + 23) % 8), "generic_a", st, cuda)  # a multiple of 8 columns
    xbuf = _draw((n + 8,), "generic_xv", st, cuda)
    _gemv_case(wide[:, 8:n + 8], xbuf[8:], ar, v)      # 16-byte aligned rows
    _gemv_case(wide[:, 1:n + 1], xbuf[8:], ar, 1)      # one element off
    _gemv_case(wide[:, 8:n + 8], xbuf[1:n + 1], ar, 1)  # x one element off
    odd = _draw((m, n), "generic_a", st, cuda)          # stride n, odd
    _gemv_case(odd, xbuf[8:], ar, 1 if m > 1 and n % v else v)


@pytest.mark.parametrize("st,ar", GENERIC_PAIRS)
def test_generic_gemv_at_stride_16385(cuda, st, ar):
    """a[:, 1:] of a (m, 16385) parent: row stride 16385, unaligned, the V = 1
    instantiation; its aligned copy takes the vector one; the same bits."""
    parent = _draw((64, 16_385), "generic_a", st, cuda)
    x = _draw((16_384,), "generic_xv", st, cuda)
    _gemv_case(parent[:, 1:], x, ar, 1)
    _gemv_case(parent[:, 1:].contiguous(), x, ar, tgen.vector_width(STORAGE[st], ar))


@pytest.mark.parametrize("st,ar", GENERIC_PAIRS)
@pytest.mark.parametrize("window", [(3, 16, 300, 2000), (3, 17, 300, 2000), (0, 8, 1, 7),
                                    (5, 24, 1000, 4 * 32 + 1)])
def test_window_sum_both_instantiations(cuda, window, st, ar):
    """A window at a column that is a multiple of V (the vector
    instantiation) and one at an odd column (V = 1): bit-equal to the plain
    version; the parent's row stride 2056 is a multiple of every V."""
    parent = _draw((1100, 2056), "generic_w", st, cuda)
    row0, col0, m, n = window
    v = tgen.vector_width(STORAGE[st], ar) if col0 % tgen.vector_width(STORAGE[st], ar) == 0 else 1
    assert tgen.window_vector(parent, *window, ar) == v
    got = tgen.window_sum(parent, *window, ar)
    assert torch.equal(got, tgen._window_sum_plain(parent, *window, ar))


@pytest.mark.parametrize("ar", ["f32", "df64"])
def test_window_sum_resets_its_ticket(cuda, ar):
    """100 window sums back to back on one stream, vector and V = 1, every
    result bit-equal: the last block of each call leaves the ticket counter
    at 0 for the next."""
    parent = _draw((2048, 4104), "generic_w", "f32", cuda)
    calls = [(1, 8, 2000, 4000), (1, 9, 2000, 4000), (0, 0, 2048, 4096)]
    first = [tgen.window_sum(parent, *w, ar) for w in calls]
    outs = [tgen.window_sum(parent, *calls[i % 3], ar) for i in range(100)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, first[i % 3]) for i, o in enumerate(outs))
    assert torch.equal(first[0], tgen._window_sum_plain(parent, *calls[0], ar))


def test_generic_kernels_repeat_their_bits(cuda):
    a = _draw((512, 4099), "generic_a", "f32", cuda)
    x = _draw((4099,), "generic_xv", "f32", cuda)
    r = _draw((512,), "generic_r", "f32", cuda)
    for ar in ("f32", "df64"):
        first = tgen.gemv_generic(a, x, r, ar, "f32")
        w1 = tgen.window_sum(a, 1, 2, 500, 4000, ar)
        for _ in range(3):
            assert torch.equal(first, tgen.gemv_generic(a, x, r, ar, "f32"))
            assert torch.equal(w1, tgen.window_sum(a, 1, 2, 500, 4000, ar))


def test_a_const_range_does_not_compile_a_store(cuda, tmp_path):
    """nvcc refuses a store through a Range over const storage, the scalar
    r(i, j) = v and the vector row.store<V> and row.store_stream<V>, and
    accepts the same stores through a writable one."""
    import subprocess

    bodies = {
        "scalar": "__global__ void k(range_t<DF, %s float> r) { r(0, 0) = r(0, 1) * 2.0f; }",
        # the vector stores: 8 bf16 values from 8 f32 ones
        "store": "__global__ void k(range_t<float, %s __nv_bfloat16> r) "
                 "{ float v[8]; r.row(0).load(8, v); r.row(0).store(0, v); }",
        "store_stream": "__global__ void k(range_t<float, %s __nv_bfloat16> r) "
                        "{ float v[8]; r.row(0).load(8, v); r.row(0).store_stream(0, v); }",
    }
    results = {}
    for const in ("", "const"):
        for kind, body in bodies.items():
            f = tmp_path / f"k{const}{kind}.cu"
            f.write_text('#include "range.cuh"\nusing namespace accblas;\n' + body % const + "\n")
            cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                   "-I", str(_build._CSRC), "-c", "-o", str(tmp_path / "k.o"), str(f)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            results[const, kind] = (proc.returncode, proc.stdout + proc.stderr)
    for kind in bodies:
        assert results["", kind][0] == 0, results["", kind][1]
        code, out = results["const", kind]
        assert code != 0 and "store through a const Range" in out, out


# ---- the fuzz sweep of tests/test_fuzz.py, kernel against plain version ----

def fuzz_cases():
    """tests/test_fuzz.py's case lists, drawn from the same seeded Philox
    stream in the same order (tests/test_torch_fuzz.py checks that they
    equal the JAX module's): this file imports no JAX."""
    rng = np.random.Generator(np.random.Philox(20260818))
    dot = [(int(rng.integers(129, 70_000)), st, ar)
           for st in ("f32", "bf16") for ar in ("f32", "df64") for _ in range(3)]
    gemv = [(int(rng.integers(8, 900)), int(rng.integers(9, 900)), st, ar)
            for st in ("f32", "bf16") for ar in ("f32", "df64") for _ in range(3)]
    trsv = [(int(rng.integers(64, 1200)), rng.choice(["upper", "lower"]),
             bool(rng.integers(0, 2)), int(rng.choice([0, 0, 1, 5])), ar)
            for ar in ("f32", "df64") for _ in range(6)]
    narrow = [(int(rng.integers(40, 5000)), st) for st in ("f16", "f8e4m3") for _ in range(3)]
    gemv_narrow = [(int(rng.integers(4, 700)), int(rng.integers(9, 700)), st)
                   for st in ("f16", "f8e4m3") for _ in range(3)]
    return {"dot": dot, "gemv": gemv, "trsv": trsv, "dot_narrow": narrow,
            "gemv_narrow": gemv_narrow}


FUZZ = fuzz_cases()


@pytest.mark.parametrize("n,st", [c[:2] for c in FUZZ["dot"][::2]] + FUZZ["dot_narrow"])
@pytest.mark.parametrize("tier", ["f32", "df64_fast", "df64_precise"])
def test_fuzz_dot_kernel(cuda, n, st, tier):
    """Kernel and plain version against float64 on the stored values,
    relative to sum |x y| as tests/test_fuzz.py measures (a random dot can
    cancel): within the f32 floor 3e-5, or 3e-6 for df64, of it and of each
    other."""
    x = devgen.gen_f32((n,), n, "dot_x", device=cuda).to(STORAGE[st])
    y = devgen.gen_f32((n,), n + 1, "dot_y", device=cuda).to(STORAGE[st])
    ar, precise = _ar(tier)
    before = tdot.launches
    got = float(_value(tdot.acc_dot(x, y, ar, precise=precise)))
    assert tdot.launches == before + 1
    hi, lo = tdot._dot_plain(x, y, tier, 0.0)
    plain = float(hi.double() + lo.double())
    p = x.double() * y.double()
    ref, scale = float(p.sum()), float(p.abs().sum())
    floor = 3e-6 if ar == "df64" else 3e-5
    assert abs(got - ref) / scale < floor and abs(plain - ref) / scale < floor
    assert abs(got - plain) / scale < floor


@pytest.mark.parametrize("m,n,st", [c[:3] for c in FUZZ["gemv"][::2]] + FUZZ["gemv_narrow"])
@pytest.mark.parametrize("tier", ["f32", "df64_fast", "df64_precise"])
def test_fuzz_gemv_kernel(cuda, m, n, st, tier):
    a = devgen.gen_f32((m, n), m * 1000 + n, "gemv_a", device=cuda).to(STORAGE[st])
    x = devgen.gen_f32((n,), n, "gemv_x", device=cuda).to(STORAGE[st])
    r = devgen.gen_f32((m,), m, "gemv_res", device=cuda)
    _run_gemv(a, x, r, tier, 1.0, 1.0)


def _fuzz_trsv_operand(n, uplo, unit, nrhs, device):
    """tests/test_fuzz.py's operands: the unit solve on gen_mtx / n, the
    non-unit one on the LU factor of a diagonally dominant matrix."""
    import scipy.linalg

    if unit:
        lu = gen_mtx(MatrixInfo(n, n), seed=n) / n
    else:
        lu, _ = scipy.linalg.lu_factor(gen_mtx(MatrixInfo(n, n), seed=n) + np.eye(n) * (0.25 * n))
    b64 = gen_mtx(MatrixInfo(max(nrhs, 1), n), seed=n + 7)
    b = b64[0] if nrhs == 0 else b64.T
    return (interop.from_numpy(lu.astype(np.float32), device=device),
            interop.from_numpy(np.ascontiguousarray(b, np.float32), device=device))


@pytest.mark.parametrize("n,uplo,unit,nrhs,ar", FUZZ["trsv"])
def test_fuzz_trsv_kernel(cuda, n, uplo, unit, nrhs, ar):
    a, b = _fuzz_trsv_operand(n, str(uplo), unit, nrhs, cuda)
    _run_trsv(a, b, str(uplo), unit, ar, 3e-5 if ar == "f32" else 5e-6)


@pytest.mark.parametrize("resident", [True, False, None])
@pytest.mark.parametrize("n,uplo,unit,nrhs,ar", [c for c in FUZZ["trsv"] if c[3] == 5][:3])
def test_fuzz_trsm_every_resident(cuda, n, uplo, unit, nrhs, ar, resident):
    """The fuzz solves on every route: within the fuzz floor of float64 and,
    with resident=None, bit for bit the route _route names. df64 has no
    composed resident mode: resident=True raises."""
    a, b = _fuzz_trsv_operand(n, str(uplo), unit, nrhs, cuda)
    fn = accblas_tpu_torch.acc_trsm
    if ar == "df64" and resident is True:
        with pytest.raises(ValueError):
            fn(a, b, str(uplo), unit, ar=ar, resident=True, unstable_ok=True)
        return
    got = fn(a, b, str(uplo), unit, ar=ar, resident=resident, unstable_ok=True)
    assert _rel1(got, _solve64(a, b, str(uplo), unit)) < (3e-5 if ar == "f32" else 5e-6)
    if resident is None:
        forced = ttrsv._route(n, b.shape[1], "f32", ar, "cuda") == "composition"
        assert torch.equal(got, fn(a, b, str(uplo), unit, ar=ar, resident=forced,
                                   unstable_ok=True))


@pytest.mark.parametrize("n,k,route", [
    (11585, 64, "sweep"),        # n^2 k just under 128 * 8192^2
    (11586, 64, "composition"),  # just over
    (16384, 63, "sweep"),        # k just under 64
    (16384, 64, "composition"),
])
def test_route_gate_edges(cuda, n, k, route):
    """The CUDA gate's edges (ops/trsv.py _route: k >= 64 and n^2 k >=
    128 * 8192^2): resident=None launches the sweep exactly on the sweep
    side, and its result equals the forced route's."""
    assert ttrsv._route(n, k, "f32", "f32", "cuda") == route
    a = devgen.gen_f32((n, n), 5, "trsv_a", device=cuda).mul_(1.0 / n)
    bm = devgen.gen_f32((n, k), 5, "trsv_b", device=cuda)
    before = ttrsv.sweep_launches
    got = accblas_tpu_torch.acc_trsm(a, bm, "upper", True, ar="f32", unstable_ok=True)
    assert (ttrsv.sweep_launches - before == 1) == (route == "sweep")
    forced = accblas_tpu_torch.acc_trsm(a, bm, "upper", True, ar="f32",
                                        resident=route == "composition", unstable_ok=True)
    assert torch.equal(got, forced)


# ---- the column sums (csrc/colsum.cu), the f8 probe's convert stream ----

COLSUM_SHAPES = [(1, 1), (1, 16), (5, 48), (300, 1024), (257, 4097), (4097, 4112), (4097, 4113)]


def _colsum_operand(m, n, st, offset, device):
    """An (m, n) contiguous matrix of storage st whose base sits `offset`
    elements past the start of a flat draw (16-byte aligned at offset 0)."""
    flat = _draw((m * n + 1,), "colsum_a", st, device)
    return flat[offset:offset + m * n].view(m, n)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("m,n", COLSUM_SHAPES)
@pytest.mark.parametrize("st", list(STORAGE))
def test_colsum_kernel(cuda, st, m, n, offset):
    """Both instantiations (16-byte loads; element loads where a row is not
    16-byte aligned) against the plain version bit for bit, at the default
    chunk and at 3 and 1024 rows, and against float64 within (d + 1) 2^-24
    of the column's sum of magnitudes."""
    from accblas_tpu_torch.bench.probe_r4a import colsum_bound

    a = _colsum_operand(m, n, st, offset, cuda)
    es = a.element_size()
    assert tcol.vector_path(a) == (offset == 0 and n * es % 16 == 0)
    a64 = a.double()
    ref, scale = a64.sum(0), a64.abs().sum(0).clamp_min(1e-300)
    for rows in (None, 3, 1024):
        before = tcol.launches
        got = tcol.col_sums(a, rows)
        assert tcol.launches == before + 2
        assert got.shape == (1, n) and got.dtype == torch.float32
        assert torch.equal(got, tcol._col_sums_plain(a, rows))
        err = float(((got.double()[0] - ref).abs() / scale).max())
        assert err <= colsum_bound(m, rows or tcol.ROWS_PER_BLOCK), (rows, err)


@pytest.mark.parametrize("offset", [0, 1])
def test_colsum_kernel_repeats_its_bits(cuda, offset):
    a = _colsum_operand(3000, 2048, "f32", offset, cuda)
    first = tcol.col_sums(a)
    for _ in range(20):
        assert torch.equal(first, tcol.col_sums(a))
    torch.cuda.synchronize()


def test_colsum_kernel_refuses_what_it_does_not_take(cuda):
    a = _draw((64, 48), "colsum_a", "f8e4m3", cuda)
    before = tcol.launches
    for bad in (a.t(), a[:, :40], a[::2]):
        with pytest.raises(ValueError, match="contiguous"):
            tcol.col_sums(bad)
    with pytest.raises(ValueError):
        tcol.col_sums(a.double())
    assert tcol.launches == before
    assert torch.equal(tcol.col_sums(a[:0]), torch.zeros(1, 48, device=cuda))
    assert tcol.launches == before
