"""The port's generic kernels (accblas_tpu_torch.ops.generic: AXPY, GEMV and
the strided-window sum, each written once against Range) against the JAX
package's Pallas kernels of tests/test_generic_kernel.py and
tests/test_accessor.py, in interpret mode, on the JAX tests' inputs (gen_mtx
seeds 1, 2 and 5-7 at 64x256), and against float64.

Bit equality holds under the test configuration (tests/conftest.py: XLA:CPU
at backend optimisation level 0, no contraction of a multiply and an add).
At XLA:CPU's default level LLVM contracts the GEMV epilogue val*alpha +
r*beta into one fused multiply-add, which moves 11 of the 64 f32-tier rows
by up to 1.9e-6; the TPU kernel contracts nothing, and neither does the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import jax
from accblas_tpu import Range as JaxRange
from accblas_tpu import ReducedRowMajor as JaxSpec
from accblas_tpu.ops.common import interpret_default
from accblas_tpu.ops.df64 import DF as JaxDF
from accblas_tpu.utils import MatrixInfo, gen_mtx
from accblas_tpu_torch.accessor.range import Range, ReducedRowMajor
from accblas_tpu_torch.ops import generic
from accblas_tpu_torch.ops.common import pow2_tree_sum
from accblas_tpu_torch.ops.df64 import DF
from test_generic_kernel import _reduce_last
from test_generic_kernel import axpy as jax_axpy
from test_generic_kernel import gemv_generic as jax_gemv_generic

torch.set_num_threads(1)

# (storage, arithmetic): the JAX tests' three pairings
PAIRS = [("f32", "f32"), ("bf16", "f32"), ("f32", "df64")]
_JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}

# float64 bounds: the JAX tests' (rtol = atol), per pairing
AXPY_TOL = {("f32", "f32"): (1e-6, 1e-6), ("bf16", "f32"): (2e-2, 3e-2),
            ("f32", "df64"): (1e-6, 1e-6)}
GEMV_TOL = {("f32", "f32"): 2e-5, ("bf16", "f32"): 5e-2, ("f32", "df64"): 2e-6}


def _both(v64, st):
    """The same stored values as a JAX array and a torch tensor."""
    j = jnp.asarray(np.asarray(v64, np.float32)).astype(_JNP[st])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(_TORCH[st])


def _f64(t) -> np.ndarray:
    return t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------- DF slicing

def test_df_slices_and_folds_like_the_jax_df():
    """DF indexing and reshape act on both words, so the JAX test's own
    _reduce_last folds a port DF row, bit for bit as it folds a JAX DF."""
    rng = np.random.default_rng(3)
    hi = rng.standard_normal((4, 64)).astype(np.float32)
    lo = (hi * rng.uniform(-2**-25, 2**-25, hi.shape)).astype(np.float32)
    got = _reduce_last(DF(torch.from_numpy(hi), torch.from_numpy(lo)))
    want = _reduce_last(JaxDF(jnp.asarray(hi), jnp.asarray(lo)))
    assert isinstance(got, DF) and got.shape == (4, 1)
    np.testing.assert_array_equal(_bits(got.hi), _bits(want.hi))
    np.testing.assert_array_equal(_bits(got.lo), _bits(want.lo))
    d = DF(torch.from_numpy(hi), torch.from_numpy(lo))
    assert d.ndim == 2 and d.reshape(256).shape == (256,) and d[1].shape == (64,)
    assert torch.equal(d[..., 3:5].lo, torch.from_numpy(lo[:, 3:5]))
    h, lw = d  # unpacking still gives the words
    assert h is d.hi and lw is d.lo


# ---------------------------------------------------------------- AXPY

@pytest.mark.parametrize("st,ar", PAIRS)
def test_axpy_equals_the_jax_kernel(st, ar):
    m = gen_mtx(MatrixInfo(64, 256), seed=1)
    v = gen_mtx(MatrixInfo(64, 256), seed=2)
    (xj, xt), (yj, yt) = _both(m, st), _both(v, st)
    got = generic.axpy(xt, yt, ar, "f32")
    want = jax_axpy(xj, yj, ar, "f32")
    assert got.dtype == torch.float32 and got.shape == (64, 256)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    rtol, atol = AXPY_TOL[(st, ar)]
    np.testing.assert_allclose(_f64(got), 2.0 * m + v, rtol=rtol, atol=atol)


@pytest.mark.parametrize("out_st", ["bf16", "f16", "f8e4m3"])
def test_axpy_stores_through_the_output_range(out_st):
    """The output's storage type rounds once, at the store: the df64 sum
    rounded to f32, then to out_st (round to nearest even)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(-1, 1, (7, 33)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-1, 1, (7, 33)).astype(np.float32))
    got = generic.axpy(x, y, "df64", out_st, alpha=1.5)
    dt = {"bf16": torch.bfloat16, "f16": torch.float16, "f8e4m3": torch.float8_e4m3fn}[out_st]
    want = (x.double() * 1.5 + y.double()).float().to(dt)
    assert got.dtype == dt
    assert torch.equal(got.float(), want.float())


# ---------------------------------------------------------------- GEMV

def _gemv_inputs(m, n, st):
    a64 = gen_mtx(MatrixInfo(m, n), seed=5)
    x64 = gen_mtx(MatrixInfo(1, n), seed=6)[0]
    r64 = gen_mtx(MatrixInfo(1, m), seed=7)[0]
    return a64, x64, r64, _both(a64, st), _both(x64, st), _both(r64, "f32")


@pytest.mark.parametrize("st,ar", PAIRS)
def test_gemv_generic_equals_the_jax_kernel(st, ar):
    a64, x64, r64, (aj, at), (xj, xt), (rj, rt) = _gemv_inputs(64, 256, st)
    got = generic.gemv_generic(at, xt, rt, ar, "f32")
    want = jax_gemv_generic(aj, xj, rj, ar, "f32")
    assert got.dtype == torch.float32 and got.shape == (64, 1)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    tol = GEMV_TOL[(st, ar)]
    ref = (1.5 * a64 @ x64 - 0.5 * r64).reshape(64, 1)
    np.testing.assert_allclose(_f64(got), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("st,ar", PAIRS)
@pytest.mark.parametrize("m,n", [(37, 300), (5, 1), (64, 75), (3, 1025)])
def test_gemv_generic_ragged_against_float64(m, n, st, ar):
    """At a width that is no power of two the port folds as if zero-padded;
    the JAX helper _reduce_last drops columns there (75 -> 37 loses one),
    so the port is held to float64 alone, on the stored values."""
    a64, x64, r64, (_, at), (_, xt), (_, rt) = _gemv_inputs(m, n, st)
    got = generic.gemv_generic(at, xt, rt, ar, "f32", alpha=1.5, beta=-0.5)
    ref = 1.5 * _f64(at) @ _f64(xt) - 0.5 * _f64(rt)
    tol = GEMV_TOL[("f32", ar)]  # the stored values: no storage error left
    np.testing.assert_allclose(_f64(got)[:, 0], ref, rtol=tol, atol=tol)
    if ar == "df64" and st == "f32":
        # one rounding to f32 at the store: within an ulp of the exact value
        assert np.all(np.abs(_f64(got)[:, 0] - ref) <= np.spacing(np.abs(ref).astype(np.float32)))


def test_jax_reduce_last_drops_columns_at_75():
    """The record behind the padding: _reduce_last halves 75 to 37, 37 to
    18 and 9 to 4, dropping the odd column each time, so of 75 ones it sums
    64; the port's fold sums all 75."""
    ones = jnp.ones((1, 75), jnp.float32)
    assert float(_reduce_last(ones)[0, 0]) == 64.0
    got = generic.gemv_generic(torch.ones(1, 75), torch.ones(75), torch.zeros(1), "f32", "f32",
                               alpha=1.0, beta=0.0)
    assert float(got) == 75.0


# ---------------------------------------------------------------- window sum

def _jax_window_sum(parent, rows, cols, bi, bj):
    """tests/test_accessor.py's strided-window Pallas call: a (rows, cols)
    block at block index (bi, bj), summed in f32 through a Range."""
    spec = JaxSpec("f32", "f32")

    def kernel(a_ref, o_ref):
        r = JaxRange(spec, a_ref, const=True)
        o_ref[0, 0] = jnp.sum(r.load())

    return pl.pallas_call(
        kernel,
        grid=(1,),
        in_specs=[pl.BlockSpec((rows, cols), lambda i: (bi, bj))],
        out_specs=pl.BlockSpec((1, 1), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        interpret=interpret_default(),
    )(parent)


def test_window_sum_against_the_jax_kernel():
    """The JAX test's case: the (8, 128) window at (8, 128) of a (16, 256)
    parent. The JAX kernel sums with jnp.sum and the port by its pairwise
    order, so the two agree to the JAX test's 1e-3 (they read 1e-6 apart)."""
    rng = np.random.default_rng(42)
    parent = rng.uniform(-1, 1, (16, 256)).astype(np.float32)
    want = float(_jax_window_sum(jnp.asarray(parent), 8, 128, 1, 1)[0, 0])
    got = generic.window_sum(torch.from_numpy(parent), 8, 128, 8, 128)
    assert got.shape == (1, 1) and got.dtype == torch.float32
    assert abs(float(got) - want) < 1e-3
    exact = parent[8:, 128:].astype(np.float64).sum()
    assert abs(float(got) - exact) < 1e-5 and abs(want - exact) < 1e-5


@pytest.mark.parametrize("st,ar", PAIRS)
@pytest.mark.parametrize("shape,window", [
    ((16, 256), (8, 128, 8, 128)),
    ((37, 301), (5, 9, 13, 77)),   # odd offsets, a ragged window, stride 301
    ((9, 11), (4, 7, 1, 1)),       # a (1, 1) range
    ((300, 700), (1, 3, 299, 697)),
])
def test_window_sum_against_float64(shape, window, st, ar):
    """Every pairing against the float64 sum of the stored window: f32 within
    the sum's error bound (depth log2 of the padded size), df64 rounded once
    to f32."""
    row0, col0, m, n = window
    rng = np.random.default_rng(sum(shape))
    _, parent = _both(rng.uniform(-1, 1, shape), st)
    got = float(generic.window_sum(parent, row0, col0, m, n, ar))
    w = _f64(parent)[row0:row0 + m, col0:col0 + n]
    exact = w.sum()
    if ar == "df64":
        assert abs(got - exact) <= np.spacing(np.float32(abs(exact)))
    else:
        depth = int(np.ceil(np.log2(max(m * n, 2)))) + 1
        assert abs(got - exact) <= depth * 2**-24 * np.abs(w).sum()


def test_window_sum_plain_folds_in_the_kernel_order():
    """The plain version's order is the kernel's (K, B, T) reading: folded
    by hand here over a 2^17-element window (K = 1, B = 512, T = 256)."""
    rng = np.random.default_rng(9)
    parent = torch.from_numpy(rng.standard_normal((300, 600)).astype(np.float32))
    got = generic.window_sum(parent, 10, 20, 256, 512)
    assert generic._window_split(256, 512) == (9, 512, 256, 0)
    v = parent[10:266, 20:532].reshape(512, 256)  # (B, T)
    for _ in range(8):
        v = v[:, : v.shape[1] // 2] + v[:, v.shape[1] // 2:]
    v = v[:, 0]
    while v.numel() > 1:
        v = v[: v.numel() // 2] + v[v.numel() // 2:]
    assert torch.equal(got.reshape(1), v)


# ------------------------------------- replays of the kernels' index maps and folds

def _bit_reverse(k: int, bits: int) -> int:
    return int(format(k, f"0{bits}b")[::-1], 2) if bits else 0


def _gather(vals, idx):
    """vals[..., idx] of a (rows, n) tensor or DF, Ar{} = +0 where idx is -1."""
    if isinstance(vals, DF):
        return DF(_gather(vals.hi, idx), _gather(vals.lo, idx))
    padded = torch.cat([vals, vals.new_zeros(vals.shape[0], 1)], 1)
    return padded[:, torch.where(idx < 0, vals.shape[1], idx)]


def _fold_replay(load, log2_count):
    """csrc/generic.cu pairwise_fold: kSteps values at a time (load(p) is
    value p, zero past the count), folded by an unrolled tree, then pushed
    into a binary counter; the full level at the end."""
    steps, count = generic._STEPS, 1 << log2_count
    levels, pushes = [], 0
    for p0 in range(0, count, steps):
        vals = [load(p0 + r) for r in range(steps)]
        w = 1
        while w < steps:
            if w < count:
                for r in range(0, steps, 2 * w):
                    vals[r] = vals[r] + vals[r + w]
            w *= 2
        v, level = vals[0], 0
        while (pushes >> level) & 1:
            v = levels[level] + v
            level += 1
        levels[level:level + 1] = [v]
        pushes += 1
    return levels[pushes.bit_length() - 1]


def _halve(v, axis: int, width: int):
    """The first `width` / 2 entries of v along `axis` after one halving
    level (entry s takes s + width / 2), as lane or thread 0's shuffle chain
    reads them."""
    head = (slice(None),) * axis
    h = width // 2
    return v[head + (slice(0, h),)] + v[head + (slice(h, 2 * h),)]


def _slot_fold(v, width: int, slots: int):
    """slot_fold over the last axis: halving over the first `slots` of
    `width` slots."""
    w = width // 2
    while w:
        v = _halve(v, v.ndim - 1, 2 * w) if w < slots else v[..., :w]
        w //= 2
    return v[..., 0]


def _gemv_replay(prods, v: int):
    """The GEMV kernel's row sums of (m, n) products read v at a time: lane
    t's slot s holds column (k lanes + t) v + s of step k."""
    m, n = prods.shape
    lanes, log2_per, slots = generic._gemv_split(n, v)
    per = 1 << log2_per
    t, s = torch.arange(32).view(32, 1), torch.arange(v).view(1, v)

    def load(p):
        j = (_bit_reverse(p % per, log2_per) * lanes + t) * v + s
        return _gather(prods, torch.where((t < lanes) & (j < n) & (p < per), j, -1))

    own = _fold_replay(load, log2_per)  # (m, 32 lanes, v slots)
    h = lanes
    while h > 1:  # lane t takes lane t + h / 2
        own, h = _halve(own, 1, h), h // 2
    return _slot_fold(own[:, 0], v, slots)


def _products(m, n, ar, seed):
    """(m, n) products of mixed magnitudes in arithmetic `ar`, so that the
    order of their sum shows in its bits."""
    rng = np.random.default_rng(seed)
    mag = 2.0 ** rng.integers(-12, 12, (m, n))
    hi = torch.from_numpy((rng.standard_normal((m, n)) * mag).astype(np.float32))
    if ar == "f32":
        return hi
    lo = torch.from_numpy((hi.double().numpy() * rng.uniform(-2**-25, 2**-25, (m, n)))
                          .astype(np.float32))
    return DF(hi, lo)


def _equal_bits(got, want):
    if isinstance(want, DF):
        return _equal_bits(got.hi, want.hi) and _equal_bits(got.lo, want.lo)
    return np.array_equal(_bits(got.numpy()), _bits(want.numpy()))


@pytest.mark.parametrize("v", [1, 4, 8])
def test_gemv_replay_folds_as_the_halving_tree(v):
    """The kernel's index map and fold, replayed at every width 1-1025 (so
    v*32 - 1, v*32 and v*32 + 1 among them) on f32 products: bit for bit
    _reduce_last's zero-padded halving, the plain version's pow2_tree_sum."""
    prods = _products(2, 1025, "f32", 31)
    for n in range(1, 1026):
        got, want = _gemv_replay(prods[:, :n], v), pow2_tree_sum(prods[:, :n])
        assert _equal_bits(got, want), n


@pytest.mark.parametrize("v", [1, 4, 8])
def test_gemv_replay_folds_df64_as_the_halving_tree(v):
    """The same on DF products (both words), at v*32 +- 1 and past one
    counter chunk of steps."""
    prods = _products(2, 8 * 32 * v * 2 + 1, "df64", 32)
    for n in (1, 3, 32 * v - 1, 32 * v + 1, 4 * 32 + 1, 8 * 32 - 1, 8 * 32 * v * 2 + 1):
        assert _equal_bits(_gemv_replay(prods[:, :n], v), pow2_tree_sum(prods[:, :n])), n


def _window_replay(parent, row0, col0, m, n, ar, v):
    """The window kernel: block b's thread `th` holds t = th v + s of the flat
    (K, B, T) reading as slot s, at the parent element of the flat index's
    (row, column); its slots fold over k, the block over its threads, each
    thread over its slots, then the last block over the block sums; the sum
    is stored through a (1, 1) f32 Range."""
    log2_n, blocks, t, log2_per = generic._window_split(m, n)
    per, threads, slots = 1 << log2_per, max(t // v, 1), min(t, v)
    vals = Range(ReducedRowMajor(ar, parent.dtype), parent, const=True).load().reshape(1, -1)
    b = torch.arange(blocks).view(blocks, 1, 1)
    th, s = torch.arange(threads).view(1, threads, 1), torch.arange(v).view(1, 1, v)

    def load(p):
        q = (_bit_reverse(p % per, log2_per) * blocks + b) * t + th * v + s
        i, j = q >> log2_n, q & ((1 << log2_n) - 1)
        flat = (row0 + i) * parent.stride(0) + col0 + j
        ok = (s < slots) & (i < m) & (j < n) & (p < per)
        return _gather(vals, torch.where(ok, flat, -1))[0]

    own = _fold_replay(load, log2_per)  # (blocks, threads, v slots)
    h = threads
    while h > 1:
        own, h = _halve(own, 1, h), h // 2
    own = _slot_fold(own[:, 0], v, slots)
    while blocks > 1:
        own, blocks = _halve(own, 0, blocks), blocks // 2
    out = torch.empty((1, 1), dtype=torch.float32)
    Range(ReducedRowMajor(ar, "f32"), out).store(own.reshape(1, 1))
    return out


@pytest.mark.parametrize("ar", ["f32", "df64"])
@pytest.mark.parametrize("v", [1, 4, 8])
@pytest.mark.parametrize("shape,window", [
    ((37, 301), (5, 9, 13, 77)),           # ragged, odd offsets, stride 301
    ((9, 11), (4, 7, 1, 1)),               # a (1, 1) window: T = 1 < v
    ((5, 3), (1, 0, 4, 3)),                # a window narrower than v
    ((2100, 2051), (3, 2, 2049, 2047)),    # K = 32: four counter chunks
])
def test_window_replay_folds_as_the_plain_version(shape, window, v, ar):
    """The window kernel's index map and fold, replayed at v = 1, 4 and 8:
    bit for bit the plain version's (K, B, T) halving."""
    rng = np.random.default_rng(sum(shape) + v)
    mag = 2.0 ** rng.integers(-12, 12, shape)
    parent = torch.from_numpy((rng.standard_normal(shape) * mag).astype(np.float32))
    got = _window_replay(parent, *window, ar, v)
    assert torch.equal(got, generic._window_sum_plain(parent, *window, ar))


def test_the_wrappers_choose_the_vector_instantiation_by_alignment():
    """V is the pair's vector width where every base and row stride the
    kernel reads is a multiple of V elements and the fold fits the vector
    counter; else the V = 1 instantiation."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert [generic.vector_width(dt, ar) for dt, ar in
            ((f32, "f32"), (bf16, "f32"), (f32, "df64"), (bf16, "df64"),
             (torch.float8_e4m3fn, "f32"))] == [4, 8, 4, 4, 8]
    a, x = torch.zeros(64, 256), torch.zeros(256)
    assert generic.gemv_vector(a, x, "f32") == 4
    assert generic.gemv_vector(a, x, "df64") == 4
    assert generic.gemv_vector(a.to(bf16), x.to(bf16), "f32") == 8
    assert generic.gemv_vector(a.to(bf16), x.to(bf16), "df64") == 4
    off = torch.zeros(64, 257)[:, 1:]  # one element off, row stride 257
    assert generic.gemv_vector(off, x, "f32") == 1
    assert generic.gemv_vector(torch.zeros(64, 260)[:, 4:], x, "f32") == 4  # 16 bytes off
    assert generic.gemv_vector(torch.zeros(64, 255), torch.zeros(255), "f32") == 1  # odd stride
    assert generic.gemv_vector(torch.zeros(1, 255), torch.zeros(255), "f32") == 4  # one row
    assert generic.gemv_vector(a, torch.zeros(257)[1:], "f32") == 1  # x one element off
    b16 = torch.zeros(64, 272, dtype=bf16)
    assert generic.gemv_vector(b16[:, 8:], x.to(bf16), "f32") == 8
    assert generic.gemv_vector(b16[:, 4:], x.to(bf16), "f32") == 1  # 8 bytes: not 16
    assert generic.gemv_vector(b16[:, 4:], x.to(bf16), "df64") == 4  # 8-byte reads
    deep = 32 * 4 << generic._LOG2_MAX_PER[True]  # the widest f32 row the counter holds
    assert generic.gemv_vector(torch.zeros(1, deep), torch.zeros(deep), "f32") == 4
    assert generic.gemv_vector(torch.zeros(1, deep + 1)[:, :deep + 1],
                               torch.zeros(deep + 1), "f32") == 1

    p = torch.zeros(64, 256, dtype=f32)
    assert generic.window_vector(p, 1, 4, 20, 100, "f32") == 4
    assert generic.window_vector(p, 1, 1, 20, 100, "f32") == 1  # window one element off
    assert generic.window_vector(p.to(bf16), 1, 4, 20, 100, "f32") == 1
    assert generic.window_vector(p.to(bf16), 1, 8, 20, 100, "f32") == 8
    assert generic.window_vector(p, 2, 4, 20, 100, "df64") == 4
    odd = torch.zeros(9, 301)
    assert generic.window_vector(odd, 0, 0, 5, 8, "f32") == 1  # odd row stride
    assert generic.window_vector(odd, 0, 0, 1, 8, "f32") == 4  # one row: no stride read


def test_the_axpy_wrapper_chooses_v_by_the_gemv_rule():
    """AXPY takes the vector instantiation where every row of x, y and the
    output starts at a multiple of V elements (its base, and its row stride
    past one row): the GEMV's rule for A, one function; else V = 1."""
    f32, bf16, f8 = torch.float32, torch.bfloat16, torch.float8_e4m3fn

    def v(x, y, out_dtype=f32, ar="f32"):
        return generic.axpy_vector(x, y, torch.empty(x.shape, dtype=out_dtype), ar)

    p = torch.zeros(8, 272)
    assert v(p[:, :256], p[:, 8:264]) == 4
    assert v(p[:, :256], p[:, 4:260]) == 4  # 16 bytes off
    assert v(p[:, 1:257], p[:, :256]) == 1  # x one element off
    assert v(p[:, :256], p[:, 2:258]) == 1  # y 8 bytes off
    assert v(p[:, :256], p[:, :256], ar="df64") == 4
    assert v(torch.zeros(8, 255), torch.zeros(8, 255)) == 1  # an odd row stride (and output's)
    assert v(torch.zeros(1, 255), torch.zeros(1, 255)) == 4  # one row: no stride read
    b = p.to(bf16)
    assert v(b[:, :256], b[:, 8:264]) == 8  # 8 bf16 in, 32 bytes of f32 out
    assert v(b[:, :256], b[:, 4:260]) == 1  # 8 bytes: not 16
    assert v(b[:, :256], b[:, 4:260], ar="df64") == 4
    assert v(b[:, :256], b[:, :256], out_dtype=f8) == 8  # 8 bytes of f8 out
    out = torch.empty(8, 257)[:, 1:]  # an output one element off
    assert generic.axpy_vector(p[:, :256], p[:, :256], out, "f32") == 1
    # the same rule as the GEMV's for A
    for t in (p[:, :256], p[:, 1:257], p[:, 4:260], torch.zeros(8, 255), b[:, 4:260]):
        assert generic._rows_aligned(4, t) == (generic.gemv_vector(t, torch.zeros(t.shape[1],
                                                                                    dtype=t.dtype),
                                                                   "df64") == 4)


def test_the_scratch_helper_keys_by_device_and_stream():
    """One zeroed buffer a (device, stream), made at its first use and
    given again after: the DOT and the window sum share it."""
    from accblas_tpu_torch.ops import _build

    t = torch.zeros(3)
    keys = [(t.get_device(), s) for s in (101, 102)]
    try:
        a, b = _build.scratch(t, 101), _build.scratch(t, 102)
        assert a != b and _build.scratch(t, 101) == a and _build.scratch(t, 102) == b
        for key, addr in zip(keys, (a, b)):
            buf = _build._scratch[key]
            assert buf.data_ptr() == addr and buf.numel() == _build.SCRATCH_BYTES
            assert buf.dtype == torch.uint8 and not buf.any()
    finally:
        for key in keys:
            _build._scratch.pop(key, None)


# ---------------------------------------------------------------- the wrappers

def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.ones(4, 8)
    with pytest.raises(ValueError):
        generic.axpy(x, x, "bf16", "f32")  # f32 and df64 arithmetic only
    with pytest.raises(ValueError):
        generic.axpy(x, x, "f8e4m3", "f32")  # a storage-only type
    with pytest.raises(ValueError):
        generic.axpy(x, x.double(), "f32", "f32")  # one storage type for x, y
    with pytest.raises(ValueError):
        generic.axpy(x, x, "f32", "f64")  # no f64 storage in the kernels
    with pytest.raises(ValueError):
        generic.axpy(x.T, x.T, "f32", "f32")  # columns must be unit-stride
    with pytest.raises(ValueError):
        generic.gemv_generic(x, torch.ones(8), torch.ones(4, dtype=torch.bfloat16), "f32", "f32")
    with pytest.raises(ValueError):
        generic.gemv_generic(x, torch.ones(7), torch.ones(4), "f32", "f32")
    with pytest.raises(ValueError):
        generic.window_sum(x, 2, 2, 3, 3)  # past the parent's edge
    assert float(generic.window_sum(x, 1, 1, 0, 3)) == 0.0


def test_the_ops_are_not_exported():
    """The JAX package exports no such op; the port does not either."""
    import accblas_tpu_torch

    for name in ("axpy", "gemv_generic", "window_sum"):
        assert not hasattr(accblas_tpu_torch, name)
