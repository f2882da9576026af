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
from accblas_tpu_torch.ops import generic
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
