"""df64 on torch tensors against the JAX package's df64.

The element-wise error-free transforms must be bit-identical to the JAX
versions on the CPU: torch rounds every elementwise op on its own, and the
JAX side runs eagerly at --xla_backend_optimization_level=0 (conftest), so
both round each op individually. The folds run the same algorithm in the
same order and must match bit for bit too.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from accblas_tpu.ops import df64 as jdf
from accblas_tpu_torch.ops import df64 as tdf

torch.set_num_threads(1)


def _f32(rng, shape, scale=1.0):
    return (rng.uniform(-1.0, 1.0, size=shape) * scale).astype(np.float32)


def _bits(v):
    """uint32 view of a float32 result from either package."""
    if isinstance(v, torch.Tensor):
        return v.numpy().view(np.uint32)
    return np.asarray(v).view(np.uint32)


def _pairs(out):
    """Flatten a result (array, tuple of arrays, or DF) into a list."""
    if isinstance(out, (jdf.DF, tdf.DF)):
        return [out.hi, out.lo]
    if isinstance(out, tuple):
        return list(out)
    return [out]


# element-wise transforms of f32 arrays, and of DF pairs
_EFT = ["two_sum", "fast_two_sum", "two_prod"]
_DF2 = ["df_add", "df_sub", "df_mul"]


@pytest.mark.parametrize("shape", [(8, 128), (1000,)])
@pytest.mark.parametrize("op", _EFT)
def test_eft_bit_exact_vs_jax(op, shape):
    rng = np.random.default_rng(7)
    a = _f32(rng, shape)
    b = _f32(rng, shape, 1e-3 if op == "fast_two_sum" else 1.0)
    got = _pairs(getattr(tdf, op)(torch.from_numpy(a), torch.from_numpy(b)))
    want = _pairs(getattr(jdf, op)(jnp.asarray(a), jnp.asarray(b)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("op", _DF2 + ["df_mul_f32", "df_neg", "df_to_f32"])
def test_df_ops_bit_exact_vs_jax(op):
    rng = np.random.default_rng(11)
    hi_a, hi_b = _f32(rng, (512,)), _f32(rng, (512,))
    lo_a, lo_b = hi_a * np.float32(2.0**-26), _f32(rng, (512,), 2.0**-27)
    ta = tdf.df_add(tdf.DF(torch.from_numpy(hi_a), torch.zeros(512)),
                    tdf.df_from(torch.from_numpy(lo_a)))
    ja = jdf.df_add(jdf.DF(jnp.asarray(hi_a), jnp.zeros(512, jnp.float32)),
                    jdf.df_from(jnp.asarray(lo_a)))
    tb = tdf.DF(torch.from_numpy(hi_b), torch.from_numpy(lo_b))
    jb = jdf.DF(jnp.asarray(hi_b), jnp.asarray(lo_b))
    if op in _DF2:
        got, want = getattr(tdf, op)(ta, tb), getattr(jdf, op)(ja, jb)
    elif op == "df_mul_f32":
        got, want = tdf.df_mul_f32(ta, tb.hi), jdf.df_mul_f32(ja, jb.hi)
    else:
        got, want = getattr(tdf, op)(ta), getattr(jdf, op)(ja)
    for g, w in zip(_pairs(got), _pairs(want)):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize(
    "fold",
    ["cascaded_fold", "cascaded_fold_err", "cascaded_fold_mid", "df_fold_rows",
     "df_fold_lanes", "df_sum", "df_sum_axis"],
)
def test_folds_bit_exact_vs_jax(fold):
    rng = np.random.default_rng(13)
    p = _f32(rng, (33, 128))
    e = _f32(rng, (33, 128), 2.0**-25)
    if fold == "cascaded_fold":
        got, want = tdf.cascaded_fold(torch.from_numpy(p), 8), jdf.cascaded_fold(jnp.asarray(p), 8)
    elif fold == "cascaded_fold_err":
        got = tdf.cascaded_fold(torch.from_numpy(p), 1, err=torch.from_numpy(e))
        want = jdf.cascaded_fold(jnp.asarray(p), 1, err=jnp.asarray(e))
    elif fold == "cascaded_fold_mid":
        p3 = p[:32].reshape(4, 8, 128)
        got = tdf.cascaded_fold_mid(torch.from_numpy(p3))
        want = jdf.cascaded_fold_mid(jnp.asarray(p3))
    else:
        d = _f32(rng, (16, 128), 2.0**-26)
        tx = tdf.DF(torch.from_numpy(p[:16]), torch.from_numpy(d))
        jx = jdf.DF(jnp.asarray(p[:16]), jnp.asarray(d))
        if fold == "df_fold_rows":
            got, want = tdf.df_fold_rows(tx, 2), jdf.df_fold_rows(jx, 2)
        elif fold == "df_fold_lanes":
            got, want = tdf.df_fold_lanes(tx, 1), jdf.df_fold_lanes(jx, 1)
        elif fold == "df_sum":
            got, want = tdf.df_sum(tx), jdf.df_sum(jx)
        else:
            tx3 = tdf.DF(tx.hi[:15], tx.lo[:15])
            jx3 = jdf.DF(jx.hi[:15], jx.lo[:15])
            got, want = tdf.df_sum(tx3, axis=0), jdf.df_sum(jx3, axis=0)
    for g, w in zip(_pairs(got), _pairs(want)):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_two_prod_exact_over_1e6_pairs():
    rng = np.random.default_rng(42)
    a = _f32(rng, (10**6,))
    b = _f32(rng, (10**6,))
    p, e = tdf.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(p.numpy().astype(np.float64) + e.numpy().astype(np.float64),
                                  exact)


def test_two_prod_scalar_operand_matches_tensor():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_f32(rng, (64,)))
    p1, e1 = tdf.two_prod(a, 1.7)
    p2, e2 = tdf.two_prod(a, torch.full((64,), 1.7))
    assert torch.equal(p1, p2) and torch.equal(e1, e2)


def test_df_tree_sum_matches_float64_and_cascaded_fold():
    rng = np.random.default_rng(5)
    for n in (1, 777, 4096, 100_003):
        x = _f32(rng, (n,))
        got = tdf.df_to_f64(tdf.df_tree_sum(torch.from_numpy(x)))
        ref = np.sum(x.astype(np.float64))
        assert abs(float(got) - ref) <= 1e-12 * max(abs(ref), 1.0), n
    # a power-of-two row is exactly the JAX package's one-row cascaded fold
    p = _f32(rng, (1, 256))
    got = tdf.df_tree_sum(torch.from_numpy(p))
    want = jdf.cascaded_fold(jnp.asarray(p.reshape(256, 1)), out_rows=1)
    np.testing.assert_array_equal(_bits(got.hi), _bits(want.hi[0]))
    np.testing.assert_array_equal(_bits(got.lo), _bits(want.lo[0]))


def test_df_operators_and_scalars():
    rng = np.random.default_rng(17)
    a32, b32 = _f32(rng, (8,)), _f32(rng, (8,))
    a = tdf.df_from(torch.from_numpy(a32))
    b = tdf.df_from(torch.from_numpy(b32))
    out = a * b + a - b * 2.0
    assert isinstance(out, tdf.DF)
    a64, b64 = a32.astype(np.float64), b32.astype(np.float64)
    np.testing.assert_allclose(tdf.df_to_f64(out).numpy(), a64 * b64 + a64 - 2 * b64,
                               rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(tdf.df_to_f64(1.0 - a).numpy(), 1.0 - a64, rtol=0, atol=0)
    np.testing.assert_allclose(tdf.df_to_f64(-a).numpy(), -a64, rtol=0, atol=0)


def test_fold_shape_errors():
    x = tdf.df_zeros((6, 128))
    with pytest.raises(ValueError):
        tdf.df_fold_rows(x, 1)  # 6 rows: not a power of two
    with pytest.raises(ValueError):
        tdf.cascaded_fold_mid(torch.zeros(2, 3, 128))
