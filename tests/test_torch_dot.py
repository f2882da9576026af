"""DOT of the port against the JAX package's DOT on identical stored bits.

On the CPU the port runs its plain torch version; the JAX side runs as its
own tests run it here, through the Pallas kernel in interpret mode. Both are
held to the tier bounds of accblas_tpu_torch.utils.tolerance against a
float64 dot of the stored values, and to twice the bound against each other.
The CUDA kernel is held against the plain version on a card in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from accblas_tpu.ops import df64 as jdf
from accblas_tpu.ops import dot as jdot
from accblas_tpu_torch.ops import df64 as tdf
from accblas_tpu_torch.ops import dot as tdot
from accblas_tpu_torch.utils import MatrixInfo, gen_mtx, interop, tolerance

torch.set_num_threads(1)

STORAGE = ("f32", "bf16", "f16", "f8e4m3", "f8e5m2")
TIERS = ("f32", "bf16", "f16", "df64_fast", "df64_precise")
_NP = {"f8e4m3": ml_dtypes.float8_e4m3fn, "f8e5m2": ml_dtypes.float8_e5m2,
       "bf16": ml_dtypes.bfloat16, "f16": np.float16, "f32": np.float32}


def _vec(n: int, seed: int, st: str) -> np.ndarray:
    """Seeded uniform(-1, 1) master, rounded to f32 and then to storage `st`."""
    return gen_mtx(MatrixInfo(1, n), seed=seed)[0].astype(np.float32).astype(_NP[st])


def _ar(tier: str):
    return ("df64", tier == "df64_precise") if tier.startswith("df64") else (tier, False)


def _value(out) -> float:
    if isinstance(out, tdf.DF):
        return float(tdf.df_to_f64(out))
    if isinstance(out, jdf.DF):
        return float(jdf.df_to_f64(out))
    if isinstance(out, torch.Tensor):
        return float(out.double())
    return float(jnp.asarray(out, jnp.float32))


def _both(x, y, tier, init=None):
    """(port, JAX, float64 oracle) values of the tier's DOT of x and y."""
    ar, precise = _ar(tier)
    got = tdot.acc_dot(interop.from_numpy(x), interop.from_numpy(y), ar, precise=precise,
                       init=init)
    want = jdot.acc_dot(jnp.asarray(x), jnp.asarray(y), ar, precise=precise, init=init)
    ref = float(x.astype(np.float64) @ y.astype(np.float64)) + (init or 0.0)
    return _value(got), _value(want), ref


def _check(tier, got, want, ref):
    den = abs(ref)
    err, jerr = abs(got - ref) / den, abs(want - ref) / den
    if tier in tolerance.TOL:
        tol = tolerance.TOL[tier]
        assert err <= tol, (err, tol)
        assert abs(got - want) / den <= 2 * tol, (got, want)
    else:
        assert err <= tolerance.narrow_bound(jerr), (err, jerr)


@pytest.mark.parametrize("st", STORAGE)
@pytest.mark.parametrize("tier", TIERS)
def test_acc_dot_every_tier_and_storage(tier, st):
    x, y = _vec(12345, 42, st), _vec(12345, 43, st)
    _check(tier, *_both(x, y, tier))


@pytest.mark.parametrize("n", [777, 4096, 12345, 2**16])
@pytest.mark.parametrize("tier,st", [("f32", "bf16"), ("df64_precise", "f32"),
                                     ("df64_fast", "bf16"), ("bf16", "bf16")])
def test_acc_dot_sizes(tier, st, n):
    x, y = _vec(n, 7, st), _vec(n, 8, st)
    _check(tier, *_both(x, y, tier))


@pytest.mark.parametrize("st", ["f32", "bf16", "f16"])
def test_fixed_dot_matches_jax(st):
    x, y = _vec(4096, 11, st), _vec(4096, 12, st)
    got = tdot.dot(interop.from_numpy(x), interop.from_numpy(y))
    want = jdot.dot(jnp.asarray(x), jnp.asarray(y))
    assert got.dtype == interop.from_numpy(x).dtype and got.dim() == 0
    _check(st, _value(got), _value(want), float(x.astype(np.float64) @ y.astype(np.float64)))


@pytest.mark.parametrize("tier", ["f32", "df64_precise"])
@pytest.mark.parametrize("sx,sy", [("f32", "bf16"), ("bf16", "f8e4m3")])
def test_mixed_storage(sx, sy, tier):
    x, y = _vec(4096, 21, sx), _vec(4096, 22, sy)
    _check(tier, *_both(x, y, tier))


@pytest.mark.parametrize("tier", ["f32", "bf16", "df64_precise"])
def test_init_seeds_the_sum(tier):
    x, y = _vec(4096, 31, "bf16"), _vec(4096, 32, "bf16")
    _check(tier, *_both(x, y, tier, init=2.5))


def test_res_dtype():
    x, y = _vec(8192, 41, "f32"), _vec(8192, 42, "f32")
    tx, ty = interop.from_numpy(x), interop.from_numpy(y)
    ref = float(x.astype(np.float64) @ y.astype(np.float64))
    out32 = tdot.acc_dot(tx, ty, "df64", res_dtype="f32")
    want32 = jdot.acc_dot(jnp.asarray(x), jnp.asarray(y), "df64", res_dtype="f32")
    assert out32.dtype == torch.float32 and abs(float(out32) - ref) / abs(ref) < 1e-6
    assert abs(float(out32) - float(want32)) / abs(ref) < 1e-6
    out64 = tdot.acc_dot(tx, ty, "df64", precise=True, res_dtype="f64")
    assert out64.dtype == torch.float64 and abs(float(out64) - ref) / abs(ref) < 1e-12
    assert tdot.acc_dot(tx, ty, "f32", res_dtype="bf16").dtype == torch.bfloat16


@pytest.mark.parametrize("st", ["f32", "bf16"])
def test_xla_dot_matches_jax(st):
    x, y = _vec(2**14, 51, st), _vec(2**14, 52, st)
    got = tdot.xla_dot(interop.from_numpy(x), interop.from_numpy(y))
    want = jdot.xla_dot(jnp.asarray(x), jnp.asarray(y))
    assert got.dtype == interop.from_numpy(x).dtype
    ref = float(x.astype(np.float64) @ y.astype(np.float64))
    tol = 5e-5 if st == "f32" else 2.0**-7
    assert abs(_value(got) - ref) / abs(ref) < tol
    assert abs(_value(got) - _value(want)) / abs(ref) < 2 * tol


def test_empty_and_single_element():
    e = torch.zeros(0)
    assert float(tdot.acc_dot(e, e, "f32", init=1.5)) == 1.5
    assert float(tdf.df_to_f64(tdot.acc_dot(e, e, "df64", precise=True, init=-2.0))) == -2.0
    one = torch.tensor([3.0])
    assert float(tdot.dot(one, one)) == 9.0


def test_rejections_match_jax():
    x8 = np.zeros(256, ml_dtypes.float8_e4m3fn)
    for pkg, conv in ((jdot, jnp.asarray), (tdot, interop.from_numpy)):
        with pytest.raises(ValueError, match="storage-only"):
            pkg.dot(conv(x8), conv(x8))
        with pytest.raises(ValueError, match="storage-only"):
            pkg.acc_dot(conv(x8), conv(x8), ar="f8e4m3")
        with pytest.raises(ValueError, match="matching storage dtypes"):
            pkg.dot(conv(np.zeros(8, np.float32)), conv(np.zeros(8, ml_dtypes.bfloat16)))
        with pytest.raises(ValueError):
            pkg.acc_dot(conv(np.zeros(8, np.float32)), conv(np.zeros(9, np.float32)), "f32")
    with pytest.raises(ValueError, match="kernel storage type"):
        tdot.acc_dot(torch.zeros(8, dtype=torch.float64), torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError, match="no f64 arithmetic tier"):
        tdot.acc_dot(torch.zeros(8), torch.zeros(8), "f64")


def test_every_check_of_the_lean_path_raises_as_before():
    """The wrapper takes each check once; each still raises its ValueError
    with its message, on CPU tensors as on the card: not 1-D, unequal
    lengths, mixed devices, f8 storage in the fixed tier, a bad `ar`, a
    dtype no kernel stores."""
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="equal-length vectors, got \\(2, 4\\) \\(2, 4\\)"):
        tdot.acc_dot(x.view(2, 4), x.view(2, 4), "f32")
    with pytest.raises(ValueError, match="equal-length vectors, got \\(8,\\) \\(7,\\)"):
        tdot.acc_dot(x, x[:7], "f32")
    with pytest.raises(ValueError, match="equal-length vectors"):
        tdot.dot(x, x[:7])
    with pytest.raises(ValueError, match="dot: operands on different devices"):
        tdot.acc_dot(x, torch.zeros(8, device="meta"), "f32")
    x8 = x.to(torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="f8e4m3 is a storage-only tier"):
        tdot.dot(x8, x8)
    with pytest.raises(ValueError, match="unknown arithmetic type 'f12'"):
        tdot.acc_dot(x, x, "f12")
    with pytest.raises(ValueError, match="dot has no f64 arithmetic tier"):
        tdot.acc_dot(x, x, "f64")
    with pytest.raises(ValueError, match="dot y: dtype torch.float64 is not a kernel storage"):
        tdot.acc_dot(x, x.double(), "f32")
    with pytest.raises(ValueError, match="dot x: dtype torch.int32 is not a kernel storage"):
        tdot.acc_dot(x.int(), x, "f32")


def test_cpu_tensors_never_launch_the_kernel():
    before = tdot.launches
    x = interop.from_numpy(_vec(1000, 61, "bf16"))
    for tier in TIERS:
        ar, precise = _ar(tier)
        tdot.acc_dot(x, x, ar, precise=precise)
    assert tdot.launches == before
