"""The port's blocked TRSV/TRSM compositions (``_trsv_small``,
``_trsm_small_df64``) and their route, against the JAX package's on
identical inputs.

The inputs are the JAX tests' own (tests/test_trsv.py): the packed LU factor
of a diagonally dominant uniform(-1, 1) matrix made from a seed with numpy,
stored in the tier's storage. The unit-upper mode takes the factor's LDU
form (U's strict upper triangle scaled by its diagonal): on the raw factor
that mode drops U's large diagonal and overflows from n = 1024. The JAX
compositions are XLA ops, fast on the CPU; the sweep comparisons stay at
n <= 1024 (the JAX sweep runs in Pallas interpret mode). Errors are relative
errors against a float64 solve of the *stored* triangle. Bounds, the JAX
tests' own: f32 arithmetic 1e-4, bf16 storage 1e-3, f16 storage 6e-4, df64
5e-6. Port and JAX agree within twice the bound.
"""

import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.linalg
import torch

import accblas_tpu_torch
from accblas_tpu.ops import trsv as jtrsv
from accblas_tpu_torch.ops import trsv as ttrsv
from accblas_tpu_torch.utils import MatrixInfo, gen_mtx, interop

torch.set_num_threads(1)

_NP = {"f32": np.float32, "bf16": ml_dtypes.bfloat16, "f16": np.float16}
BOUND = {"f32": 1e-4, "bf16": 1e-3, "f16": 6e-4}
DF64_TOL = 5e-6
MODES = [("upper", False), ("lower", True), ("upper", True), ("lower", False)]


@functools.lru_cache(maxsize=None)
def _packed_lu(n, seed=42):
    a64 = gen_mtx(MatrixInfo(n, n), seed=seed)
    a64 += np.eye(n) * (0.25 * n)
    lu, _ = scipy.linalg.lu_factor(a64)
    b64 = gen_mtx(MatrixInfo(1, n), seed=seed + 1)[0]
    return lu, b64


def _operand(lu, uplo, unit):
    """The factor the mode solves well: the LDU form for unit upper."""
    if (uplo, unit) == ("upper", True):
        return np.tril(lu) + np.triu(lu, 1) / np.diag(lu)[:, None]
    return lu


def _stored(a64, st):
    """`a64` in storage `st`, and its stored values in float64."""
    a = a64.astype(np.float32).astype(_NP[st])
    return a, a.astype(np.float64)


def _ref(t64, b64, uplo, unit):
    t = np.tril(t64) if uplo == "lower" else np.triu(t64)
    if unit:
        np.fill_diagonal(t, 1.0)
    return scipy.linalg.solve_triangular(t, b64, lower=(uplo == "lower"))


def _rel(got, ref):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _l1(got, ref):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    return np.abs(got - ref).sum() / np.abs(ref).sum()


def _t(a):
    return interop.from_numpy(a)


@pytest.mark.parametrize("st", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("uplo,unit", MODES)
@pytest.mark.parametrize("k", [1, 8, 33])
@pytest.mark.parametrize("n", [300, 700, 1024, 1664])
@pytest.mark.parametrize("fn", ["_trsv_small", "_trsm_small_df64"])
def test_composition_matches_jax(fn, n, k, uplo, unit, st):
    """The same block size on both sides; the df64 composition holds the
    df64 bound over every storage (its error is taken against the stored
    triangle)."""
    lu, _ = _packed_lu(n, seed=n)
    a, a64 = _stored(_operand(lu, uplo, unit), st)
    bm = gen_mtx(MatrixInfo(k, n), seed=k + 5).T.astype(np.float32)
    ref = _ref(a64, bm.astype(np.float64), uplo, unit)
    block = ttrsv._block_for(n)
    got = getattr(ttrsv, fn)(_t(a), _t(bm), uplo, unit, "f32", block=block)
    want = getattr(jtrsv, fn)(jnp.asarray(a), jnp.asarray(bm), uplo, unit, "f32", block=block)
    assert got.shape == (n, k) and got.dtype == torch.float32
    tol = DF64_TOL if fn == "_trsm_small_df64" else BOUND[st]
    err, jerr = _rel(got, ref), _rel(want, ref)
    assert err < tol and jerr < tol, (err, jerr, tol)
    assert _rel(got, np.asarray(want, np.float64)) < 2 * tol


def test_acc_trsm_narrow_multirhs_blocked_route():
    """bf16 storage at k = 8 on the composition (resident=True) against a
    float64 solve of the quantized operand and against the sweep
    (resident=False) on the same operand: the same error class, and within
    twice the bf16 bound of the JAX package's composition."""
    n, k = 2176, 8
    lu, _ = _packed_lu(n, seed=53)
    a, a64 = _stored(lu, "bf16")
    bm = gen_mtx(MatrixInfo(k, n), seed=59).T
    ref = _ref(a64, bm, "upper", False)
    b = _t(bm.astype(np.float32))
    routed = accblas_tpu_torch.acc_trsm(_t(a), b, "upper", False, ar="f32", resident=True,
                                        unstable_ok=True)
    swept = accblas_tpu_torch.acc_trsm(_t(a), b, "upper", False, ar="f32", resident=False,
                                       unstable_ok=True)
    r_blk, r_swp = _rel(routed, ref), _rel(swept, ref)
    assert np.isfinite(r_blk) and r_blk < 1e-2, r_blk
    assert r_blk < 10 * max(r_swp, 1e-7), (r_blk, r_swp)
    want = jtrsv.acc_trsm(jnp.asarray(a), jnp.asarray(bm, jnp.float32), uplo="upper", unit=False,
                          ar="f32", resident=True, unstable_ok=True)
    assert _rel(routed, np.asarray(want, np.float64)) < 2 * BOUND["bf16"]


@pytest.mark.parametrize("uplo,unit", [("upper", False), ("lower", False), ("upper", True)])
def test_trsv_resident_mode_matches(uplo, unit):
    """resident=True at the ragged n = 700 against float64, against the
    sweep (to f32 rounding: the unit triangle's 256-wide block inverses
    amplify more than the sweep's 64-wide leaves) and against the JAX
    package's resident mode."""
    n = 700
    lu, b64 = _packed_lu(n, seed=59)
    ref = _ref(lu, b64, uplo, unit)
    a, b = _t(lu.astype(np.float32)), _t(b64.astype(np.float32))
    got = accblas_tpu_torch.trsv(a, b, uplo=uplo, unit=unit, resident=True)
    assert got.shape == (n,)
    assert _l1(got, ref) < 1e-4
    swept = accblas_tpu_torch.trsv(a, b, uplo=uplo, unit=unit, resident=False)
    assert _l1(got, swept.double().numpy()) < (5e-5 if unit else 1e-5)
    want = jtrsv.trsv(jnp.asarray(lu, jnp.float32), jnp.asarray(b64, jnp.float32), uplo=uplo,
                      unit=unit, resident=True)
    assert _l1(got, np.asarray(want, np.float64)) < 2e-4


def test_trsv_small_narrow_storage_tiers():
    """Every storage at its storage error floor against the float64 solve of
    the unquantized factor (the JAX test's floors, measured there with ~3x
    margin; f8 values clipped to the e4m3 range first), at k = 1 and k = 64,
    and column 0 of the panel solve mirrors column 1 exactly."""
    n = 700
    lu, b64 = _packed_lu(n)
    ref = _ref(lu, b64, "upper", False)
    b = _t(b64.astype(np.float32))
    bm = np.concatenate([np.stack([b64, -b64], 1)] * 32, 1).astype(np.float32)
    floors = {"bf16": 5e-3, "f16": 6e-4, "f32": 5e-7, "f8e4m3": 2e-2, "f8e5m2": 3e-1}
    for st, tol in floors.items():
        a = interop.from_numpy(np.clip(lu, -448, 448).astype(np.float32), st)
        got = ttrsv._trsv_small(a, b, "upper", False, "f32")
        assert _l1(got, ref) < tol, st
        gotm = ttrsv._trsv_small(a, _t(bm), "upper", False, "f32")
        assert _l1(gotm[:, 0], ref) < tol, st
        np.testing.assert_array_equal(gotm[:, 0].numpy(), -gotm[:, 1].numpy())


def test_trsv_blocked_refinement_matches_substitution_class():
    """The composition's refined block application is substitution-class
    accurate: on a raw LU factor at n = 1024 it errs no worse than 1.25x
    torch.linalg.solve_triangular (xla_trsv) on the same backend."""
    n = 1024
    lu64, _ = scipy.linalg.lu_factor(gen_mtx(MatrixInfo(n, n), seed=42))
    b64 = gen_mtx(MatrixInfo(1, n), seed=43)[0]
    ref = scipy.linalg.solve_triangular(np.triu(lu64), b64, lower=False)
    a, b = _t(lu64.astype(np.float32)), _t(b64.astype(np.float32))
    x_blk = accblas_tpu_torch.trsv(a, b, "upper", False, resident=True)
    x_xla = accblas_tpu_torch.xla_trsv(a, b, "upper", False)
    assert _l1(x_blk, ref) < 1.25 * _l1(x_xla, ref), (_l1(x_blk, ref), _l1(x_xla, ref))


def test_refine_gate_scope():
    """The block refinement applies only to f32 storage at n >= 512 and
    k < 32 (refine=None): where the gate says on, refine=False changes the
    bits and both stay at the storage floor; where it says off, refine=None
    is refine=False bit for bit."""

    def both(a, b):
        got = ttrsv._trsv_small(a, b, "upper", False, "f32")
        raw = ttrsv._trsv_small(a, b, "upper", False, "f32", refine=False)
        return got.double().numpy(), raw.double().numpy()

    lu, b64 = _packed_lu(1024)
    ref = _ref(lu, b64, "upper", False)
    got, raw = both(_t(lu.astype(np.float32)), _t(b64.astype(np.float32)))
    assert not np.array_equal(got, raw)
    assert _l1(got, ref) < 5e-6 and _l1(raw, ref) < 5e-6
    lu, b64 = _packed_lu(256)
    got, raw = both(_t(lu.astype(np.float32)), _t(b64.astype(np.float32)))
    np.testing.assert_array_equal(got, raw)
    lu, b64 = _packed_lu(1024)
    got, raw = both(interop.from_numpy(lu.astype(np.float32), "bf16"),
                    interop.from_numpy(b64.astype(np.float32), "bf16"))
    np.testing.assert_array_equal(got, raw)
    bm = np.stack([b64] * 32, 1).astype(np.float32)
    got, raw = both(_t(lu.astype(np.float32)), _t(bm))
    np.testing.assert_array_equal(got, raw)


def test_acc_trsm_df64_wide_routing_gate():
    """On a CPU tensor acc_trsm df64 with k >= 32 takes the DF composition,
    bit for bit _trsm_small_df64; resident=False forces the sweep, which
    gives other bits; both land in the df64 class, and the route agrees with
    the JAX package's."""
    n, k = 768, 32
    lu, _ = _packed_lu(n, seed=59)
    b64 = gen_mtx(MatrixInfo(k, n), seed=61).T
    ref = _ref(lu, b64, "upper", False)
    a, b = _t(lu.astype(np.float32)), _t(b64.astype(np.float32))
    routed = accblas_tpu_torch.acc_trsm(a, b, "upper", False, ar="df64")
    direct = ttrsv._trsm_small_df64(a, b, "upper", False, "f32")
    assert torch.equal(routed, direct)
    swept = accblas_tpu_torch.acc_trsm(a, b, "upper", False, ar="df64", resident=False)
    assert not torch.equal(swept, routed)
    assert _rel(routed, ref) < DF64_TOL and _rel(swept, ref) < DF64_TOL
    want = jtrsv.acc_trsm(jnp.asarray(lu, jnp.float32), jnp.asarray(b64, jnp.float32),
                          uplo="upper", unit=False, ar="df64")
    assert _rel(routed, np.asarray(want, np.float64)) < 2 * DF64_TOL


@pytest.mark.parametrize("n", [768, 832])
def test_trsm_small_df64_beats_f32_blocked(n):
    """The DF-carried panels land strictly below the f32 composition's error
    on aligned and ragged n; the vector form ties the f32 one at the storage
    floor."""
    lu, _ = _packed_lu(n, seed=91)
    b64 = gen_mtx(MatrixInfo(n, 16), seed=92)
    a, b = _t(lu.astype(np.float32)), _t(b64.astype(np.float32))
    for uplo, unit in (("upper", False), ("lower", True)):
        ref = _ref(lu, b64, uplo, unit)
        x_df = ttrsv._trsm_small_df64(a, b, uplo, unit, "f32")
        x_f32 = ttrsv._trsv_small(a, b, uplo, unit, "f32")
        assert _l1(x_df, ref) < _l1(x_f32, ref), (uplo, unit, _l1(x_df, ref), _l1(x_f32, ref))
    ref1 = _ref(lu, b64[:, 0], "upper", False)
    x_vec = ttrsv._trsm_small_df64(a, b[:, 0].contiguous(), "upper", False, "f32")
    x1_f32 = ttrsv._trsv_small(a, b[:, 0].contiguous(), "upper", False, "f32")
    assert x_vec.shape == (n,)
    assert _l1(x_vec, ref1) < 1.1 * _l1(x1_f32, ref1), (_l1(x_vec, ref1), _l1(x1_f32, ref1))


@pytest.mark.parametrize("n", [1664, 2048])
def test_blocked_routes_block_override(n):
    """block=1024 (against _block_for's 512) keeps the error class of both
    compositions; n = 1664 has a ragged last block (1024 + 640)."""
    lu, b64 = _packed_lu(n)
    a, b = _t(lu.astype(np.float32)), _t(b64.astype(np.float32))
    ref = _ref(lu, b64, "upper", False)
    d = ttrsv._trsv_small(a, b, "upper", False, "f32")
    o = ttrsv._trsv_small(a, b, "upper", False, "f32", block=1024)
    assert _l1(o, ref) < 4 * max(_l1(d, ref), 1e-7), (_l1(o, ref), _l1(d, ref))
    bm = np.stack([b64 * s for s in (1.0, -1.0, 0.5, 2.0)] * 8, 1)
    bref = _ref(lu, bm, "upper", False)
    dm = ttrsv._trsm_small_df64(a, _t(bm.astype(np.float32)), "upper", False, "f32")
    om = ttrsv._trsm_small_df64(a, _t(bm.astype(np.float32)), "upper", False, "f32",
                                block=1024)
    assert _l1(om, bref) < 4 * max(_l1(dm, bref), 1e-7), (_l1(om, bref), _l1(dm, bref))


@pytest.mark.parametrize("s,n,offs", [(128, None, None), (256, None, None), (512, None, None),
                                      (64, 700, True)])
@pytest.mark.parametrize("uplo,unit", MODES)
def test_masked_tri_inverse_matches_jax(s, n, offs, uplo, unit):
    """The block inversion at any block size, and with the identity past a
    logical n, against the JAX package's (both f32 triangular solves;
    normwise per block)."""
    lower = uplo == "lower"
    g = -(-n // s) if n else 3
    rng = np.random.default_rng(s)
    d = (rng.uniform(-1, 1, (g, s, s)) / s + np.eye(s)).astype(np.float32)
    kw = {}
    if offs:
        kw = {"n": n, "offs": np.arange(g) * s}
    got = ttrsv._masked_tri_inverse(torch.from_numpy(d), lower, unit,
                                    **{k: (torch.from_numpy(v) if k == "offs" else v)
                                       for k, v in kw.items()})
    want = np.asarray(jtrsv._masked_tri_inverse(
        jnp.asarray(d), lower, unit, **{k: (jnp.asarray(v, jnp.int32) if k == "offs" else v)
                                        for k, v in kw.items()}))
    diff = np.linalg.norm(got.numpy() - want, axis=(1, 2)) / np.linalg.norm(want, axis=(1, 2))
    assert diff.max() < 1e-5, diff.max()


# (n, k, storage, arithmetic) -> the route on each device
ROUTES = [
    ((16384, 1, "f32", "f32"), "sweep", "sweep"),
    ((16384, 16, "bf16", "f32"), "sweep", "sweep"),
    ((16384, 32, "f32", "f32"), "sweep", "sweep"),
    ((8192, 64, "f32", "f32"), "sweep", "sweep"),
    ((8192, 128, "bf16", "f32"), "sweep", "composition"),
    ((16384, 64, "f32", "f32"), "sweep", "composition"),
    ((16384, 64, "bf16", "f32"), "sweep", "composition"),
    ((32768, 16, "f32", "f32"), "sweep", "sweep"),
    ((4096, 128, "f16", "f32"), "sweep", "sweep"),
    ((8192, 192, "f32", "f32"), "sweep", "composition"),
    ((700, 31, "f32", "df64"), "sweep", "sweep"),
    ((700, 32, "f32", "df64"), "composition", "sweep"),
    ((16384, 128, "bf16", "df64"), "composition", "sweep"),
]


@pytest.mark.parametrize("key,cpu,cuda", ROUTES)
def test_route_table(key, cpu, cuda):
    """resident=None: a CPU tensor routes as the JAX package does off a TPU
    (the sweep, but df64 panels of k >= 32), a CUDA tensor by the gate
    measured on the H100."""
    assert ttrsv._route(*key, "cpu") == cpu
    assert ttrsv._route(*key, "cuda") == cuda


def test_resident_routes_on_cpu():
    """The public calls take the route resident asks for: True the
    composition, False and None the sweep in the f32 tier on the CPU."""
    n = 600
    lu, b64 = _packed_lu(n, seed=7)
    a, b = _t(lu.astype(np.float32)), _t(b64.astype(np.float32))
    comp = ttrsv._trsv_small(a, b, "upper", False, "f32")
    assert torch.equal(accblas_tpu_torch.trsv(a, b, "upper", False, resident=True), comp)
    swept = accblas_tpu_torch.trsv(a, b, "upper", False, resident=False)
    assert torch.equal(accblas_tpu_torch.trsv(a, b, "upper", False), swept)
    assert not torch.equal(swept, comp)


def test_compositions_launch_no_kernel_on_cpu():
    before = (ttrsv.leaf_diag_launches, ttrsv.leaf_phase_launches, ttrsv.sweep_launches)
    lu, b64 = _packed_lu(300)
    a, b = _t(lu.astype(np.float32)), _t(b64.astype(np.float32))
    accblas_tpu_torch.trsm(a, torch.stack([b] * 40, 1), resident=True)
    accblas_tpu_torch.acc_trsm(a, torch.stack([b] * 40, 1), ar="df64")
    assert (ttrsv.leaf_diag_launches, ttrsv.leaf_phase_launches, ttrsv.sweep_launches) == before
