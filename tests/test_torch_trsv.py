"""TRSV/TRSM of the port against the JAX package on identical inputs.

The inputs are the JAX tests' own (tests/test_trsv.py): a diagonally
dominant uniform(-1, 1) matrix made from a seed with numpy, LU-factorised in
float64, its packed factor stored in the tier's storage. On the CPU the port
runs its plain torch versions; the JAX side runs as its own tests run it
here, through the Pallas sweep in interpret mode (its routing picks the
sweep on a non-TPU backend). Errors are 1-norm relative errors against a
float64 solve of the *stored* triangle. Bounds, the JAX tests' own:

- f32 arithmetic: 5e-5 at n = 512 (two blocks), 1e-4 multi-block and ragged;
- bf16 storage: 1e-3 at n = 512; f16 storage: 6e-4;
- df64: < 5e-6, and no worse than max(the f32 tier's error, 5e-7).

Port and JAX agree within twice the tier's bound. The CUDA kernels are held
against the plain versions on a card in tests/test_torch_cuda.py.
"""

import functools
import warnings

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.linalg
import torch

import accblas_tpu_torch
from accblas_tpu.ops import common as jcommon
from accblas_tpu.ops import trsv as jtrsv
from accblas_tpu_torch.ops import trsv as ttrsv
from accblas_tpu_torch.utils import MatrixInfo, gen_mtx, interop

torch.set_num_threads(1)

_NP = {"f32": np.float32, "bf16": ml_dtypes.bfloat16, "f16": np.float16}
DF64_TOL = 5e-6


@functools.lru_cache(maxsize=None)
def _packed_lu(n, seed=42):
    a64 = gen_mtx(MatrixInfo(n, n), seed=seed)
    a64 += np.eye(n) * (0.25 * n)
    lu, _ = scipy.linalg.lu_factor(a64)
    b64 = gen_mtx(MatrixInfo(1, n), seed=seed + 1)[0]
    return lu, b64


def _stored(lu, st):
    """The packed factor in storage `st`, and its stored values in float64."""
    a = lu.astype(np.float32).astype(_NP[st])
    return a, a.astype(np.float64)


def _ref(t64, b64, uplo, unit):
    t = np.tril(t64) if uplo == "lower" else np.triu(t64)
    if unit:
        np.fill_diagonal(t, 1.0)
    return scipy.linalg.solve_triangular(t, b64, lower=(uplo == "lower"))


def _rel(got, ref):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref) if ref.ndim == 2 else \
        np.linalg.norm(got - ref, 1) / np.linalg.norm(ref, 1)


def _solve_both(fn, a, b, uplo, unit, **kw):
    """fn (a name of both packages' public API) on the same stored bits."""
    got = getattr(accblas_tpu_torch, fn)(interop.from_numpy(a), interop.from_numpy(b), uplo,
                                         unit, **kw)
    want = getattr(jtrsv, fn)(jnp.asarray(a), jnp.asarray(b), uplo, unit, **kw)
    return got, want


def _check(got, want, ref, tol):
    err = _rel(got, ref)
    assert err < tol, (err, tol)
    assert _rel(got, np.asarray(jnp.asarray(want, jnp.float32), np.float64)) < 2 * tol
    return err


@pytest.mark.parametrize("uplo,unit", [("upper", True), ("lower", True), ("upper", False),
                                       ("lower", False)])
def test_trsv_f32_all_modes(uplo, unit):
    lu, b64 = _packed_lu(512)
    a, a64 = _stored(lu, "f32")
    b = b64.astype(np.float32)
    got, want = _solve_both("trsv", a, b, uplo, unit)
    assert got.dtype == torch.float32 and got.shape == (512,)
    _check(got, want, _ref(a64, b.astype(np.float64), uplo, unit), 5e-5)


# unit-upper drops the factor's real diagonal and is ill-conditioned on most
# seeds (overflow at seed 7); seed 42 gives a solvable one at n = 700
@pytest.mark.parametrize("n,uplo,unit,seed", [(1024, "upper", False, 7), (1024, "lower", True, 7),
                                              (700, "upper", False, 7), (700, "lower", True, 7),
                                              (700, "upper", True, 42), (1000, "lower", False, 7)])
def test_trsv_multiblock_and_ragged(n, uplo, unit, seed):
    lu, b64 = _packed_lu(n, seed=seed)
    a, a64 = _stored(lu, "f32")
    b = b64.astype(np.float32)
    got, want = _solve_both("trsv", a, b, uplo, unit)
    _check(got, want, _ref(a64, b.astype(np.float64), uplo, unit), 1e-4)


@pytest.mark.parametrize("st,n,tol", [("bf16", 512, 1e-3), ("f16", 512, 6e-4),
                                      ("bf16", 700, 1e-3)])
def test_acc_trsv_f32_over_narrow_storage(st, n, tol):
    lu, b64 = _packed_lu(n, seed=3)
    a, a64 = _stored(lu, st)
    b = b64.astype(np.float32)
    got, want = _solve_both("acc_trsv", a, b, "upper", False, ar="f32")
    assert got.dtype == torch.float32
    _check(got, want, _ref(a64, b.astype(np.float64), "upper", False), tol)


def test_trsv_f16_storage_and_result():
    """f16 A and b: the result takes b's storage, as in the JAX package."""
    lu, b64 = _packed_lu(640, seed=11)
    a, a64 = _stored(lu, "f16")
    b = b64.astype(np.float16)
    got, want = _solve_both("trsv", a, b, "upper", False)
    assert got.dtype == torch.float16
    _check(got, want, _ref(a64, b.astype(np.float64), "upper", False), 6e-4)


@pytest.mark.parametrize("n,uplo,unit,st", [(512, "upper", False, "f32"),
                                            (512, "lower", True, "f32"),
                                            (700, "upper", False, "f32"),
                                            (1024, "upper", False, "f32"),
                                            (1024, "lower", True, "f32"),
                                            (512, "upper", False, "bf16")])
def test_acc_trsv_df64(n, uplo, unit, st):
    lu, b64 = _packed_lu(n, seed=61)
    a, a64 = _stored(lu, st)
    b = b64.astype(np.float32)
    ref = _ref(a64, b.astype(np.float64), uplo, unit)
    got, want = _solve_both("acc_trsv", a, b, uplo, unit, ar="df64")
    assert got.dtype == torch.float32
    err = _check(got, want, ref, DF64_TOL)
    e_f32 = _rel(accblas_tpu_torch.trsv(interop.from_numpy(a), interop.from_numpy(b), uplo,
                                        unit), ref)
    assert err <= max(e_f32, 5e-7), (err, e_f32)


@pytest.mark.parametrize("k,ar,uplo,unit,n", [(5, "f32", "upper", False, 700),
                                              (12, "f32", "lower", True, 512),
                                              (5, "df64", "lower", True, 700),
                                              (12, "df64", "upper", False, 768)])
def test_trsm(k, ar, uplo, unit, n):
    lu, _ = _packed_lu(n, seed=13)
    a, a64 = _stored(lu, "f32")
    bm = gen_mtx(MatrixInfo(k, n), seed=71).T.astype(np.float32)
    ref = _ref(a64, bm.astype(np.float64), uplo, unit)
    got, want = _solve_both("acc_trsm", a, bm, uplo, unit, ar=ar)
    assert got.shape == (n, k) and got.dtype == torch.float32
    err = _check(got, want, ref, DF64_TOL if ar == "df64" else 1e-4)
    if ar == "df64":
        e_f32 = _rel(accblas_tpu_torch.trsm(interop.from_numpy(a), interop.from_numpy(bm),
                                            uplo, unit), ref)
        assert err <= max(e_f32, 5e-7), (err, e_f32)


def test_trsm_matches_trsv_per_column():
    """The right-hand sides are independent: a column of TRSM is the TRSV of
    that column, in both tiers (to f32 rounding: the CPU's matrix products
    may sum in another order for one column than for three)."""
    lu, _ = _packed_lu(600, seed=23)
    a = torch.from_numpy(lu.astype(np.float32))
    bm = torch.from_numpy(gen_mtx(MatrixInfo(3, 600), seed=29).T.astype(np.float32))
    for ar in ("f32", "df64"):
        x = accblas_tpu_torch.acc_trsm(a, bm, "upper", False, ar=ar)
        for c in range(3):
            xc = accblas_tpu_torch.acc_trsv(a, bm[:, c].contiguous(), "upper", False, ar=ar)
            torch.testing.assert_close(x[:, c], xc, rtol=1e-5, atol=1e-6)


def test_main_path_operand_small():
    """The main path's operand at a small size: A = uniform(-1, 1)/n, upper,
    unit, b = ones (bench.py's TRSV), fixed f32 and Acc<df64, f32>."""
    n = 1024
    a = (gen_mtx(MatrixInfo(n, n), seed=5) / n).astype(np.float32)
    b = np.ones(n, np.float32)
    ref = _ref(a.astype(np.float64), b.astype(np.float64), "upper", True)
    got, want = _solve_both("trsv", a, b, "upper", True)
    _check(got, want, ref, 1e-4)
    got, want = _solve_both("acc_trsv", a, b, "upper", True, ar="df64")
    _check(got, want, ref, DF64_TOL)


def test_bf16_envelope_warns():
    n = 2048
    lu, b64 = _packed_lu(n, seed=79)
    ab = interop.from_numpy(lu.astype(np.float32), "bf16")
    b = torch.from_numpy(b64.astype(np.float32))
    with pytest.warns(UserWarning, match="bf16-storage"):
        accblas_tpu_torch.acc_trsv(ab, b, unit=False, ar="f32")
    with pytest.warns(UserWarning, match="bf16-storage"):
        accblas_tpu_torch.trsm(ab, b.reshape(n, 1), unit=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        accblas_tpu_torch.acc_trsv(ab, b, unit=False, ar="f32", unstable_ok=True)
        accblas_tpu_torch.acc_trsv(ab, b, unit=False, ar="df64")
        accblas_tpu_torch.trsv(ab[:1024, :1024], b[:1024], unit=False)


def test_resident_true_raises():
    """resident=True solves in the f32 tier (the blocked composition, the
    JAX package's resident mode) and still raises in df64, as there."""
    lu, b64 = _packed_lu(256, seed=81)
    a = torch.from_numpy(lu.astype(np.float32))
    b = torch.from_numpy(b64.astype(np.float32))
    ref = _ref(lu.astype(np.float32).astype(np.float64), b.double().numpy(), "upper", True)
    want = jtrsv.trsv(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), resident=True)
    for x in (accblas_tpu_torch.trsv(a, b, resident=True),
              accblas_tpu_torch.acc_trsv(a, b, ar="f32", resident=True),
              accblas_tpu_torch.trsm(a, b.reshape(-1, 1), resident=True).reshape(-1)):
        assert x.shape == (256,) and x.dtype == torch.float32
        _check(x, want, ref, 1e-4)
    with pytest.raises(ValueError, match="resident=True unsupported"):
        accblas_tpu_torch.acc_trsv(a, b, ar="df64", resident=True)
    with pytest.raises(ValueError, match="resident=True unsupported"):
        accblas_tpu_torch.acc_trsm(a, b.reshape(-1, 1), ar="df64", resident=True)
    # resident=False is the sweep, as the default is
    assert torch.equal(accblas_tpu_torch.trsv(a, b, resident=False),
                       accblas_tpu_torch.trsv(a, b))


def test_rejections():
    a = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="square"):
        accblas_tpu_torch.trsv(a[:, :7], torch.zeros(8))
    with pytest.raises(ValueError, match="matching b"):
        accblas_tpu_torch.trsv(a, torch.zeros(7))
    with pytest.raises(ValueError, match="kernel storage type"):
        accblas_tpu_torch.trsv(a.double(), torch.zeros(8))
    with pytest.raises(ValueError, match="kernel storage type"):
        accblas_tpu_torch.trsv(a, torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError, match="storage-only"):
        accblas_tpu_torch.acc_trsv(a, torch.zeros(8), ar="f8e4m3")
    with pytest.raises(NotImplementedError, match="arithmetic"):
        accblas_tpu_torch.acc_trsm(a, torch.zeros(8, 1), ar="bf16")


@pytest.mark.parametrize("uplo,unit", [("upper", False), ("lower", True)])
def test_xla_tiers(uplo, unit):
    lu, b64 = _packed_lu(512, seed=13)
    a, a64 = _stored(lu, "f32")
    b = b64.astype(np.float32)
    got, want = _solve_both("xla_trsv", a, b, uplo, unit)
    assert got.dtype == torch.float32
    _check(got, want, _ref(a64, b.astype(np.float64), uplo, unit), 5e-5)
    bm = np.stack([b, -2 * b], 1)
    got, want = _solve_both("xla_trsm", a, bm, uplo, unit)
    _check(got, want, _ref(a64, bm.astype(np.float64), uplo, unit), 5e-5)
    bb = interop.from_numpy(b, "bf16")
    assert accblas_tpu_torch.xla_trsv(torch.from_numpy(a), bb, uplo, unit).dtype == torch.bfloat16


@functools.lru_cache(maxsize=None)
def _jax_leaf_diag(st, n):
    """The JAX package's raw leaf gather (Pallas, interpret mode) of the
    seeded matrix in storage `st`, cut to n x n; the JAX kernel reads whole
    BLOCKs, so a ragged n is zero-padded for it (tri_mask masks past n)."""
    a = gen_mtx(MatrixInfo(1024, 1024), seed=31).astype(np.float32)
    ta = interop.from_numpy(a, st)[:n, :n].contiguous()
    nb = -(-n // ttrsv.BLOCK)
    pad = jnp.pad(jnp.asarray(ta.float().numpy()), ((0, nb * ttrsv.BLOCK - n),) * 2)
    return ta, jtrsv._extract_leaf_diag(pad, nb, ttrsv.BLOCK, ttrsv.LEAF, interpret=True)


@pytest.mark.parametrize("uplo,unit", [("upper", True), ("lower", True), ("upper", False),
                                       ("lower", False)])
@pytest.mark.parametrize("st", ["f32", "bf16", "f8e5m2"])
def test_leaf_gather_bits(st, uplo, unit):
    """The masked gather is the JAX kernel's gather followed by the JAX
    tri_mask, bit for bit: on an aligned matrix and on a ragged one, whose
    lanes past n continue as the identity."""
    lower = uplo == "lower"
    for n in (1024, 700):
        ta, raw = _jax_leaf_diag(st, n)
        m = raw.shape[0]
        got = ttrsv._extract_leaf_diag(ta, m, lower, unit)
        want = jcommon.tri_mask(raw, lower, unit, n=n,
                                offs=jnp.arange(m, dtype=jnp.int32) * ttrsv.LEAF)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if n % ttrsv.LEAF:
            np.testing.assert_array_equal(got[-1].numpy(), np.eye(ttrsv.LEAF, dtype=np.float32))


@pytest.mark.parametrize("n,uplo,unit", [(512, "upper", False), (700, "lower", True),
                                         (700, "upper", True)])
def test_leaf_inverses_match_jax(n, uplo, unit):
    """Phase 1: the masked leaf inverses (identity past n) against the JAX
    package's, transposed back; both are f32 triangular solves."""
    lu, _ = _packed_lu(n, seed=17)
    a = lu.astype(np.float32)
    nb = -(-n // ttrsv.BLOCK)
    lower = uplo == "lower"
    d = ttrsv._extract_leaf_diag(torch.from_numpy(a), nb * ttrsv.BLOCK // ttrsv.LEAF, lower, unit)
    got = ttrsv._leaf_inverses(d, lower)
    want = jtrsv._leaf_inverses(jnp.asarray(a), nb, ttrsv.BLOCK, ttrsv.LEAF, lower, unit,
                                True, n=n)
    want = np.asarray(want).reshape(-1, ttrsv.LEAF, ttrsv.LEAF).transpose(0, 2, 1)
    # normwise per leaf: a unit-upper leaf's inverse reaches 1e3, and its
    # small entries carry cancellation from the large ones
    diff = np.linalg.norm(got.numpy() - want, axis=(1, 2)) / np.linalg.norm(want, axis=(1, 2))
    assert diff.max() < 1e-5, diff.max()
    # padding leaves are the identity past n
    if n % ttrsv.BLOCK:
        last = got[-1].numpy()
        np.testing.assert_array_equal(last, np.eye(ttrsv.LEAF, dtype=np.float32))


@pytest.mark.parametrize("st", ["f32", "bf16", "f8e5m2"])
@pytest.mark.parametrize("n", [63, 512, 700])
@pytest.mark.parametrize("uplo,unit", [("upper", True), ("lower", True), ("upper", False),
                                       ("lower", False)])
def test_leaf_phase_plain_composes_the_three(uplo, unit, n, st):
    """Phase 1's plain version is the masked gather, the batched inversion
    and the panels composed, bit for bit, on A and b in storage `st` (b an
    (n, 3) strided view too); its inverses, transposed, are the JAX
    package's within test_leaf_inverses_match_jax's normwise bound, and
    the identity past n."""
    lower = uplo == "lower"
    lu, b64 = _packed_lu(n, seed=17)
    a = interop.from_numpy(lu.astype(np.float32), st)
    # e4m3 would hold the factor's n/4 diagonal as NaN; e5m2 holds it
    bm = interop.from_numpy(np.stack([b64, -b64, 2 * b64]).astype(np.float32), st).T
    nb = -(-n // ttrsv.BLOCK)
    m = nb * ttrsv.BLOCK // ttrsv.LEAF
    inv, bt = ttrsv._leaf_phase(a, bm, nb, lower, unit)
    assert torch.equal(inv, ttrsv._leaf_inverses(ttrsv._extract_leaf_diag_plain(a, m, lower, unit),
                                                 lower))
    assert torch.equal(bt, ttrsv._rhs_panels(bm, nb))
    assert torch.equal(bt[:, :n], bm.T.float()) and not bt[:, n:].any()
    want = jtrsv._leaf_inverses(jnp.asarray(a.float().numpy()), nb, ttrsv.BLOCK, ttrsv.LEAF,
                                lower, unit, True, n=n)
    want = np.asarray(want).reshape(-1, ttrsv.LEAF, ttrsv.LEAF).transpose(0, 2, 1)
    diff = np.linalg.norm(inv.numpy() - want, axis=(1, 2)) / np.linalg.norm(want, axis=(1, 2))
    assert diff.max() < 1e-5, diff.max()
    eye = np.eye(ttrsv.LEAF, dtype=np.float32)
    for pad in inv[-(-n // ttrsv.LEAF):]:
        np.testing.assert_array_equal(pad.numpy(), eye)
    tail = n % ttrsv.LEAF
    if tail:
        last = inv[n // ttrsv.LEAF].numpy()
        np.testing.assert_array_equal(last[tail:, :], eye[tail:, :])
        np.testing.assert_array_equal(last[:, tail:], eye[:, tail:])


@pytest.mark.parametrize("m,k,npad", [(8, 1, 512), (16, 5, 1024), (1, 3, 64)])
def test_leaf_phase_buffers_are_what_the_sweep_takes(m, k, npad):
    """The kernel route's one allocation: the inverses in the sweep's
    column-major layout, then the contiguous panels, both views of it."""
    buf, inv, bt = ttrsv._phase_buffers(m, k, npad, "cpu")
    ttrsv._check_inverses(inv, m * ttrsv.LEAF)
    assert inv.shape == (m, ttrsv.LEAF, ttrsv.LEAF) and inv.data_ptr() == buf.data_ptr()
    assert bt.shape == (k, npad) and bt.is_contiguous()
    assert bt.data_ptr() == buf.data_ptr() + 4 * m * ttrsv.LEAF**2
    assert buf.numel() == m * ttrsv.LEAF**2 + k * npad
    assert bt.data_ptr() % 16 == inv.data_ptr() % 16


def test_sweep_reads_the_inverses_as_the_solve_returns_them():
    """The batched solve returns column-major leaves, which the kernel
    wrapper takes as they are (no copy); it refuses any other layout."""
    d = ttrsv._extract_leaf_diag(torch.from_numpy(_packed_lu(128)[0].astype(np.float32)), 2,
                                 False, False)
    inv = ttrsv._leaf_inverses(d, False)
    ttrsv._check_inverses(inv, 128)
    for bad in (inv.contiguous(), inv[:, ::2], torch.zeros(2, 32, 32).mT):
        with pytest.raises(ValueError, match="not column-major"):
            ttrsv._check_inverses(bad, 128)
    with pytest.raises(ValueError, match="do not cover"):
        ttrsv._check_inverses(inv, 129)


@pytest.mark.parametrize("k", [None, 3])
def test_f64_rhs_in_the_f32_tier(k):
    """An f64 b in the f32 tier is cast to f32 once (the card's kernel
    route does the same): the solve is that of b cast to f32, bit for bit,
    returned as f64."""
    lu, b64 = _packed_lu(300)
    a = torch.from_numpy(lu.astype(np.float32))
    b = torch.from_numpy(b64) if k is None else torch.from_numpy(
        np.stack([b64 * (c + 1) for c in range(k)], 1))
    fn = accblas_tpu_torch.acc_trsv if k is None else accblas_tpu_torch.acc_trsm
    got = fn(a, b, "upper", False, ar="f32")
    assert got.dtype == torch.float64
    assert torch.equal(got, fn(a, b.float(), "upper", False, ar="f32").double())


def test_cpu_tensors_never_launch_the_kernels():
    before = (ttrsv.leaf_diag_launches, ttrsv.leaf_phase_launches, ttrsv.sweep_launches)
    lu, b64 = _packed_lu(300)
    a = torch.from_numpy(lu.astype(np.float32))
    b = torch.from_numpy(b64.astype(np.float32))
    accblas_tpu_torch.trsv(a, b, unit=False)
    accblas_tpu_torch.acc_trsm(a, torch.stack([b, b], 1), ar="df64")
    assert (ttrsv.leaf_diag_launches, ttrsv.leaf_phase_launches, ttrsv.sweep_launches) == before
