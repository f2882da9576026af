"""The main path on the accessor: the DOT, GEMV and TRSV sweep kernels and
their plain versions read and write through Ranges, as the JAX kernels do.

- Source check: the bodies of `dot_reduce` (csrc/dot.cu), `gemv_rows` and
  the helpers it calls (csrc/gemv.cu) and `trsv_sweep` and `load_tile`
  (csrc/trsv.cu) read no operand and write no result but through
  `csrc/range.cuh`: none of accessor.cuh's raw casts and loads, no subscript
  of, or arithmetic on, an operand's pointer. The sweep's published x
  (`publish`, `load_words`: tagged words) is its cross-CTA protocol, not an
  operand.
- The plain versions, which read through `accessor/range.py` (a counter on
  its Range shows it), still meet the JAX package's results at the
  tolerances tests/test_torch_{dot,gemv,trsv}.py state, at a ragged n, for
  every tier over each storage pair.

On the CPU the JAX side runs as its own tests run it here (the Pallas kernels
in interpret mode). The kernels themselves are held against the plain
versions on a card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.linalg
import torch

from accblas_tpu.ops import df64 as jdf
from accblas_tpu.ops import dot as jdot
from accblas_tpu.ops import gemv as jgemv
from accblas_tpu.ops import trsv as jtrsv
from accblas_tpu_torch.accessor import range as trange
from accblas_tpu_torch.accessor.range import make_range
from accblas_tpu_torch.ops import df64 as tdf
from accblas_tpu_torch.ops import dot as tdot
from accblas_tpu_torch.ops import gemv as tgemv
from accblas_tpu_torch.ops import trsv as ttrsv
from accblas_tpu_torch.utils import MatrixInfo, gen_mtx, interop, tolerance

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "accblas_tpu_torch" / "csrc"
TIERS = ("f32", "bf16", "f16", "df64_fast", "df64_precise")
_NP = {"f8e4m3": ml_dtypes.float8_e4m3fn, "f8e5m2": ml_dtypes.float8_e5m2,
       "bf16": ml_dtypes.bfloat16, "f16": np.float16, "f32": np.float32}
# every storage with itself, and mixed pairs across widths
PAIRS = (("f32", "f32"), ("bf16", "bf16"), ("f16", "f16"), ("f8e4m3", "f8e4m3"),
         ("f8e5m2", "f8e5m2"), ("f32", "bf16"), ("bf16", "f8e4m3"), ("f16", "f8e5m2"))
DF64_TOL = 5e-6  # tests/test_torch_trsv.py's df64 bound

# ---- source check -------------------------------------------------------

# accessor.cuh's raw reads and writes, which a body on range.cuh never calls
FORBIDDEN = ("load_pack<", "load_pack_stream<", "load_f32(", "load_code(", "store_code(",
             "store_f32(", "unpack(")
# (file, function, its operand and result pointers, what shows it reads
# through range.cuh)
KERNELS = [
    ("dot.cu", "dot_reduce", ("x", "y"),
     ("range_t<", "stream_pack<V>", "add_steps<kSteps, XRow, YRow>", ".get(0, j)")),
    ("gemv.cu", "gemv_rows", ("A", "x", "res", "out", "out_lo"), ("range_t<",)),
    ("gemv.cu", "gemv_group", ("A", "x", "res", "out", "out_lo"), (".row(",)),
    ("gemv.cu", "rows_sum", ("x",), ("in_row<SA> (&row)[R]", "XR x")),
    ("gemv.cu", "lane_sum", ("x",), (".from(",)),
    ("gemv.cu", "vec_steps", ("x",), ("pack<V>(", "::widen(")),
    # the staged x's overload (its second definition), and its x reader
    ("gemv.cu", "vec_steps#1", ("x",), ("StagedX<V>& x", "pack<V>(", "::widen_paired(",
                                        "x.load(")),
    ("gemv.cu", "load", ("x",), ("float (&v)[V]", "r.row(", ".template load<P>(")),
    ("gemv.cu", "store_row", ("res", "out"), ("(i, 0)",)),
    ("gemv.cu", "gemv_staged", ("A", "x", "res", "out", "out_lo"),
     ("range_t<", "stage_x<V, SX>(", "StagedX<V>")),
    ("gemv.cu", "stage_x", ("x",), (".from(", "widen_paired(", "store<P>(", "xs.row(")),
    ("trsv.cu", "trsv_sweep", ("A", "bt", "out"), ("range_t<", ".row(")),
    ("trsv.cu", "load_tile", ("arow",), (".from(c0)", "load<V>(")),
    # phase 1: the masked gather leaf_diag and leaf_phase share, and
    # leaf_phase's b, panels and inverses
    ("trsv.cu", "gather_leaf", ("ra",), (".row(row).from(col)", "load<V>(")),
    ("trsv.cu", "leaf_phase", ("A", "b", "bt", "inv"),
     ("range_t<float, const SA>", "range_t<float, const Coded>", "gather_leaf<SA>(")),
]


def _strip_comments(src: str) -> str:
    return re.sub(r"//[^\n]*", "", src)


def _definition(src: str, name: str) -> tuple[str, str]:
    """The parameter list and the body of function `name`'s definition: the
    first `name(...)` followed by `{` (or `const {`), brace-matched; `name#k`, the
    definition after k others of that name."""
    name, _, skip = name.partition("#")
    skip = int(skip or 0)
    for m in re.finditer(rf"\b{name}\s*\(", src):
        depth, i = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(src[i], 0)
            i += 1
        if re.match(r"\s*(const\s*)?\{", src[i:]):  # a member function may be const
            start = src.index("{", i)
            depth, j = 1, start + 1
            while depth:
                depth += {"{": 1, "}": -1}.get(src[j], 0)
                j += 1
            if skip == 0:
                return src[m.end():i - 1], src[start:j]
            skip -= 1
    raise AssertionError(f"no definition of {name}")


def _body(src: str, name: str) -> str:
    return _definition(src, name)[1]


@pytest.mark.parametrize("path,name,operands,through", KERNELS,
                         ids=[k[1] for k in KERNELS])
def test_kernel_reads_and_writes_through_range(path, name, operands, through):
    params, body = _definition(_strip_comments((CSRC / path).read_text()), name)
    for token in FORBIDDEN:
        assert token not in body, f"{name} calls {token}"
    for p in operands:
        # an operand's pointer only builds a Range (or is passed on): never
        # subscripted, offset or dereferenced
        assert not re.search(rf"(?<![\w.]){p}\s*\[", body), f"{name} subscripts {p}"
        assert not re.search(rf"(?<![\w.]){p}\s*[+-]\s*[\w(]", body), f"{name} offsets {p}"
        assert not re.search(rf"\*\s*{p}\b", body), f"{name} dereferences {p}"
    for token in through:
        assert token in params + body, f"{name} lacks {token}"


def test_sweep_keeps_its_published_x_protocol():
    """The published x stays on the sweep's own L2 path: tagged words of
    xhi/xlo stored by publish and read by load_words, at GPU scope, never
    an accessor read (L1 is not coherent across CTAs within a launch)."""
    src = _strip_comments((CSRC / "trsv.cu").read_text())
    sweep = _body(src, "trsv_sweep")
    assert "publish(xhi" in sweep and "publish(xlo" in sweep
    assert "load_words(w, xhi" in sweep
    tile = _body(src, "add_tile")
    assert "await_words(w, xhi" in tile and "xlo" in tile and "load_words(rest" in tile
    assert "st.relaxed.gpu.global.b64" in _body(src, "publish")
    assert "ld.relaxed.gpu.global.v2.b64" in _body(src, "load_words")
    assert "load_words(" in _body(src, "await_words")


def test_range_header_states_its_additions():
    """range.cuh's header states what the main path needed of it: a row's
    stored values as read (pack), a row moved along (from), a value read
    with no Ref (get), and a range of run-time storage (Coded)."""
    head = (CSRC / "range.cuh").read_text().split("#pragma once")[0]
    for token in ("row.pack<V>(j)", "row.from(c)", "r.get(i, j)", "Coded", "(rows, W)"):
        assert token in head, token


# ---- the plain versions read through accessor/range.py --------------------

@pytest.fixture
def range_calls(monkeypatch):
    """Counts of Range.load, load_raw, store and window calls."""
    calls = {"load": 0, "load_raw": 0, "store": 0, "window": 0}
    for name in calls:
        real = getattr(trange.Range, name)

        def counted(self, *a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(self, *a, **kw)

        monkeypatch.setattr(trange.Range, name, counted)
    return calls


@pytest.mark.parametrize("tier", TIERS)
def test_dot_plain_reads_through_range(range_calls, tier):
    x = torch.linspace(-1, 1, 1001)
    ar, precise = _ar(tier)
    tdot.acc_dot(x, x.to(torch.bfloat16), ar, precise=precise)
    assert range_calls["load"] + range_calls["load_raw"] >= 2


@pytest.mark.parametrize("tier", TIERS)
def test_gemv_plain_reads_and_writes_through_range(range_calls, tier):
    a = torch.linspace(-1, 1, 12 * 37).view(12, 37)
    ar, precise = _ar(tier)
    tgemv.acc_gemv(a, a[0], a[:, 1].contiguous(), 1.5, -0.5, ar, precise=precise)
    assert range_calls["load"] + range_calls["load_raw"] >= 3  # A, x, res
    assert range_calls["store"] == 1


def test_gemv_plain_df_out_writes_two_f32_ranges(range_calls):
    a = torch.linspace(-1, 1, 12 * 37).view(12, 37)
    out = tgemv.acc_gemv(a, a[0], a[:, 1].contiguous(), 1.5, -0.5, "df64", df_out=True)
    assert isinstance(out, tdf.DF) and range_calls["store"] == 2


@pytest.mark.parametrize("ar", ["f32", "df64"])
def test_trsv_sweep_plain_reads_and_writes_through_range(range_calls, ar):
    n = 600
    a = torch.eye(n) * 2 + torch.linspace(-1, 1, n * n).view(n, n).triu() / n
    ttrsv.acc_trsv(a, torch.ones(n), "upper", False, ar=ar, resident=False)
    # every (row block, column block) of the triangle through a window
    assert range_calls["window"] == 3 and range_calls["store"] == 1


@pytest.mark.parametrize("const", [True, False])
def test_range_window_is_a_view(const):
    data = torch.arange(48, dtype=torch.float32).view(6, 8)
    r = make_range("f32", "bf16", data.to(torch.bfloat16), const=const)
    w = r.window(2, 3, 3, 4)
    assert w.shape == (3, 4) and w.const == const
    torch.testing.assert_close(w.load(), data[2:5, 3:7])
    if const:
        with pytest.raises(TypeError):
            w.store(torch.zeros(3, 4))
    else:
        w.store(torch.full((3, 4), 0.5))
        assert (r.load()[2:5, 3:7] == 0.5).all() and r.load()[0, 0] == 0


# ---- the plain versions against the JAX package ---------------------------

def _ar(tier: str):
    return ("df64", tier == "df64_precise") if tier.startswith("df64") else (tier, False)


def _vec(n: int, seed: int, st: str) -> np.ndarray:
    return gen_mtx(MatrixInfo(1, n), seed=seed)[0].astype(np.float32).astype(_NP[st])


def _f64(out) -> np.ndarray:
    if isinstance(out, tdf.DF):
        return tdf.df_to_f64(out).numpy()
    if isinstance(out, jdf.DF):
        return np.asarray(jdf.df_to_f64(out))
    if isinstance(out, torch.Tensor):
        return out.double().numpy()
    return np.asarray(jnp.asarray(out, jnp.float32), np.float64)


def _check_tier(tier, err, jerr, gap, tol_scale=1.0):
    """tests/test_torch_dot.py's and test_torch_gemv.py's rule: a tier with
    a bound meets it and lies within twice it of JAX; a narrow tier within
    tolerance.narrow_bound of JAX's own error."""
    if tier in tolerance.TOL:
        tol = tolerance.TOL[tier]
        assert err <= tol, (err, tol)
        assert gap <= 2 * tol, (gap, tol)
    else:
        assert err <= tolerance.narrow_bound(jerr), (err, jerr)


@pytest.mark.parametrize("sx,sy", PAIRS)
@pytest.mark.parametrize("tier", TIERS)
def test_dot_plain_meets_jax_ragged(tier, sx, sy):
    n = 12345  # tests/test_torch_dot.py's size: no multiple of any vector width
    x, y = _vec(n, 42, sx), _vec(n, 43, sy)
    ar, precise = _ar(tier)
    got = _f64(tdot.acc_dot(interop.from_numpy(x), interop.from_numpy(y), ar,
                            precise=precise, init=0.5))
    want = _f64(jdot.acc_dot(jnp.asarray(x), jnp.asarray(y), ar, precise=precise, init=0.5))
    ref = float(x.astype(np.float64) @ y.astype(np.float64)) + 0.5
    den = abs(ref)
    _check_tier(tier, abs(got - ref) / den, abs(want - ref) / den, abs(got - want) / den)


@pytest.mark.parametrize("sa,sx", PAIRS)
@pytest.mark.parametrize("tier", TIERS)
def test_gemv_plain_meets_jax_ragged(tier, sa, sx):
    m, n = 24, 301
    a = gen_mtx(MatrixInfo(m, n), seed=5).astype(np.float32).astype(_NP[sa])
    x = _vec(n, 6, sx)
    r = _vec(m, 7, "f32")
    alpha, beta = 1.5, -0.5
    ar, precise = _ar(tier)
    got = tgemv.acc_gemv(*(interop.from_numpy(v) for v in (a, x, r)), alpha, beta, ar,
                         precise=precise)
    want = jgemv.acc_gemv(*(jnp.asarray(v) for v in (a, x, r)), alpha, beta, ar,
                          precise=precise)
    assert got.dtype == torch.float32 and got.shape == (m,)
    a64, x64, r64 = a.astype(np.float64), x.astype(np.float64), r.astype(np.float64)
    ref = torch.from_numpy(alpha * (a64 @ x64) + beta * r64)
    scale = torch.from_numpy(abs(alpha) * (np.abs(a64) @ np.abs(x64)) + abs(beta) * np.abs(r64))
    g, w = torch.from_numpy(_f64(got)), torch.from_numpy(_f64(want))
    assert torch.isfinite(g).all()

    def err(v, of):
        return tolerance.gemv_row_err(v, of, scale, torch.float32)

    _check_tier(tier, err(g, ref), err(w, ref), err(g, w))


# ---- TRSV: tests/test_torch_trsv.py's operand and bounds, at ragged n -----

_TRSV_TOL = {("f32", "f32"): 1e-4, ("f32", "bf16"): 1e-3, ("f32", "f16"): 6e-4,
             ("df64", "f32"): DF64_TOL, ("df64", "bf16"): DF64_TOL, ("df64", "f16"): DF64_TOL}


def _packed_lu(n: int, seed: int):
    a64 = gen_mtx(MatrixInfo(n, n), seed=seed)
    a64 += np.eye(n) * (0.25 * n)
    lu, _ = scipy.linalg.lu_factor(a64)
    return lu


def _rel(got, ref) -> float:
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("ar,st", list(_TRSV_TOL), ids=[f"{a}-{s}" for a, s in _TRSV_TOL])
def test_trsv_sweep_plain_meets_jax_ragged(ar, st, k):
    n = 700  # one full block of 512 and a ragged one
    a = _packed_lu(n, seed=3).astype(np.float32).astype(_NP[st])
    t64 = np.triu(a.astype(np.float64))
    b = gen_mtx(MatrixInfo(k, n), seed=71).T.astype(np.float32)
    ref = scipy.linalg.solve_triangular(t64, b.astype(np.float64))
    got = ttrsv.acc_trsm(interop.from_numpy(a), interop.from_numpy(b), "upper", False, ar=ar,
                         resident=False)
    want = jtrsv.acc_trsm(jnp.asarray(a), jnp.asarray(b), "upper", False, ar=ar)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    tol = _TRSV_TOL[(ar, st)]
    err = _rel(got.double().numpy(), ref)
    assert err < tol, (err, tol)
    assert _rel(got.double().numpy(), want) < 2 * tol
