"""The port's column sums (accblas_tpu_torch.ops.colsum) and its f8 GEMV probe
(accblas_tpu_torch.bench.probe_r4a) against the TPU probe scripts/probe_r4a.py.

The JAX side is the probe's own Pallas kernel, ``conv_kernel``, taken from
the script by parsing it (importing the script would run its 24576^2 TPU
benchmark) and run through ``pl.pallas_call`` in interpret mode with the
probe's grid order (row blocks on the minor axis). Its sum order within a
block is XLA's, so the two agree within the sum of their float64 bounds,
not bit for bit. The port's plain version is held bit for bit to a numpy
float32 loop in the kernel's documented order.

Tolerance: a column sum of m values whose longest chain of f32 adds is d
errs at most (d + 1) 2^-24 sum_i |a_ij| against float64; the port's d is
the chunk height plus the number of chunks, the JAX kernel's the block
height plus the number of row blocks.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import jax
from accblas_tpu.ops.common import interpret_default
from accblas_tpu.utils import devgen as jax_devgen
from accblas_tpu_torch.bench import probe_r4a
from accblas_tpu_torch.ops import colsum
from accblas_tpu_torch.utils import devgen

ROOT = Path(__file__).resolve().parents[1]
PROBE = ROOT / "scripts" / "probe_r4a.py"
U = 2.0**-24
F8 = torch.float8_e4m3fn

torch.set_num_threads(1)


def _conv_kernel():
    """conv_kernel of scripts/probe_r4a.py, compiled alone from the script."""
    tree = ast.parse(PROBE.read_text(), str(PROBE))
    (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "conv_kernel"]
    assert fn.lineno == 93  # the line the port's kernel record names
    ns = {"jnp": jnp, "pl": pl}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(PROBE), "exec"), ns)
    return ns["conv_kernel"]


def _jax_col_sums(a, bm: int, bn: int):
    """The probe's pallas_call (scripts/probe_r4a.py:111-119) at N = a's
    side and blocks (bm, bn): grid (column blocks, row blocks), rows minor."""
    n = a.shape[0]
    conv = pl.pallas_call(
        _conv_kernel(),
        grid=(n // bn, n // bm),
        in_specs=[pl.BlockSpec((bm, bn), lambda jb, ib: (ib, jb))],
        out_specs=pl.BlockSpec((1, bn), lambda jb, ib: (0, jb)),
        out_shape=jax.ShapeDtypeStruct((1, n), jnp.float32),
        interpret=interpret_default(),
    )
    return np.asarray(conv(a), np.float64)


def _f8_operand(n: int, seed: int):
    """The same float8_e4m3fn values as a JAX array and a torch tensor, and
    as float64: numpy uniform(-1, 1) draws rounded to e4m3."""
    v = np.random.default_rng(seed).uniform(-1, 1, (n, n)).astype(np.float32)
    j = jnp.asarray(v).astype(jnp.float8_e4m3fn)
    v64 = np.asarray(j.astype(jnp.float32), np.float64)
    return j, torch.from_numpy(v64.astype(np.float32)).to(F8), v64


def _err(got, v64) -> float:
    """max_j |got_j - sum_i v_ij| / sum_i |v_ij|."""
    got = np.asarray(got, np.float64).reshape(-1)
    scale = np.maximum(np.abs(v64).sum(0), np.finfo(np.float64).tiny)
    return float((np.abs(got - v64.sum(0)) / scale).max()) if got.size else 0.0


def _order_np(v32: np.ndarray, rows: int) -> np.ndarray:
    """The kernel's documented order in numpy float32: each chunk of `rows`
    rows in row order from +0, then the chunk sums in chunk order from +0."""
    m, n = v32.shape
    out = np.zeros(n, np.float32)
    for c0 in range(0, m, rows):
        s = np.zeros(n, np.float32)
        for i in range(c0, min(c0 + rows, m)):
            s = s + v32[i]
        out = out + s
    return out


# ---------------------------------------------------------------- the JAX kernel

# the probe's (256, 1024), (512, 512) and (32, 128) blocks at N = 24576,
# scaled to N: the first two keep their aspect over 8 and 4 row blocks, the
# third stays as it is
BLOCKS = {512: [(64, 256), (128, 128), (32, 128)], 1024: [(128, 512), (256, 256), (32, 128)]}


@pytest.mark.parametrize("n,bm,bn", [(n, bm, bn) for n, bl in BLOCKS.items() for bm, bn in bl])
def test_col_sums_against_the_probe_conv_kernel(n, bm, bn):
    j, t, v64 = _f8_operand(n, seed=n + bm)
    want = _jax_col_sums(j, bm, bn)
    jax_bound = (bm + n // bm + 1) * U
    for rows in (None, 64):
        got = colsum.col_sums(t, rows)
        port_bound = probe_r4a.colsum_bound(n, rows or colsum.ROWS_PER_BLOCK)
        assert got.shape == (1, n) and got.dtype == torch.float32
        assert _err(got.numpy(), v64) <= port_bound
        assert _err(want, v64) <= jax_bound
        # the two against each other, within the sum of their bounds
        scale = np.abs(v64).sum(0)
        gap = np.abs(got.double().numpy().reshape(-1) - want.reshape(-1)) / scale
        assert gap.max() <= port_bound + jax_bound


def test_col_sums_against_the_probe_conv_kernel_where_sums_round():
    """f8e4m3 values are multiples of 2^-9 below 448, so their column sums
    here are exact in f32 in any order. The Pallas body converts whatever
    block it is given: on f32 storage the sums round and the two orders
    differ, each within its bound."""
    n, bm, bn = 512, 64, 256
    v = np.random.default_rng(11).uniform(-1, 1, (n, n)).astype(np.float32)
    v64 = v.astype(np.float64)
    got = colsum.col_sums(torch.from_numpy(v)).double().numpy().reshape(-1)
    want = _jax_col_sums(jnp.asarray(v), bm, bn).reshape(-1)
    port_bound = probe_r4a.colsum_bound(n, colsum.ROWS_PER_BLOCK)
    jax_bound = (bm + n // bm + 1) * U
    assert not np.array_equal(got, v64.sum(0))  # some sum rounded
    assert _err(got, v64) <= port_bound and _err(want, v64) <= jax_bound
    assert (np.abs(got - want) / np.abs(v64).sum(0)).max() <= port_bound + jax_bound


# ---------------------------------------------------------------- the operand

@pytest.mark.parametrize("role,shape", [("p4a_a", (256, 256)), ("p4a_x", (256,))])
def test_probe_operand_equals_the_jax_draw(role, shape):
    """gen_f32 cast to float8_e4m3fn: the JAX probe's a8 and x8, bit for bit."""
    got = devgen.gen_f32(shape, 42, role, device="cpu").to(F8).view(torch.uint8).numpy()
    want = np.asarray(jax_devgen.gen_f32(shape, 42, role).astype(jnp.float8_e4m3fn))
    np.testing.assert_array_equal(got, want.view(np.uint8))


# ---------------------------------------------------------------- the port alone

_TORCH = {"f8e4m3": F8, "f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("st", list(_TORCH))
@pytest.mark.parametrize("m,n", [(1, 1), (3, 17), (1000, 1003)])
@pytest.mark.parametrize("rows", [None, 7])
def test_col_sums_ragged_and_every_storage(m, n, st, rows):
    """Bit for bit the kernel's documented order (a numpy float32 loop), and
    within the float64 bound."""
    v = np.random.default_rng(m * n).standard_normal((m, n)).astype(np.float32)
    t = torch.from_numpy(v).to(_TORCH[st])
    v32 = t.float().numpy()
    got = colsum.col_sums(t, rows)
    assert got.shape == (1, n) and got.dtype == torch.float32
    chunk = rows or colsum.ROWS_PER_BLOCK
    np.testing.assert_array_equal(got.numpy().reshape(-1).view(np.uint32),
                                  _order_np(v32, chunk).view(np.uint32))
    assert _err(got.numpy(), v32.astype(np.float64)) <= probe_r4a.colsum_bound(m, chunk)


def test_col_sums_edges_and_refusals():
    assert torch.equal(colsum.col_sums(torch.zeros(0, 5, dtype=F8)), torch.zeros(1, 5))
    assert colsum.col_sums(torch.zeros(4, 0)).shape == (1, 0)
    # one chunk, many chunks and a chunk of one row give the same sums here
    # only where the sums are exact: f8 values of one binade
    a = torch.full((300, 40), 0.5).to(F8)
    for rows in (1, 64, 300, 1000):
        assert torch.equal(colsum.col_sums(a, rows), torch.full((1, 40), 150.0))
    with pytest.raises(ValueError, match="contiguous"):
        colsum.col_sums(torch.zeros(8, 8).t()[:, :5])
    with pytest.raises(ValueError, match="contiguous 2-D"):
        colsum.col_sums(torch.zeros(8))
    with pytest.raises(ValueError, match="positive"):
        colsum.col_sums(torch.zeros(8, 8), 0)
    with pytest.raises(ValueError, match="storage"):
        colsum.col_sums(torch.zeros(8, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="chunks"):
        colsum.col_sums(torch.zeros(70000, 1), 1)
    before = colsum.launches
    colsum.col_sums(torch.ones(5, 5))
    assert colsum.launches == before  # the plain version launches nothing


def test_vector_path_choice():
    buf = torch.zeros(64 * 48 + 16, dtype=F8)
    assert colsum.vector_path(buf[:64 * 48].view(64, 48))
    assert not colsum.vector_path(buf[1:64 * 48 + 1].view(64, 48))  # base one byte off
    assert not colsum.vector_path(torch.zeros(4, 40, dtype=F8))  # a row of 40 bytes
    assert colsum.vector_path(torch.zeros(4, 4))  # f32: a row of 16 bytes


# ---------------------------------------------------------------- the probe

def test_probe_runs_on_the_cpu(capsys):
    out = probe_r4a.main(["--n", "256", "--device", "cpu"])
    text = capsys.readouterr().out
    tags = [line.split()[0] for line in text.splitlines()[1:]]
    assert tags[:3] == ["A", "B", "C"] and tags.count("D") == 2 and tags.count("E") == 3
    assert "not timed on the CPU" in text
    a8, _, _ = probe_r4a.operands(256, "cpu")
    for rows in probe_r4a.E_ROWS:
        assert torch.equal(out[f"E{rows}"]["out"], colsum.col_sums(a8, rows))
    for key in ("A", "B", "C"):
        assert out[key]["err"] <= out[key]["bound"] and out[key]["ms"] is None


def test_probe_refuses_without_a_card_and_off_its_tiling():
    env_code = ("import sys; from accblas_tpu_torch.bench import probe_r4a; "
                "probe_r4a.main(sys.argv[1:])")
    res = subprocess.run([sys.executable, "-c", env_code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 2 and "no CUDA device" in res.stderr
    with pytest.raises(SystemExit):
        probe_r4a.main(["--n", "250", "--device", "cpu"])


def test_colsum_and_probe_import_no_jax():
    code = ("import sys, accblas_tpu_torch.ops.colsum, accblas_tpu_torch.bench.probe_r4a; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'accblas_tpu')); print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
