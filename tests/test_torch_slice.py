"""The port as a whole: the flagship ops through both packages' public APIs
on the same seeded data, the public surface, and the port's independence
from JAX."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import accblas_tpu
import accblas_tpu_torch
from __graft_entry__ import entry
from accblas_tpu_torch.ops import dot as tdot
from accblas_tpu_torch.ops import gemv as tgemv
from accblas_tpu_torch.ops import tri_gemv as ttri
from accblas_tpu_torch.ops import trsv as ttrsv
from accblas_tpu_torch.utils import MatrixInfo, gen_mtx, interop, tolerance

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _flagship_inputs(device="cpu"):
    """The operands of __graft_entry__.entry(), built on the port's side."""
    m, n = 1024, 2048
    a = interop.from_numpy(gen_mtx(MatrixInfo(m, n), seed=42).astype(np.float32), "bf16", device)
    x = interop.from_numpy(gen_mtx(MatrixInfo(1, n), seed=43)[0].astype(np.float32), "bf16",
                           device)
    r = interop.from_numpy(gen_mtx(MatrixInfo(1, m), seed=44)[0].astype(np.float32),
                           device=device)
    return a, x, r


def _gemv_err(out, a, x, r):
    a64, x64 = a.double().cpu(), x.double().cpu()
    ref = a64 @ x64 + r.double().cpu()
    scale = a64.abs() @ x64.abs() + r.double().abs().cpu()
    return tolerance.gemv_row_err(out.double().cpu(), ref, scale, torch.float32), ref, scale


def test_flagship_gemv_matches_entry():
    fn, (ja, jx, jr) = entry()
    want = np.array(jax.jit(fn)(ja, jx, jr))
    a, x, r = _flagship_inputs()
    # the same stored bits on both sides
    np.testing.assert_array_equal(a.float().numpy(), np.asarray(ja, np.float32))
    np.testing.assert_array_equal(x.float().numpy(), np.asarray(jx, np.float32))
    got = accblas_tpu_torch.acc_gemv(a, x, r, 1.0, 1.0, ar="f32")
    assert got.dtype == torch.float32 and got.shape == (1024,)
    err, _, scale = _gemv_err(got, a, x, r)
    tol = tolerance.TOL["f32"]
    assert err <= tol
    assert tolerance.gemv_row_err(got.double(), torch.from_numpy(want).double(), scale,
                                  torch.float32) <= 2 * tol


def test_headline_dot_acc_f32_bf16_matches_jax():
    n = 3 * 2**15 + 77
    x64 = gen_mtx(MatrixInfo(1, n), seed=42)[0]
    y64 = gen_mtx(MatrixInfo(1, n), seed=43)[0]
    jx = jnp.asarray(x64, jnp.float32).astype(jnp.bfloat16)
    jy = jnp.asarray(y64, jnp.float32).astype(jnp.bfloat16)
    want = float(accblas_tpu.acc_dot(jx, jy, ar="f32"))
    tx = interop.from_numpy(x64.astype(np.float32), "bf16")
    ty = interop.from_numpy(y64.astype(np.float32), "bf16")
    got = accblas_tpu_torch.acc_dot(tx, ty, ar="f32")
    assert got.dtype == torch.float32 and got.dim() == 0
    ref = float(tx.double() @ ty.double())
    tol = tolerance.TOL["f32"]
    assert abs(float(got) - ref) / abs(ref) <= tol
    assert abs(float(got) - want) / abs(ref) <= 2 * tol


def test_public_surface_mirrors_the_reference():
    for name in accblas_tpu_torch.__all__:
        assert name in accblas_tpu.__all__
        assert callable(getattr(accblas_tpu_torch, name))
    missing = set(accblas_tpu.__all__) - set(accblas_tpu_torch.__all__)
    assert missing == set()


def test_port_imports_no_jax():
    code = (
        "import sys, accblas_tpu_torch, accblas_tpu_torch.ops.dot, accblas_tpu_torch.ops.gemv, "
        "accblas_tpu_torch.ops.trsv, accblas_tpu_torch.ops.tri_gemv, "
        "accblas_tpu_torch.ops._build, accblas_tpu_torch.ops.common, "
        "accblas_tpu_torch.utils.bench, accblas_tpu_torch.utils.tolerance, "
        "accblas_tpu_torch.ops.oracle, accblas_tpu_torch.utils.devgen, "
        "accblas_tpu_torch.utils.sr, accblas_tpu_torch.utils.memory, "
        "accblas_tpu_torch.native.host, accblas_tpu_torch.bench.common, "
        "accblas_tpu_torch.bench.dot_benchmark, accblas_tpu_torch.bench.gemv_benchmark, "
        "accblas_tpu_torch.bench.trsv_benchmark, accblas_tpu_torch.bench.plot; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'accblas_tpu')); print(bad); sys.exit(1 if bad else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # hide any card
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and "kernels" not in res.stdout


def _launches():
    return (tdot.launches, tgemv.launches, ttrsv.leaf_diag_launches, ttrsv.sweep_launches,
            ttri.launches)


def test_plain_path_on_cpu_launches_nothing():
    a, x, r = _flagship_inputs()
    before = _launches()
    accblas_tpu_torch.acc_gemv(a, x, r, 1.0, 1.0, ar="f32")
    accblas_tpu_torch.acc_dot(x, x, ar="f32")
    n = 600
    t = torch.triu(interop.from_numpy(gen_mtx(MatrixInfo(n, n), seed=45).astype(np.float32)) / n)
    b = torch.ones(n)
    accblas_tpu_torch.trsv(t, b)
    accblas_tpu_torch.acc_trsv(t, b, ar="df64")
    ttri.tri_gemv_df64(t, b, b)
    assert _launches() == before
