"""The port's benchmark drivers (accblas_tpu_torch.bench) with --device cpu at
small sizes, mirroring tests/test_bench_drivers.py and
tests/test_utils_harness.py, and the solver driver: the CSV header is the
JAX driver's but for the vendor columns' names, the error cells sit within
the JAX driver tests' bounds, speed mode names its host clock, and without
a card the drivers refuse --device cuda."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from accblas_tpu.bench import common as jcommon
from accblas_tpu.bench import dot_benchmark as jdot
from accblas_tpu.bench import gemv_benchmark as jgemv
from accblas_tpu_torch.bench import (common, dot_benchmark, gemv_benchmark, plot,
                                     solvers_benchmark, trsv_benchmark)
from accblas_tpu_torch.utils import bench

torch.set_num_threads(1)

RESULTS = Path(__file__).resolve().parents[1] / "bench_results"


def _run_main(module, argv, capsys):
    module.main(argv + ["--device", "cpu"])
    cap = capsys.readouterr()
    out = cap.out.strip().splitlines()
    return out[0].split(";"), [ln.split(";") for ln in out[1:]], cap.err


def _vals(header, row):
    return dict(zip(header[1:], map(float, row[1:])))


def _jax_header(csv: str):
    """The JAX driver's header, from its CSV in bench_results/, in the
    port's names."""
    with open(RESULTS / csv) as f:
        return [common.vendor_name(c) for c in f.readline().strip().split(";")]


@pytest.fixture
def lu_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("ACCBLAS_TORCH_CACHE", str(tmp_path))
    return tmp_path


def test_dot_driver_error_mode(capsys):
    header, rows, err = _run_main(
        dot_benchmark, ["--error", "--size=1048576", "--sweep=single", "--randomizations=2"],
        capsys)
    assert header == ["n"] + [common.vendor_name(v[0]) for v in jdot.VARIANTS]
    assert header == _jax_header("dot_error.csv")
    assert "host master data:" in err
    assert len(rows) == 1 and len(rows[0]) == len(header)
    vals = _vals(header, rows[0])
    # accessor df64 must sit at/below the f32 storage floor; bf16 tiers worse
    assert vals["DOT Acc<df64,f32>"] < 1e-6
    assert vals["DOT Acc<f32,bf16>"] < 0.02
    assert vals["DOT bf16"] > vals["DOT Acc<df64,f32>"]
    assert vals["DOT df64 oracle (device)"] < 1e-12


def test_dot_driver_reproduces_the_v5e_row(capsys):
    """The port draws the JAX package's data, so the data-set cells of the
    DOT error CSV (the df64 tiers over bf16 and f32 storage, whose error is
    the storage rounding's) reproduce the committed v5e row at n = 16384
    over the reference's 10 randomizations: a different draw moves them by
    10-30%."""
    header, rows, _ = _run_main(dot_benchmark, ["--error", "--size=16384", "--sweep=single"],
                                capsys)
    got = _vals(header, rows[0])
    with open(RESULTS / "dot_error.csv") as f:
        lines = [ln.strip().split(";") for ln in f if ln.strip()]
    v5e = next(dict(zip(lines[0][1:], map(float, r[1:]))) for r in lines[1:] if r[0] == "16384")
    for col in ("DOT Acc<df64,bf16>", "DOT Acc<df64,f32> precise"):
        assert abs(got[col] / v5e[col] - 1) <= 1e-3, (col, got[col], v5e[col])


def test_gemv_driver_error_mode(capsys):
    header, rows, _ = _run_main(gemv_benchmark, ["--error", "--size=512", "--sweep=single"],
                                capsys)
    assert header == ["rows"] + [common.vendor_name(v[0]) for v in jgemv.VARIANTS]
    assert header == _jax_header("gemv_error.csv")
    assert len(rows) == 1
    vals = _vals(header, rows[0])
    assert vals["GEMV Acc<df64,f32>"] < 5e-7
    assert vals["GEMV fp32"] < 1e-5
    assert vals["GEMV bf16"] > vals["GEMV Acc<f32,bf16>"]
    assert vals["GEMV df64 oracle (device)"] < 1e-12


def test_trsv_driver_error_mode(capsys, lu_cache):
    header, rows, _ = _run_main(
        trsv_benchmark, ["--error", "--size=512", "--sweep=single", "--no-unit"], capsys)
    assert header == _jax_header("trsv_error.csv")
    assert len(rows) == 1
    vals = _vals(header, rows[0])
    assert vals["TRSV fp32"] < 1e-2
    assert vals["torch TRSV fp32"] < 1e-2
    assert vals["TRSV Acc<df64,f32>"] <= vals["TRSV fp32"] * 1.5
    assert vals["TRSV df64 oracle (device)"] < 1e-11


def test_trsm_driver_mode(capsys, lu_cache):
    header, rows, _ = _run_main(
        trsv_benchmark, ["--error", "--size=512", "--sweep=single", "--nrhs=8", "--no-unit"],
        capsys)
    assert header == _jax_header("trsm_error.csv")
    vals = _vals(header, rows[0])
    assert vals["TRSM fp32"] < 1e-3
    assert vals["TRSM Acc<df64,f32>"] <= vals["TRSM fp32"] * 1.2


@pytest.mark.parametrize("nrhs,csv", [(0, "trsv_flops.csv"), (4, "trsm_flops.csv")])
def test_trsv_driver_speed_columns(nrhs, csv, capsys, lu_cache):
    """Speed mode keeps the cold columns (the same work in eager torch) for
    the JAX CSV's schema; --only keeps the matching columns."""
    header, rows, err = _run_main(
        trsv_benchmark, ["--size=256", "--sweep=single", f"--nrhs={nrhs}"], capsys)
    assert header == _jax_header(csv)
    assert all(v > 0 for v in _vals(header, rows[0]).values())
    assert "host clock" in err
    header, rows, _ = _run_main(
        trsv_benchmark, ["--size=256", "--sweep=single", f"--nrhs={nrhs}", "--only", "cold"],
        capsys)
    assert [c.endswith(" cold") for c in header[1:]] == [True, True]
    assert len(list(lu_cache.glob("lu64_seed42_n256_cpu.npy"))) == 1


def test_lu_cache_reused(lu_cache):
    a = trsv_benchmark.lu_cached(128, 42, "cpu")
    assert a.flags["C_CONTIGUOUS"]  # row-major, as the kernels read it
    path = lu_cache / "lu64_seed42_n128_cpu.npy"
    assert path.exists()
    np.testing.assert_array_equal(np.load(path), a)
    np.testing.assert_array_equal(trsv_benchmark.lu_cached(128, 42, "cpu"), a)


def test_dot_driver_speed_mode_rows_per_size(capsys):
    """Speed mode emits one complete row per size, timed on the host clock
    for CPU tensors (named on stderr), with the JAX driver's header."""
    header, rows, err = _run_main(dot_benchmark, ["--size=32768", "--sweep=pow2"], capsys)
    assert header == _jax_header("dot_flops.csv")
    assert len(rows) == 2 and all(len(r) == len(header) for r in rows)
    assert [int(r[0]) for r in rows] == [16384, 32768]
    vals = _vals(header, rows[0])
    assert np.isfinite(vals["DOT fp32"]) and vals["DOT fp32"] > 0
    assert "host clock" in err and "CUDA events" not in err


def test_gemv_driver_speed_mode(capsys):
    header, rows, _ = _run_main(gemv_benchmark, ["--size=256", "--sweep=pow2"], capsys)
    assert header == _jax_header("gemv_flops.csv")
    assert [int(r[0]) for r in rows] == [128, 256]
    assert all(v > 0 for r in rows for v in _vals(header, r).values())


def test_dot_driver_no_align_ragged(capsys):
    header, rows, _ = _run_main(
        dot_benchmark,
        ["--error", "--size=1048577", "--sweep=single", "--no-align", "--randomizations=1"],
        capsys)
    assert rows[0][0] == "1048577"
    vals = _vals(header, rows[0])
    assert vals["DOT Acc<df64,f32>"] < 1e-6
    assert vals["DOT df64 oracle (device)"] < 1e-10


@pytest.mark.parametrize("module", [dot_benchmark, gemv_benchmark, trsv_benchmark,
                                    solvers_benchmark])
def test_drivers_refuse_cuda_without_a_card(module, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    with pytest.raises(SystemExit) as e:
        module.main(["--sweep=single"])
    assert e.value.code != 0
    cap = capsys.readouterr()
    assert "no CUDA device" in cap.err and cap.out == ""


def test_benchmark_protocol():
    """1 warm-up + N timed calls, minimum; skip=True runs once and returns 0
    (reference cuda/utils.cuh:236-262). On the CPU only the host clock
    times, and the CUDA-event timers refuse."""
    calls = []

    def f():
        calls.append(1)

    assert bench.benchmark_host(f, iters=3) >= 0.0
    assert len(calls) == 4
    calls.clear()
    assert bench.benchmark_host(f, skip=True) == 0.0 and len(calls) == 1
    bench.synchronize("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            bench.benchmark_function(f)
        with pytest.raises(RuntimeError, match="CUDA device"):
            bench.Timer()


def test_profile_trace(tmp_path):
    with bench.profile_trace(str(tmp_path / "t")):
        torch.ones(64).sum()
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    with bench.profile_trace(None):  # no directory: a no-op
        pass


def test_device_info_and_sweeps(monkeypatch):
    assert common.device_info("cpu") == ("cpu", None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert common.device_info("cuda") == ("NVIDIA H100 80GB HBM3", 3350.0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "Some Future Card")
    assert common.device_info("cuda") == ("Some Future Card", None)

    class A:
        sweep = "pow2"
        size = 8192

    for sweep, step in (("pow2", 0), ("single", 0), ("dense", 2048)):
        A.sweep = sweep
        assert common.sweep_sizes(A, 1024, 1024, step) == jcommon.sweep_sizes(A, 1024, 1024, step)
    full = type("F", (), {"sweep": "dense", "size": 24576, "step": 256})
    tail = type("B", (), {"sweep": "dense", "size": 24576, "step": 256, "min_size": 16512})
    assert common.sweep_sizes(tail, 128, 128, 1024) == \
        [s for s in common.sweep_sizes(full, 128, 128, 1024) if s >= 16512]
    assert common.sweep_sizes(tail, 128, 128, 1024) == jcommon.sweep_sizes(tail, 128, 128, 1024)


def test_csv_format_and_guarded(capsys):
    common.emit_header("n", ["A", "B"])
    common.emit_row(16, [1.5, float("nan")])
    assert capsys.readouterr().out.splitlines() == [
        "n;A;B", "16;1.5000000000000000e+00;nan"]
    assert common.fmt(0.1) == jcommon.fmt(0.1)
    assert np.isnan(common.guarded(lambda: 1 / 0, "boom"))
    assert "FAILED boom: ZeroDivisionError" in capsys.readouterr().err
    assert common.median([3.0, 1.0, 2.0]) == jcommon.median([3.0, 1.0, 2.0]) == 2.0


def test_plot_generation(tmp_path):
    csv = tmp_path / "demo.csv"
    csv.write_text("n;A;B\n1024;1.0e+00;2.0e+00\n2048;2.0e+00;3.0e+00\n")
    out = tmp_path / "demo.svg"
    plot.make_plot(str(csv), "flops", str(out))
    assert out.exists() and (tmp_path / "demo.pdf").exists()


def test_drivers_run_as_modules(tmp_path):
    """``python -m`` entry points, in a child process."""
    import subprocess

    res = subprocess.run(
        [sys.executable, "-m", "accblas_tpu_torch.bench.gemv_benchmark", "--device", "cpu",
         "--size", "128", "--sweep", "single", "--error"],
        cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines()[0] == ";".join(_jax_header("gemv_error.csv"))


@pytest.mark.parametrize("seed,n", [(42, 96), (7, 33)])
def test_solvers_system_draws_equal_jax(seed, n):
    """The solver driver's C and b are the JAX driver's bits
    (accblas_tpu/bench/solvers_benchmark.py ``_spd_device``), and A is
    Cᵀ C / n + 0.01 I from them."""
    import jax
    import jax.numpy as jnp

    ku, kb = jax.random.split(jax.random.PRNGKey(seed))
    c, b = solvers_benchmark.spd_draws(n, seed, "cpu")
    np.testing.assert_array_equal(
        c.numpy().view(np.uint32),
        np.asarray(jax.random.uniform(ku, (n, n), jnp.float32, -1.0, 1.0)).view(np.uint32))
    np.testing.assert_array_equal(
        b.numpy().view(np.uint32),
        np.asarray(jax.random.uniform(kb, (n,), jnp.float32, -1.0, 1.0)).view(np.uint32))
    a, b2 = solvers_benchmark.spd_system(n, seed, "cpu")
    assert torch.equal(b2, b)
    want = (c.double().T @ c.double() / n).numpy() + 0.01 * np.eye(n)
    assert np.max(np.abs(a.double().numpy() - want)) < 1e-5


def test_solvers_driver_cpu(capsys, monkeypatch):
    """The solver driver at its smallest size on the CPU: the JAX driver's
    header, finite positive rates, residuals in the v5e CSV's class (f32
    storage at the f32 floor, bf16 storage at its own), and the richardson
    and power-method lines on stderr. The iteration budgets are cut from
    20/120 to 2/6 to keep the host-clock timing short."""
    monkeypatch.setattr(solvers_benchmark, "ITERS_LO", 2)
    monkeypatch.setattr(solvers_benchmark, "ITERS_HI", 6)
    header, rows, err = _run_main(solvers_benchmark, ["--size", "512", "--sweep", "single"],
                                  capsys)
    assert header == _jax_header("solvers.csv")
    assert len(rows) == 1 and rows[0][0] == "512"
    vals = _vals(header, rows[0])
    assert all(np.isfinite(v) for v in vals.values())
    assert all(v > 0 for k, v in vals.items() if k.endswith("it_per_s"))
    # 6 iterations stop well short of convergence: the residual is below 1
    assert all(0 < v < 1 for k, v in vals.items() if k.endswith("resid"))
    assert "host clock" in err and "richardson" in err and "power_method" in err


def test_solvers_driver_residual_at_the_budget(capsys):
    """At the full 120-iteration budget the f32/f32 CG lands at the v5e
    CSV's residual class (3.7e-6 at n = 512): the df64 residual of one
    solve, no timing."""
    from accblas_tpu_torch.models import solvers

    a, b = solvers_benchmark.spd_system(512, solvers_benchmark.SEED, "cpu")
    x = solvers.cg(a, b, iters=solvers_benchmark.ITERS_HI)[0]
    r = solvers_benchmark.df64_residual(a, b, x)
    assert 1e-7 < r < 4 * 3.7084581168634872e-06, r
