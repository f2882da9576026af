"""The port's plot generator (accblas_tpu_torch.bench.plot), mirroring
tests/test_plot.py: it reads the drivers' CSVs as the JAX package's does
and draws svg+pdf pairs; vendor columns of either package share a style."""

import os

from accblas_tpu.bench import plot as jplot
from accblas_tpu_torch.bench import plot as plotmod
from accblas_tpu_torch.bench.common import DELIM


def _write_csv(path):
    rows = [
        ["n", "A fp32", "A Acc<f32,bf16>", "torch A fp32"],
        ["1024", "1.0e+02", "2.0e+02", "3.0e+02"],
        ["2048", "1.1e+02", "nan", "3.1e+02"],  # a failed tier records NaN
        ["4096", "1.2e+02", "2.2e+02", "3.2e+02"],
    ]
    with open(path, "w") as f:
        for r in rows:
            f.write(DELIM.join(r) + "\n")


def test_read_csv_roundtrip(tmp_path):
    p = tmp_path / "x.csv"
    _write_csv(p)
    xcol, names, xs, cols = plotmod.read_csv(str(p))
    assert xcol == "n" and names == ["A fp32", "A Acc<f32,bf16>", "torch A fp32"]
    assert xs == [1024.0, 2048.0, 4096.0]
    assert cols[0] == [100.0, 110.0, 120.0]
    assert cols[1][1] != cols[1][1]  # NaN parses
    # the JAX package's reader agrees
    jx = jplot.read_csv(str(p))
    assert jx[:3] == (xcol, names, xs) and jx[3][0] == cols[0]


def test_make_plot_svg_and_pdf(tmp_path):
    p = tmp_path / "x.csv"
    _write_csv(p)
    out = tmp_path / "fig.svg"
    got = plotmod.make_plot(str(p), "flops", str(out), title="t")
    assert got == str(out) and os.path.getsize(out) > 0
    # the reference ships svg+pdf pairs: the generator emits both
    assert os.path.getsize(tmp_path / "fig.pdf") > 0


def test_make_plot_error_logscale(tmp_path):
    p = tmp_path / "x.csv"
    _write_csv(p)
    out = tmp_path / "err.png"
    plotmod.main([str(p), "--kind", "error", "--out", str(out)])
    assert os.path.getsize(out) > 0


def test_vendor_columns_share_a_style():
    assert plotmod.is_vendor("XLA DOT fp32") and plotmod.is_vendor("torch DOT fp32")
    assert not plotmod.is_vendor("DOT Acc<f32,bf16>")
