"""Plot generator for the drivers' CSVs (a copy of
``accblas_tpu.bench.plot`` reading the port's CSVs): FLOPs-vs-size and
relative-error-vs-size per kernel family, the figure types of the
reference's ``plots/``.

Usage:
    python -m accblas_tpu_torch.bench.plot dot_flops.csv --kind flops --out plots/h100_dot_flops.svg

A vendor column is named for what it calls: ``XLA ...`` in the JAX
package's CSVs, ``torch ...`` in the port's. Either is drawn dashed
(``is_vendor``), so the vendor tier looks the same in either figure.
matplotlib is imported only when a figure is drawn.
"""

from __future__ import annotations

import argparse
import sys

from .common import DELIM

MARKERS = ["o", "s", "^", "v", "D", "x", "+", "*"]


def read_csv(path):
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    header = lines[0].split(DELIM)
    xcol, names = header[0], header[1:]
    xs, cols = [], [[] for _ in names]
    for ln in lines[1:]:
        parts = ln.split(DELIM)
        xs.append(float(parts[0]))
        for i, v in enumerate(parts[1:]):
            cols[i].append(float(v))
    return xcol, names, xs, cols


def is_vendor(name: str) -> bool:
    """A vendor column of either package: 'XLA ...' or 'torch ...'."""
    return name.startswith(("XLA ", "torch "))


def make_plot(path, kind, out, title=None, dpi=150):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xcol, names, xs, cols = read_csv(path)
    fig, ax = plt.subplots(figsize=(7.0, 4.5))
    for i, name in enumerate(names):
        ax.plot(xs, cols[i], label=name, marker=MARKERS[i % len(MARKERS)], markersize=3,
                linewidth=1.2, linestyle="--" if is_vendor(name) else "-")
    ax.set_xlabel(xcol)
    if kind == "flops":
        ax.set_ylabel("GFLOP/s")
    else:
        ax.set_ylabel("relative error vs fp64")
        ax.set_yscale("log")
    ax.set_xscale("log", base=2)
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=8)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out, dpi=dpi)
    if out.endswith(".svg"):
        fig.savefig(out.rsplit(".", 1)[0] + ".pdf")  # the reference ships svg+pdf pairs
    plt.close(fig)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="torch_accblas_plots")
    p.add_argument("csv", help="driver CSV file")
    p.add_argument("--kind", choices=["flops", "error"], required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--title", default=None)
    args = p.parse_args(argv)
    print(make_plot(args.csv, args.kind, args.out, args.title), file=sys.stderr)


if __name__ == "__main__":
    main()
