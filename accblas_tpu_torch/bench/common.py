"""Shared benchmark-driver machinery (counterpart of
``accblas_tpu.bench.common``).

The reference's driver structure (SURVEY.md §2 C24): a list of variants, a
size sweep, and `;`-delimited CSV on stdout with 16-digit scientific values
(``cuda/dot_benchmark.cu:28,146-158``); progress goes to stderr. The error
oracle is host numpy float64 on the master data.

Every driver runs on ``--device`` (default ``cuda``). Asked for ``cuda``
without a card it exits non-zero: it never carries on on the CPU. With
``--device cpu`` the drivers run the plain torch versions, and speed mode
times them on the host clock, which the driver names on stderr.
"""

from __future__ import annotations

import argparse
import sys
from typing import Sequence

import numpy as np
import torch

DELIM = ";"  # reference: cuda/dot_benchmark.cu:28

# peak device-memory bandwidth (GB/s) of NVIDIA cards, from their data sheets,
# matched against torch.cuda.get_device_name by prefix (longest first)
PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,  # H100 SXM5
    "NVIDIA H100 PCIe": 2000.0,
    "NVIDIA H100 NVL": 3900.0,
    "NVIDIA H200": 4800.0,
    "NVIDIA A100-SXM4-80GB": 2039.0,
    "NVIDIA A100-SXM4-40GB": 1555.0,
    "NVIDIA A100 80GB PCIe": 1935.0,
    "NVIDIA A100-PCIE-40GB": 1555.0,
    "Tesla V100": 900.0,
    "NVIDIA L40S": 864.0,
}


def fmt(v: float) -> str:
    """16-digit scientific, reference ``dot_benchmark.cu:157-158``."""
    return f"{v:.16e}"


def emit_header(first_col: str, names: Sequence[str], file=None):
    print(DELIM.join([first_col] + list(names)), file=file or sys.stdout, flush=True)


def emit_row(size: int, values: Sequence[float], file=None):
    print(DELIM.join([str(size)] + [fmt(v) for v in values]), file=file or sys.stdout,
          flush=True)


def parse_args(prog: str, default_size: int, min_size: int, extra=None, argv=None):
    """--error / --size=N (reference flag surface, ``cuda/dot_benchmark.cu:33-68``),
    the sweep controls of the JAX drivers, and --device. Exits non-zero
    when --device names a CUDA device and there is none."""
    p = argparse.ArgumentParser(
        prog=prog,
        description=f"{prog}: accblas_tpu_torch benchmark driver (CSV to stdout)",
    )
    p.add_argument("--error", action="store_true", help="measure relative error instead of time")
    p.add_argument("--size", type=int, default=default_size, help="maximum sweep size")
    p.add_argument(
        "--sweep",
        choices=["pow2", "dense", "single"],
        default="pow2",
        help="size grid: pow2 = doubling (default), dense = reference-style linear steps, "
        "single = only --size",
    )
    p.add_argument("--step", type=int, default=0,
                   help="dense-sweep step override (0 = driver default)")
    p.add_argument("--min-size", dest="min_size", type=int, default=0,
                   help="sweep grid start override (0 = driver default): resume an "
                   "interrupted dense sweep from its last completed size")
    p.add_argument("--randomizations", type=int, default=10,
                   help="error-mode re-randomizations for the median (reference: 10)")
    p.add_argument("--no-align", dest="align", action="store_false", default=True,
                   help="sweep arbitrary (non-aligned) sizes")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda); 'cpu' runs the plain torch "
                   "versions and times them on the host clock")
    if extra:
        extra(p)
    args = p.parse_args(argv)
    if args.size < min_size:
        p.error(f"--size must be >= {min_size}")
    args.device = torch.device(args.device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        p.error(f"--device {args.device}: no CUDA device (torch.cuda.is_available() is "
                "False); pass --device cpu to run the plain torch versions")
    return args


def sweep_sizes(args, min_size: int, align: int, dense_step: int):
    """Size grid, every size aligned down to `align` (``--no-align``: 1);
    ``--min-size`` resumes a dense grid on the same residue class."""
    if not getattr(args, "align", True):
        align = 1
    min_size = max(min_size, getattr(args, "min_size", 0) or 0)

    def al(v):
        return max(align, (v // align) * align)

    if args.sweep == "single":
        return [al(args.size)]
    if args.sweep == "dense":
        step = getattr(args, "step", 0) or dense_step
        grid = {al(s) for s in range(min_size, args.size + 1, step)}
        grid.add(al(args.size))  # always include the endpoint
        return sorted(grid)
    sizes = []
    s = min_size
    while s <= args.size:
        sizes.append(al(s))
        s *= 2
    if sizes and sizes[-1] != al(args.size):
        sizes.append(al(args.size))
    return sizes


def progress(msg: str):
    """Stderr progress line (the CSV owns stdout)."""
    print(f"# {msg}", file=sys.stderr, flush=True)


def guarded(fn, label: str) -> float:
    """Run one measurement; a failing tier records NaN instead of killing
    the sweep (a crash at one (variant, size) would lose every completed
    row), and says so on stderr."""
    try:
        return float(fn())
    except Exception as e:  # noqa: BLE001 - deliberate fault isolation, reported
        progress(f"FAILED {label}: {type(e).__name__}: {str(e)[:300]}")
        return float("nan")


def median(vals) -> float:
    """Median over re-randomizations (reference ``dot_benchmark.cu:238-259``)."""
    return float(np.median(np.asarray(vals, np.float64)))


def device_info(device=None):
    """(device name, peak memory bandwidth in GB/s) for roofline reporting:
    the card's name and its data-sheet bandwidth, None for a card the table
    does not know and for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return "cpu", None
    kind = torch.cuda.get_device_name(dev)
    for name in sorted(PEAK_GBPS, key=len, reverse=True):
        if kind.startswith(name):
            return kind, PEAK_GBPS[name]
    return kind, None


def _protocol(device):
    """The reference protocol's timer for `device`: CUDA events on a card,
    the host clock for CPU tensors."""
    from ..utils import bench

    on_card = torch.device(device).type == "cuda"
    return bench.benchmark_function if on_card else bench.benchmark_host


def timer(device):
    """The protocol's timer for `device` (1 warm-up, 10 reps, minimum),
    named on stderr."""
    if torch.device(device).type == "cuda":
        progress("timing: CUDA events, 1 warm-up, 10 reps, minimum")
    else:
        progress("timing: host clock (time.perf_counter) on CPU tensors, not a device time")
    return _protocol(device)


def run_once(device):
    """The error-mode protocol for `device`: each variant runs once, untimed
    (``benchmark_function(..., skip=True)``, ``cuda/utils.cuh:236-262``),
    and hands back its result."""
    bench_fn = _protocol(device)

    def run(fn):
        box = {}

        def call():
            box["v"] = fn()

        bench_fn(call, skip=True)
        return box["v"]

    return run


def vendor_name(jax_name: str) -> str:
    """The port's name of a JAX driver column: the vendor tier is a torch
    call on the card, not XLA (``XLA DOT fp32`` -> ``torch DOT fp32``)."""
    return "torch " + jax_name[4:] if jax_name.startswith("XLA ") else jax_name
