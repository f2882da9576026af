"""Run one cell of the benchmark once.

    python3 blasbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout (``python3 -m blasbench.run`` works too). The
run makes its inputs on the card from the seed, loads the cell's
libraries (built into the checkout at the first run), warms up on the
cell's own requests, drives one client in a closed loop for the given
seconds, and judges what the window produced against the plain reference.
Its last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``, then ``checks``: each compared number beside its limit,
which also close standard error.

It exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), without the port beside it in the checkout, or
when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time


def _process_age() -> float:
    """Seconds since this process started (Linux), 0 where unknown."""
    import os

    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):  # run as a script: the checkout is the import root
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from blasbench import ROOT, draw, guard, roofline, spec, window  # noqa: E402

# CPUs a run keeps its own threads to, so that the host's scheduler does not
# move the client's thread across all of them: two, the client's and the
# CUDA runtime's helper threads (0: no pinning)
PIN_CPUS = 2


class RunError(Exception):
    """A run that must end without a result."""


@dataclass
class Context:
    """What the metric readers read."""

    cell: spec.Cell
    driver: object
    window: window.Window
    trace: object  # trace.Trace, or None untraced
    setup: dict  # setup_s, warm_s
    kind: str  # the device's name
    peak_gbps: float | None


def pin(k: int) -> list[int]:
    """Keep every thread of this process to the last `k` CPUs it may run on
    (CPU 0 takes most of the host's interrupts); the CPUs kept, or [] where
    the platform cannot pin or `k` is 0."""
    import os

    if k <= 0 or not hasattr(os, "sched_setaffinity"):
        return []
    cpus = sorted(os.sched_getaffinity(0))[-k:]
    try:
        tids = [int(t) for t in os.listdir("/proc/self/task")]
    except OSError:
        tids = [0]
    for tid in tids:
        try:
            os.sched_setaffinity(tid, cpus)
        except OSError:  # a thread that has ended
            pass
    return cpus


def counter_reader(modules) -> callable:
    """The reader of the port's launch counters that the metric `modules`
    declare, each as ``COUNTERS = {name: (module, attribute)}``: a function
    that returns {name: its count now} (0 for a module not loaded)."""
    wanted = {}
    for m in modules:
        wanted.update(getattr(m, "COUNTERS", {}))

    def counters() -> dict:
        out = {}
        for name, (mod, attr) in wanted.items():
            m = sys.modules.get(mod)
            out[name] = getattr(m, attr) if m is not None else 0
        return out

    return counters


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _one(drv, rng):
    out = drv.call(drv.pick(rng))
    drv.read(None, out, None)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float | None = None, variant: str = "program") -> dict:
    """One run of `cell` on `device`: the result object, `checks` last.
    ``memory_peak_bytes`` is the device's peak over the window (the inputs
    and what the calls allocate), set-up's transients left out."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    t_port = time.perf_counter()
    try:
        port = importlib.import_module(guard.PORT)
    except ImportError as e:
        raise RunError(f"cannot import {guard.PORT}: {e}") from e
    outside = guard.port_outside(cell.root, port)
    if outside:
        raise RunError(outside)
    mix = cell.mix
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics_read = {m["name"]: spec.metric(m["name"], cell.root) for m in wanted}
    counters = counter_reader(metrics_read.values())
    drv = spec.driver(mix["op"], cell.root).Driver(cell.config, mix, seed, device, variant)
    warm = draw.order(seed, "warm")
    _one(drv, warm)  # loads (or first builds) the libraries, first launches
    _sync(device)
    warm_s = time.perf_counter() - t_port
    for _ in range(int(mix["warm_requests"]) - 1):
        _one(drv, warm)
    sl = window.make_slicer(device, counters, traced, int(mix["trace_slice_requests"]))
    if sl is not None:
        sl.warm(lambda: _one(drv, warm))
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    w = window.run(drv, seconds, draw.order(seed, "requests"), draw.order(seed, "keep"),
                   counters, device, sl)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    tr = window.reduce_slices(w) if traced else None
    w.slices = []
    ctx = Context(cell, drv, w, tr, {"setup_s": setup_s, "warm_s": warm_s}, kind,
                  roofline.peak_gbps(kind))
    metrics = {}
    for m in wanted:
        v = metrics_read[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": len(w.requests),
              "failed": sum(1 for r in w.requests if not r.ok), "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s()
        result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    # the reference runs once the window's state is gone
    answers = w.answers
    del w, tr, ctx
    if device.type == "cuda":
        torch.cuda.empty_cache()
    limits = cell.config[mix["op"]]["check"]
    found = drv.check(answers) if answers else {}
    checks = {k: {"value": found.get(k, float("nan")), "limit": lim} for k, lim in limits.items()}
    result["correct"] = bool(answers) and all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def _power_line() -> dict:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return {"cards": out or ["unknown"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="blasbench.run", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        cell = spec.cell(args.workload, ROOT)
    except (KeyError, OSError, ValueError) as e:
        print(f"blasbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"blasbench: {args.workload} needs {cell.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    pin(PIN_CPUS)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START)
    except RunError as e:
        print(f"blasbench: {e}", file=sys.stderr)
        return 4
    found = guard.forbidden()
    if found:
        print(f"blasbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(_power_line()))
    print(f"correct: {json.dumps(result['correct'])}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
