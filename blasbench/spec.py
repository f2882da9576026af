"""What a cell is, found by name in ``BENCHMARK.json``.

A workload names a configuration and a traffic mix. The configuration's
file is the one its entry in ``configs`` gives; the mix is
``traffic/<mix>.json``; the mix's ``op`` names the driver
``drivers/<op>.py``; each metric is read by ``metrics/<metric>.py`` or,
where a quantity is split by cell (``throughput_gbps.dot``), by the file of
its family (``metrics/throughput_gbps.py``). Nothing here is specific to one cell, so adding a
cell, a mix or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

from . import HERE, ROOT


@dataclass
class Cell:
    """One workload with everything the run needs, resolved by name."""

    name: str
    chips: int
    config: dict  # the configuration file's contents
    mix: dict  # the traffic file's contents
    end_to_end: list  # the BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1
    root: Path


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _for_cell(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named `workload`; raises KeyError naming what is missing."""
    root = Path(root)
    spec = load_benchmark(root)
    entries = {w["name"]: w for w in spec["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({', '.join(entries)})")
    w = entries[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in configs:
        raise KeyError(f"workload {workload!r}: no configuration {w['config']!r}")
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix_path = root / HERE.name / "traffic" / f"{w['traffic']}.json"
    mix = json.loads(mix_path.read_text())
    e2e = [m for m in spec["end_to_end"] if _for_cell(m, workload)]
    reported = {m["name"] for m in e2e}
    # a per-layer metric without a workloads key is read wherever the metric
    # it moves is reported
    layer = [m for m in spec["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(workload, int(w["chips"]), config, mix, e2e, layer, root)


def first_cell_of(op: str, root: Path = ROOT) -> str:
    """The first workload of BENCHMARK.json whose mix runs `op`."""
    for w in load_benchmark(root)["workloads"]:
        if cell(w["name"], root).mix["op"] == op:
            return w["name"]
    raise KeyError(f"no workload runs {op!r}")


def _load(kind: str, name: str, root: Path):
    """The module ``<kind>/<name>.py`` under the benchmark's folder of
    `root`, loaded by its path (metric names may hold dots)."""
    path = Path(root) / HERE.name / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} file {path}")
    mod_name = f"{__package__}.{kind}." + "".join(c if c.isalnum() else "_" for c in name)
    loader = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod


def driver(op: str, root: Path = ROOT):
    """The module ``drivers/<op>.py``: its `Driver` runs the op's requests."""
    return _load("drivers", op, root)


def metric(name: str, root: Path = ROOT):
    """The reader module of metric `name`: ``metrics/<name>.py``, else that of
    the longest family the name extends by dotted parts (``a.b.c`` falls back
    to ``a.b``, then ``a``). It defines ``read(ctx)`` and may declare the
    port's counters it reads as ``COUNTERS = {name: (module, attribute)}``."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        path = Path(root) / HERE.name / "metrics" / (".".join(parts[:k]) + ".py")
        if path.is_file():
            return _load("metrics", ".".join(parts[:k]), root)
    raise KeyError(f"no metrics file for {name!r} under {Path(root) / HERE.name / 'metrics'}")
