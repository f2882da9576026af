"""Cells, mixes and metrics are found by name: files and BENCHMARK.json
entries are all a new one needs. And BENCHMARK.json keeps to its shape."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from blasbench import HERE, ROOT, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()


def test_every_entry_resolves_to_its_files():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        assert (HERE / "drivers" / f"{cell.mix['op']}.py").is_file()
        assert cell.mix["op"] in cell.config, "the configuration states the op's numerics"
        assert cell.config[cell.mix["op"]]["check"], "every check has a limit"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.metric(m["name"]).read)


def test_shape_of_benchmark_json():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["blasbench"] and BENCH["command"][1] == "blasbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("blasbench/") and (ROOT / c["file"]).is_file()
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        for m in cell.per_layer:  # what it moves is reported in the cell
            assert m["moves"] in reported


def _checkout_with_dummies(tmp_path):
    """A copy of the checkout's benchmark and port, plus a configuration, a
    mix and a metric added as files and entries only."""
    root = tmp_path / "co"
    shutil.copytree(HERE, root / HERE.name, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(ROOT / "accblas_tpu_torch", root / "accblas_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((HERE / "configs" / "blas-main-path.json").read_text())
    (root / HERE.name / "configs" / "dummy-config.json").write_text(json.dumps(cfg))
    (root / HERE.name / "traffic" / "dummy.mix.json").write_text(json.dumps(
        {"op": "dot", "n": 4096, "pool": 2, "warm_requests": 2, "trace_slice_requests": 2}))
    (root / HERE.name / "metrics" / "dummy.count.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window.requests))\n")
    bench["configs"].append({"name": "dummy-config", "source": "https://example.org/x",
                             "file": "blasbench/configs/dummy-config.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy-config",
                               "traffic": "dummy.mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy.count", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "set-up", "moves": "setup_s",
                               "workloads": ["dummy.cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "throughput_gbps.dot":
            m["workloads"].append("dummy.cell")
    # a quantity of a family split by cell needs an entry and no file
    bench["per_layer"].append({"name": "api.host_us.dummy", "unit": "us", "better": "lower",
                               "source": "host_clock", "layer": "public API and wrappers",
                               "moves": "throughput_gbps.dot", "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_a_cell_mix_and_metric_added_as_files_are_found(tmp_path):
    root = _checkout_with_dummies(tmp_path)
    cell = spec.cell("dummy.cell", root)
    assert cell.mix["n"] == 4096 and cell.config["dot"]["arithmetic"] == "f32"
    assert [m["name"] for m in cell.per_layer] == ["dummy.count", "api.host_us.dummy"]
    assert not (root / HERE.name / "metrics" / "api.host_us.dummy.py").exists()
    assert spec.metric("api.host_us.dummy", root).read.__name__ == "host_us"
    assert {m["name"] for m in cell.end_to_end} == {"throughput_gbps.dot", "setup_s"}
    assert spec.metric("dummy.count", root).read(type("C", (), {"window": type(
        "W", (), {"requests": [1, 2]})})) == 2.0
    with pytest.raises(KeyError):
        spec.cell("no.such.cell", root)


def test_the_added_cell_runs_from_its_checkout(tmp_path):
    """In a fresh process rooted at the copy: a CPU run of the added cell
    reports the added metric and is correct."""
    root = _checkout_with_dummies(tmp_path)
    code = ("import sys, json, torch; sys.path.insert(0, '.')\n"
            "from blasbench import spec, run, ROOT\n"
            "for traced in (False, True):\n"
            "    r = run.run_cell(spec.cell('dummy.cell', ROOT), 3, 0.2, traced,"
            " torch.device('cpu'))\n"
            "    print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    plain, traced = (json.loads(x) for x in out.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and set(plain["metrics"]) == {"throughput_gbps.dot", "setup_s"}
    assert traced["correct"] and traced["metrics"]["dummy.count"]["value"] >= 1
    assert traced["metrics"]["api.host_us.dummy"]["value"] > 0


def test_counters_are_the_ones_the_metrics_declare():
    """run.py reads the port's counters that the cell's metric files declare,
    and no list of its own."""
    from accblas_tpu_torch.ops import gemv

    from blasbench import run

    cg = spec.cell(spec.first_cell_of("cg"))
    mods = [spec.metric(m["name"]) for m in cg.per_layer]
    got = run.counter_reader(mods)()
    assert set(got) == {"gemv.launches", "gemv.staged_launches"}
    assert got["gemv.launches"] == gemv.launches
    dot = spec.cell(spec.first_cell_of("dot"))
    assert run.counter_reader([spec.metric(m["name"]) for m in dot.end_to_end])() == {}
