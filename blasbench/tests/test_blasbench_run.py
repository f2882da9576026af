"""A run end to end: without a card it exits non-zero and prints no result;
on the CPU at small sizes (the port's plain versions) it reports the cell's
metrics and judges the window's answers."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from blasbench import HERE, ROOT, run, spec

SMALL = {"trsv": 256, "dot": 1 << 14, "cg": 96}  # a size an op's cells run at here
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _script(cwd, workload=None):
    workload = workload or spec.first_cell_of("cg")
    return subprocess.run([sys.executable, "blasbench/run.py", "--workload", workload,
                           "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for w in CELLS:
        out = _script(ROOT, w)
        assert out.returncode != 0 and out.stdout == ""
        assert "CUDA card" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / HERE.name, ignore=shutil.ignore_patterns("__pycache__"))
    out = _script(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_unknown_workload():
    out = subprocess.run([sys.executable, "-m", "blasbench.run", "--workload", "nope",
                          "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == "" and "no workload" in out.stderr


def _small(workload):
    cell = spec.cell(workload)
    cell.mix["n"] = SMALL[cell.mix["op"]]
    cell.mix["trace_slice_requests"] = 2
    return cell


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cpu_run(workload, traced):
    cell = _small(workload)
    r = run.run_cell(cell, 2**33 + 5, 0.3, traced, torch.device("cpu"))
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    names = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    assert set(r["metrics"]) <= names
    if not traced:  # the end-to-end metrics need no device
        assert set(r["metrics"]) == names
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:
        assert "breakdown" in r and r["device"]["window_s"] > 0
    for c in r["checks"].values():
        assert 0 <= c["value"] <= c["limit"]


@pytest.mark.parametrize("workload", CELLS)
def test_same_seed_same_inputs(workload):
    cell = _small(workload)
    drv = spec.driver(cell.mix["op"]).Driver

    def inputs(seed):
        d = drv(cell.config, cell.mix, seed, "cpu")
        return d.x + d.y if hasattr(d, "x") else [d.a, d.b]

    one, two, other = inputs(2**31 + 77), inputs(2**31 + 77), inputs(78)
    assert all(torch.equal(u, v) for u, v in zip(one, two))
    assert not any(torch.equal(u, v) for u, v in zip(one, other))


def test_main_prints_the_contract_lines(monkeypatch, capsys):
    """main() with the look for a card answered yes and the run on the CPU:
    the last stdout line is the result, the checks close stderr."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    real = run.run_cell

    def on_cpu(cell, seed, seconds, traced, device, t_start=None, variant="program"):
        cell.mix["n"] = SMALL[cell.mix["op"]]
        return real(cell, seed, seconds, traced, torch.device("cpu"), t_start, variant)

    monkeypatch.setattr(run, "run_cell", on_cpu)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    pinned = []
    monkeypatch.setattr(run, "pin", pinned.append)
    assert run.main(["--workload", spec.first_cell_of("dot"), "--seed", "9", "--seconds", "0.2"]) == 0
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result) == KEYS + ["checks"] and result["correct"] is True
    assert "power" not in out.splitlines()[-1]
    assert err.strip().splitlines()[-1].startswith("check dot_err: ")
    assert pinned == [run.PIN_CPUS]


def test_pin_keeps_every_thread_to_the_last_cpus():
    """In a fresh process with a second thread running: both end on the
    last CPU the process may use."""
    code = ("import os, threading, time\n"
            "from blasbench import run\n"
            "allowed = sorted(os.sched_getaffinity(0))\n"
            "stop = threading.Event(); t = threading.Thread(target=stop.wait); t.start()\n"
            "kept = run.pin(1)\n"
            "tids = [int(x) for x in os.listdir('/proc/self/task')]\n"
            "print(kept == allowed[-1:], all(sorted(os.sched_getaffinity(x)) == kept"
            " for x in tids), len(tids) >= 2, run.pin(0))\n"
            "stop.set(); t.join()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["True", "True", "True", "[]"]
