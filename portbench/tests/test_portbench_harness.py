"""The harness reads its cells as data: a cell and a metric added as files
are found by name; the result line has the keys the driver reads; the
measurement path refuses to run without a card; every name and unit in
BENCHMARK.json keeps to the allowed characters."""

import json
import re
import subprocess
import sys
import types

import pytest
import torch

from portbench import harness
from portbench import run as bench_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    bench = tmp_path / "bench"
    for d in ("cells", "configs", "traffic", "metrics"):
        (bench / d).mkdir(parents=True)
    (bench / "configs" / "cfg_x.json").write_text(json.dumps({"k": 1}))
    (bench / "cells" / "cell_x.json").write_text(json.dumps(
        {"config": "cfg_x", "traffic": "kind_x", "chips": 1, "why": "a test",
         "params": {"n": 3}, "limits": {"gap": 0.5}}))
    (bench / "traffic" / "kind_x.py").write_text("KIND = 'x'\n")
    (bench / "metrics" / "thing_ms.x.py").write_text(
        "def read(trace):\n    return 2.5 * trace\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "end_to_end": [{"name": "job_s", "unit": "s"},
                       {"name": "other_s", "unit": "s",
                        "workloads": ["elsewhere"]}],
        "per_layer": [{"name": "thing_ms.x", "unit": "ms",
                       "workloads": ["cell_x"]}]}))
    cell = harness.Cell("cell_x", bench_dir=bench)
    assert cell.config == {"k": 1} and cell.params == {"n": 3}
    assert cell.limits == {"gap": 0.5}
    assert cell.driver().KIND == "x"
    assert [m["name"] for m in cell.end_to_end()] == ["job_s"]
    assert [m["name"] for m in cell.per_layer()] == ["thing_ms.x"]
    assert cell.reader("thing_ms.x").read(2) == 5.0


def test_result_line_keys():
    check = {"gap": {"value": 0.1, "limit": 0.5}}
    line = json.loads(harness.result_line(True, 4, 0, {}, {"platform": "gpu"},
                                          check))
    assert set(line) == REQUIRED | {"check"}
    assert list(line)[-1] == "check"
    line = json.loads(harness.result_line(True, 4, 0, {}, {}, check,
                                          {"device_ops": [], "idle_gaps": []}))
    assert set(line) == REQUIRED | {"check", "breakdown"}
    assert list(line)[-1] == "check"


def test_a_run_prints_the_last_line(capsys):
    """A whole untraced run of a cell at tiny size on the CPU, past the look
    for a card: its last line holds the keys the driver reads."""
    args = types.SimpleNamespace(workload="sds_default", seed=2 ** 31 + 3,
                                 seconds=0.2, trace=0)
    lines = []
    rc = bench_run.run(args, torch, device="cpu", tiny=True,
                       out=lines.append, err=lambda s: None)
    assert rc == 0
    line = json.loads(lines[-1])
    assert set(line) == REQUIRED | {"check"}
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"sds_step_ms", "peak_mem_gib",
                                    "setup_s"}
    assert set(line["check"]) == {"fisher_gap", "grad_gap", "change_gap"}


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, str(harness.BENCH_DIR / "run.py"),
                        "--workload", "sds_default", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300,
                       cwd=harness.ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "cuda" in r.stderr.lower()


def test_benchmark_names_and_units():
    b = harness.load_json(harness.ROOT / "BENCHMARK.json")
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]] + \
        [w["traffic"] for w in b["workloads"]] + \
        [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for m in b["end_to_end"] + b["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    assert len(set(w["name"] for w in b["workloads"])) == len(b["workloads"])
    for w in b["workloads"]:
        cell = harness.Cell(w["name"])
        assert cell.spec["config"] == w["config"]
        assert cell.traffic == w["traffic"] and cell.spec["why"] == w["why"]
        assert len(w["why"]) <= 200
        assert "setup_s" in [m["name"] for m in cell.end_to_end()]
        for m in cell.per_layer():
            assert m["moves"] in [e["name"] for e in cell.end_to_end()]
            assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
    for c in b["configs"]:
        assert (harness.ROOT / c["file"]).exists()
        assert harness.load_json(harness.ROOT / c["file"])["reduced"] == \
            c["reduced"]
