"""The harness finds configurations, cells, traffic kinds and metrics by
name, and a new cell or metric is files alone."""

import json
import os
import shutil

import pytest

from conftest import REPO, TINY_CELL, run_cpu
from portbench import harness

BASE = os.path.join(REPO, "portbench")


def bench():
    return harness.load_benchmark(REPO)


@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.load_benchmark(REPO)["workloads"]])
def test_every_cell_resolves_by_name(name):
    b = bench()
    entry = next(w for w in b["workloads"] if w["name"] == name)
    cell = harness.load_workload(name, BASE)
    assert cell["config"] == entry["config"]
    assert cell["traffic"] == entry["traffic"]
    assert cell["chips"] == entry["chips"] == 1
    assert cell["why"] == entry["why"]
    assert cell["config_data"]["name"] == cell["config"]
    assert os.path.exists(os.path.join(REPO, cell["config_data"]["cfg"]))
    kind = harness.traffic_kind(cell["kind"], BASE)
    for fn in ("prepare", "window", "profile", "release", "judge"):
        assert callable(getattr(kind, fn))
    assert harness.cell_metrics(b, name, trace=False)
    assert harness.cell_metrics(b, name, trace=True)


def test_every_metric_has_a_reader_and_every_config_its_file():
    b = bench()
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.metric_reader(m["name"], BASE).read)
    for c in b["configs"]:
        data = harness.read_json(os.path.join(REPO, c["file"]))
        assert data["name"] == c["name"]
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


def test_benchmark_json_meets_the_names_rules():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    ok = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
             "0123456789_.-")
    for n in names:
        assert set(n) <= ok and len(n) <= 64
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])


def test_a_new_cell_and_metric_are_files_alone(tree):
    """A workload file and a metric file added to the tree, and the metric
    listed in BENCHMARK.json: the run reports the new cell with the new
    metric, and no other file of the harness changed."""
    base = os.path.join(tree, "portbench")
    before = {os.path.relpath(os.path.join(d, f), base):
              open(os.path.join(d, f), "rb").read()
              for d, _s, fs in os.walk(base) for f in fs}
    with open(os.path.join(base, "workloads", f"{TINY_CELL}.json")) as f:
        cell = json.load(f)
    cell["params"]["max_diameter"] = 4
    with open(os.path.join(base, "workloads", "mcraft_tiny.bfs_l4.json"),
              "w") as f:
        json.dump(cell, f)
    with open(os.path.join(base, "metrics", "checks_in_window.py"),
              "w") as f:
        f.write("def read(run):\n    return len(run.checks)\n")
    bpath = os.path.join(tree, "BENCHMARK.json")
    b = harness.read_json(bpath)
    b["workloads"].append({"name": "mcraft_tiny.bfs_l4",
                           "config": "mcraft_tiny", "traffic": "bfs_l4",
                           "chips": 1, "why": "test"})
    b["end_to_end"].append({"name": "checks_in_window", "unit": "checks",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["mcraft_tiny.bfs_l4"]})
    with open(bpath, "w") as f:
        json.dump(b, f)
    result, _ = run_cpu(tree, "mcraft_tiny.bfs_l4")
    assert result["correct"] is True
    assert result["metrics"]["checks_in_window"]["value"] == \
        result["attempted"] >= 1
    assert set(result["metrics"]) == {"setup_s", "states_per_s",
                                      "checks_in_window"}
    after = {os.path.relpath(os.path.join(d, f), base):
             open(os.path.join(d, f), "rb").read()
             for d, _s, fs in os.walk(base) for f in fs
             if "__pycache__" not in d}
    for k, v in before.items():
        if "__pycache__" not in k:
            assert after[k] == v, k


def test_a_missing_name_raises(tree):
    base = os.path.join(tree, "portbench")
    with pytest.raises(FileNotFoundError):
        harness.load_workload("no_such.cell", base)
    with pytest.raises(FileNotFoundError):
        harness.traffic_kind("no_such_kind", base)
    with pytest.raises(FileNotFoundError):
        harness.metric_reader("no_such_metric", base)
    shutil.rmtree(os.path.join(base, "configs"))
    with pytest.raises(FileNotFoundError):
        harness.load_workload(TINY_CELL, base)
