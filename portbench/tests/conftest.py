"""Shared fixtures of the benchmark's CPU tests: a checkout-like tree in a
temporary directory (the benchmark's files and BENCHMARK.json, the cfg
copies where the configurations name them) with a tiny configuration of
MCraft_bounded that the CPU runs in seconds, and a driver of one run of
the harness on the CPU (``run.execute``: everything but the look for a
card)."""

import json
import os
import shutil
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: The tiny cell: MCraft_bounded's constants, v4 and the fused tail as in
#: the benchmark's configuration, a batch and tables the CPU can hold.
TINY_CELL = "mcraft_tiny.bfs_l5"


def make_tree(root: str) -> str:
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    # The tiny cell reports what the main cell reports.
    bench["workloads"].append({"name": TINY_CELL, "config": "mcraft_tiny",
                               "traffic": "bfs_l5", "chips": 1,
                               "why": "the CPU tests' cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "mcraft_bounded.bfs_l11" in m.get("workloads", ()):
            m["workloads"].append(TINY_CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    base = os.path.join(root, "portbench")
    with open(os.path.join(base, "configs", "mcraft_bounded.json")) as f:
        conf = json.load(f)
    conf["engine"].update(batch=64, queue_capacity=8192, seen_capacity=65536)
    with open(os.path.join(base, "configs", "mcraft_tiny.json"), "w") as f:
        json.dump(dict(conf, name="mcraft_bounded"), f)
    cell = {"config": "mcraft_tiny", "traffic": "bfs_l5",
            "kind": "exhaustive_repeat", "chips": 1,
            "params": {"max_diameter": 5, "reference_live_depth": 4,
                       "profile_checks": 2},
            "why": "the CPU tests' cell"}
    with open(os.path.join(base, "workloads", f"{TINY_CELL}.json"),
              "w") as f:
        json.dump(cell, f)
    return root


@pytest.fixture
def tree(tmp_path):
    return make_tree(str(tmp_path))


@pytest.fixture(scope="module")
def one_thread():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run_cpu(root: str, workload: str = TINY_CELL, trace: int = 0,
            seconds: float = 0.5, seed: int = 2**31 + 11):
    """One run of the harness on the CPU: ``(result, compared)``."""
    from portbench import run as run_mod
    args = run_mod.parse(["--workload", workload, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)])
    return run_mod.execute(args, device="cpu", root=root,
                           t0=time.perf_counter())
