"""The harness's registry and arithmetic, none of it tied to one cell.

Everything that belongs to one configuration, cell, traffic kind or
metric is a file found by its name:

- ``configs/<config>.json``: the configuration as it is run (its TLC cfg,
  its constants, the engine's settings, source, assumed, reduced);
- ``workloads/<cell>.json``: a cell (configuration, traffic, traffic
  kind and its parameters, chips, why);
- ``traffic/<kind>.py``: the generator of a traffic kind, with
  ``prepare``, ``window``, ``profile``, ``release`` and ``judge``;
- ``metrics/<metric>.py``: a metric's ``read(run)``, which returns its
  number or None where it finds nothing to read.

``BENCHMARK.json`` at the root of the checkout says which metrics a cell
reports.  This module imports no torch and nothing of the program.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from typing import Dict, Iterable, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: Top-level module names a run may not load: JAX and the JAX package
#: this port was made from (compared as whole names: the port's own
#: name begins with the JAX package's).
FOREIGN = ("jax", "jaxlib", "flax", "raft_tla_tpu")


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def load_config(name: str, base: str = HERE) -> dict:
    return read_json(os.path.join(base, "configs", f"{name}.json"))


def load_workload(name: str, base: str = HERE) -> dict:
    """A cell's file, with its configuration's file under ``"config_data"``."""
    cell = read_json(os.path.join(base, "workloads", f"{name}.json"))
    cell["name"] = name
    cell["config_data"] = load_config(cell["config"], base)
    return cell


def _load_module(path: str, tag: str):
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    safe = "".join(c if c.isalnum() else "_" for c in tag)
    spec = importlib.util.spec_from_file_location(f"portbench_{safe}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def traffic_kind(kind: str, base: str = HERE):
    """The generator module of a traffic kind."""
    return _load_module(os.path.join(base, "traffic", f"{kind}.py"),
                        f"traffic_{kind}")


def metric_reader(name: str, base: str = HERE):
    """The reader module of a metric (``metrics/<name>.py``)."""
    return _load_module(os.path.join(base, "metrics", f"{name}.py"),
                        f"metric_{name}")


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a cell reports: with ``trace`` its per-layer metrics,
    else its end-to-end ones; a metric with a ``workloads`` list only in
    those cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell in m["workloads"]]


def foreign_modules(names: Iterable[str]) -> List[str]:
    """The loaded modules whose top-level name is one of ``FOREIGN``."""
    return sorted(n for n in names if n.split(".")[0] in FOREIGN)


# -- window arithmetic --------------------------------------------------

def rate(total: float, start: float, end: float) -> Optional[float]:
    """Work over all the window's time, ``start`` to ``end``."""
    if end <= start:
        return None
    return total / (end - start)


def nearest_rank(values: List[float], q: float) -> Optional[float]:
    """The ``q`` quantile (0 < q <= 1) by nearest rank: the smallest
    value with at least ``q`` of all values at or below it."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def window_bounds(checks: List[dict]):
    """The window: the first check's start to the last check's end."""
    return checks[0]["t_start"], checks[-1]["t_end"]


# -- the result line ----------------------------------------------------

def metrics_block(bench: dict, cell: str, trace: bool, run,
                  base: str = HERE) -> Dict:
    """``{name: {"value", "unit"}}`` for each metric of the cell whose
    reader (under ``base``) finds something to read."""
    out = {}
    for m in cell_metrics(bench, cell, trace):
        value = metric_reader(m["name"], base).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def compared_block(compared: Dict) -> Dict:
    return {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}


def compared_lines(compared: Dict) -> List[str]:
    """One line a number compared: its name, number and limit."""
    return [f"compared {k}: {v} (limit {lim})"
            for k, (v, lim) in compared.items()]
