"""The port's hunt observatory (``obs/hunt.py`` and ``SwarmEngine(hunt=
True)``) against the JAX swarm's, on the CPU.

The same walks (``configs/MCraft_noleader.cfg``, 256 walks, depth 16, one
slice, seed 3: the CI canary) give the same hunt report, number for
number: Good-Turing unseen mass and saturation, the novelty series, the
depth histogram, the restart census, the family efficacy table and the
Bloom filter's load (times aside).  The hunt changes no walk; the CLI's
swarm prints the report and ``--history`` stores its summary.
"""

import json
import os

import numpy as np
import pytest
import torch

from raft_tla_tpu.engine.check import initial_states as j_initial_states
from raft_tla_tpu.engine.check import resolve_constraint as j_constraint_of
from raft_tla_tpu.engine.check import resolve_invariants as j_invariants_of
from raft_tla_tpu.engine.swarm import SwarmEngine as JSwarm
from raft_tla_tpu.obs import hunt as jhunt
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch import cli
from raft_tla_tpu_torch.engine.check import (initial_states,
                                             resolve_constraint,
                                             resolve_invariants)
from raft_tla_tpu_torch.engine.swarm import SwarmEngine, same_fp_prior
from raft_tla_tpu_torch.obs import hunt
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOLEADER = os.path.join(REPO, "configs/MCraft_noleader.cfg")
RUN = dict(walks=256, max_depth=16, chunk=32, ring=16)
TIMES = ("wall_seconds", "time_to_violation_seconds")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_hunt():
    jset = j_load_config(NOLEADER)
    eng = JSwarm(jset.dims, invariants=j_invariants_of(jset),
                 constraint=j_constraint_of(jset), hunt=True,
                 pipeline="v2", **RUN)
    return eng.run(j_initial_states(jset), seed=3)


def port_run(hunt_on: bool, **kw):
    setup = load_config(NOLEADER)
    eng = SwarmEngine(setup.dims, invariants=resolve_invariants(setup),
                      constraint=resolve_constraint(setup), hunt=hunt_on,
                      batch=256, device="cpu", collect_fingerprints=True,
                      **RUN, **kw)
    return eng.run(initial_states(setup), seed=3)


def untimed(report):
    return {k: v for k, v in report.items() if k not in TIMES}


def test_hunt_report_equals_jax(jax_hunt):
    res = port_run(True)
    want, got = jax_hunt.report["hunt"], res.report["hunt"]
    assert set(got) == set(want)
    assert untimed(got) == untimed(want)
    assert got["bloom"]["load"] > 0
    assert res.violation.fingerprint == jax_hunt.violation.fingerprint
    assert hunt.summarize(got).keys() == jhunt.summarize(want).keys()


def test_hunt_changes_no_walk():
    on, off = port_run(True), port_run(False)
    assert "hunt" in on.report and "hunt" not in off.report
    assert (on.steps, on.visited, on.traces, on.diameter) \
        == (off.steps, off.visited, off.traces, off.diameter)
    assert np.array_equal(on.visited_fingerprints, off.visited_fingerprints)
    assert on.violation.fingerprint == off.violation.fingerprint


def test_prior_count_over_earlier_lanes():
    hi = torch.tensor([5, 5, 7, 5, 7, 9, 5])
    lo = torch.tensor([1, 1, 2, 1, 2, 3, 2])
    acc = torch.tensor([True, False, True, True, True, True, True])
    # Earlier accepted lanes with the same (hi, lo).
    assert same_fp_prior(hi, lo, acc).tolist() == [0, 1, 0, 1, 1, 0, 0]


def test_accumulator_and_rendering_equal_jax():
    fams = ["A", "B", "C"]
    out = []
    for mod in (hunt, jhunt):
        acc = mod.HuntAccumulator(fams, 4, bloom_cells=64, max_points=4)
        acc.add_slice(10, 3, (1, 2, 3, 4, 5), [0, 1, 2, 3, 4], [5, 0, 2],
                      [4, 0, 1], [3, 0, 1])
        acc.add_steps(6, 60, [1, 2, 3, 0, 1, 3], [4, 5, 6, 7, 8, 9])
        acc.bloom_load = 0.125
        rep = mod.build_report(acc, violation_at_seconds=1.5,
                               wall_seconds=2.0)
        out.append((rep, mod.render_report(rep), mod.summarize(rep),
                    acc.snapshot()))
    assert out[0] == out[1]


def test_cli_swarm_prints_the_hunt_and_its_history(tmp_path, capsys,
                                                   jax_hunt):
    hist = tmp_path / "h.jsonl"
    rc = cli.main(["check", NOLEADER, "--mode", "swarm", "--device", "cpu",
                   "--walks", "256", "--max-depth", "16", "--seed", "3",
                   "--history", str(hist)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "hunt: 248 distinct states observed in 2,802 accepted visits" \
        in out
    entry = json.loads(hist.read_text())
    assert entry["kind"] == "swarm" and entry["swarm"]["walks"] == 256
    want = jhunt.summarize(jax_hunt.report["hunt"])
    assert {k: v for k, v in entry["hunt"].items() if k not in TIMES} \
        == {k: v for k, v in want.items() if k not in TIMES}
