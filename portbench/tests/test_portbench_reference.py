"""The plain reference agrees with its frozen profiles, and with the port
at tiny sizes on the CPU."""

import json
import os

import pytest

from conftest import REPO
from portbench.reference import compare, oracle

CONFIGS = os.path.join(REPO, "portbench", "configs")


def dims(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return oracle.Dims(**json.load(f)["constants"])


@pytest.mark.parametrize("name,depth", [("mcraft_bounded", 6),
                                        ("tpuraft", 4)])
def test_live_search_matches_the_frozen_profile(name, depth):
    ans, gap = compare.reference_answer(name, dims(name), depth, depth)
    assert gap == 0
    prof = compare.load_profile(name)
    assert ans["levels"] == prof["levels"][:depth + 1]
    assert ans["distinct"] == prof["distinct"][depth]
    got = oracle.bfs(dims(name), depth)
    assert got.levels == ans["levels"]
    assert got.distinct[-1] == ans["distinct"]
    assert got.generated[-1] == ans["generated"]
    assert got.violation is None and not got.deadlock
    assert ans["actions"] == dict(zip(oracle.FAMILY_NAMES, got.actions[-1]))


def test_profiles_hold_the_pinned_counts():
    m = compare.load_profile("mcraft_bounded")
    assert (m["distinct"][11], m["generated"][11]) == (6005282, 17354955)
    t = compare.load_profile("tpuraft")
    assert (t["distinct"][8], t["generated"][8]) == (4237772, 14090975)
    for p in (m, t):
        assert len(p["levels"]) == len(p["distinct"]) == len(p["generated"])
        assert p["distinct"] == sorted(p["distinct"])
        # Each level's family counts add up to its generated count.
        for acts, gen in zip(p["actions"], p["generated"]):
            assert len(acts) == len(oracle.FAMILY_NAMES)
            assert sum(acts) == gen
    assert len(m["actions"]) == 12 and len(t["actions"]) == 9


def test_a_tampered_profile_shows_in_the_prefix_gap(monkeypatch):
    prof = compare.load_profile("mcraft_bounded")
    prof["levels"][3] += 1
    monkeypatch.setattr(compare, "load_profile", lambda name: prof)
    _ans, gap = compare.reference_answer("mcraft_bounded",
                                         dims("mcraft_bounded"), 11, 5)
    assert gap == 1


def test_judge_counts_each_kind_of_wrong_answer():
    ref, _ = compare.reference_answer("mcraft_bounded",
                                      dims("mcraft_bounded"), 4, 2)
    good = {"levels": [1, 3, 18, 79, 318], "distinct": 527,
            "generated": 1191, "diameter": 4,
            "stop_reason": "diameter_budget", "violation": None,
            "deadlock": False, "action_counts": dict(ref["actions"])}
    got = compare.judge([good, dict(good)], ref)
    assert compare.is_correct(got)
    assert got["checks_wrong"] == (0, 0)
    bad = [dict(good, distinct=526), dict(good, levels=[1, 3, 18, 80, 318]),
           dict(good, stop_reason="violation", violation="TypeOK"),
           dict(good, generated=1192),
           dict(good, action_counts=dict(good["action_counts"],
                                         Timeout=ref["actions"]["Timeout"]
                                         + 2))]
    got = compare.judge([good] + bad, ref)
    assert got["checks_wrong"] == (5, 0)
    assert got["action_gap"] == (2, 0)
    assert got["distinct_gap"] == (1, 0)
    assert got["level_gap"] == (1, 0)
    assert got["generated_gap"] == (1, 0)
    assert not compare.is_correct(got)
    assert not compare.is_correct(compare.judge([], ref))


@pytest.mark.parametrize("pipeline", ["v4", "v3"])
def test_the_port_on_the_cpu_answers_as_the_reference(pipeline, one_thread):
    """The program's own check (the cell's entry, MCraft_bounded's cfg) to
    depth 5 on the CPU, judged against the reference."""
    from raft_tla_tpu_torch.engine.bfs import EngineConfig
    from raft_tla_tpu_torch.engine.check import initial_states, make_engine
    from raft_tla_tpu_torch.utils.cfg import load_config
    setup = load_config(os.path.join(CONFIGS, "mcraft_bounded.cfg"))
    eng = make_engine(setup, EngineConfig(
        batch=64, queue_capacity=8192, seen_capacity=65536,
        pipeline=pipeline, record_trace=False, max_diameter=5),
        device="cpu")
    res = eng.run(initial_states(setup))
    check = {"levels": list(res.levels), "distinct": res.distinct,
             "generated": res.generated, "diameter": res.diameter,
             "stop_reason": res.stop_reason, "violation": None
             if res.violation is None else res.violation.invariant,
             "deadlock": res.deadlock is not None,
             "action_counts": dict(res.action_counts)}
    ref, gap = compare.reference_answer("mcraft_bounded",
                                        dims("mcraft_bounded"), 5, 5)
    got = compare.judge([check], ref, prefix_gap=gap)
    assert compare.is_correct(got), got
