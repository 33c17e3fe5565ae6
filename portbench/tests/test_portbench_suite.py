"""The safety suite's cell: its reference, its traffic kind and its
control, on the CPU.

The frozen profile of ``mcraft_safety`` agrees with ``reference/suite.py
bfs_suite``'s live search, and with ``mcraft_bounded``'s counts (the
suite holds on every reachable state); ``exhaustive_repeat_suite``'s
judge passes a check equal to the profile and fails a violation, a count
off by one, a list that lacks a name and a front lane whose first
failing invariant is not the reference's; the front's lanes agree with
the reference, and a front with one predicate dropped does not;
``prepare`` refuses a program that evaluates less than the
configuration's list, or without the front's suite build; a whole run of
a tiny cell of the configuration is correct and reads its per-layer
metrics; the control comes out not correct against the new profile."""

import json
import os
import subprocess
import sys
import types

import pytest

from conftest import REPO, make_tree, run_cpu
from portbench import harness
from portbench.reference import compare, control, oracle, suite

BASE = os.path.join(REPO, "portbench")
NAME = "mcraft_safety"
TINY = "mcraft_safety_tiny.bfs_l5"
SUITE = "suite"


def config():
    return harness.load_config(NAME, BASE)


def kind():
    return harness.traffic_kind("exhaustive_repeat_suite", BASE)


def test_the_profile_is_the_live_search_and_mcraft_bounded_s_counts():
    conf = config()
    prof = compare.load_profile(NAME)
    live = suite.bfs_suite(oracle.Dims(**conf["constants"]), 5,
                           conf["invariants"])
    assert live.violation is None and not live.deadlock
    assert suite.profile_gap(live, prof) == 0
    for key in ("levels", "distinct", "generated", "actions"):
        assert getattr(live, key) == prof[key][:6], key
    assert prof["violation"] is None and prof["deadlock"] is False
    bounded = compare.load_profile("mcraft_bounded")
    assert len(prof["actions"]) == 12
    for key in ("levels", "distinct", "generated", "actions"):
        assert prof[key] == bounded[key][:12], key
    assert (prof["distinct"][11], prof["generated"][11]) == (6005282,
                                                             17354955)
    assert all(name in prof["what"] for name in conf["invariants"])


def answer_check(depth=5, **change):
    """A check that answers as the profile does at ``depth``."""
    prof = compare.load_profile(NAME)
    check = {"levels": prof["levels"][:depth + 1],
             "distinct": prof["distinct"][depth],
             "generated": prof["generated"][depth],
             "action_counts": dict(zip(oracle.FAMILY_NAMES,
                                       prof["actions"][depth])),
             "diameter": depth, "stop_reason": compare.STOP_AT_DEPTH,
             "violation": None, "deadlock": False,
             "invariants": list(config()["invariants"])}
    check.update(change)
    return check


def judged(*checks, lanes=None):
    run = types.SimpleNamespace(
        config=config(), checks=list(checks), profile=None,
        params={"max_diameter": 5, "reference_live_depth": 4},
        suite_lanes=lanes or {"lanes": 100, "wrong": 0})
    return kind().judge(run)


def test_judge_passes_the_profile_s_answer():
    got = judged(answer_check(), answer_check())
    assert compare.is_correct(got)
    assert got["checks_wrong"] == (0, 0) and got["invariants_wrong"] == (0, 0)
    assert got["suite_lanes_wrong"] == (0, 0)


@pytest.mark.parametrize("lanes,wrong", [
    ({"lanes": 100, "wrong": 3}, 3), ({"lanes": 0, "wrong": 0}, 1),
    (None, 1)])
def test_judge_fails_lanes_unlike_the_reference_or_none(lanes, wrong):
    run = types.SimpleNamespace(
        config=config(), checks=[answer_check()], profile=None,
        params={"max_diameter": 5, "reference_live_depth": 4})
    if lanes is not None:
        run.suite_lanes = lanes
    got = kind().judge(run)
    assert got["suite_lanes_wrong"] == (wrong, 0)
    assert not compare.is_correct(got)


@pytest.mark.parametrize("change,key", [
    ({"violation": "LogMatching", "stop_reason": "violation"},
     "checks_wrong"),
    ({"distinct": 2301}, "distinct_gap"),
    ({"invariants": ["TypeOK", "MessagesInv", "LeaderVotesQuorum",
                     "CandidateTermNotInLog", "ElectionSafety",
                     "LogMatching", "VotesGrantedInv", "QuorumLogInv",
                     "MoreUpToDateCorrect"]}, "invariants_wrong")])
def test_judge_fails_a_wrong_check(change, key):
    got = judged(answer_check(), answer_check(**change))
    assert not compare.is_correct(got)
    assert got["checks_wrong"] == (1, 0)
    assert got[key][0] == 1


def test_judge_sees_a_live_search_that_leaves_the_profile(monkeypatch):
    prof = compare.load_profile(NAME)
    prof["generated"][3] += 1
    monkeypatch.setattr(compare, "load_profile", lambda name: prof)
    got = judged(answer_check())
    assert got["reference_prefix_gap"] == (1, 0)


def tiny_tree(root, invariants=None, cfg_invariants=None):
    """The checkout-like tree with a tiny cell of the configuration: its
    constants and engine plan, a batch and tables the CPU holds, and
    optionally another list in the configuration or in its cfg."""
    make_tree(root)
    base = os.path.join(root, "portbench")
    conf = config()
    conf["engine"].update(batch=64, queue_capacity=8192,
                          seen_capacity=65536)
    if invariants is not None:
        conf["invariants"] = invariants
    if cfg_invariants is not None:
        path = os.path.join(root, "tiny_safety.cfg")
        with open(os.path.join(REPO, conf["cfg"])) as f:
            text = f.read()
        head, _sep, _rest = text.partition("INVARIANTS")
        with open(path, "w") as f:
            f.write(head + "INVARIANTS " + " ".join(cfg_invariants)
                    + "\n\nCONSTRAINT BoundedSpace\n")
        conf["cfg"] = "tiny_safety.cfg"
    with open(os.path.join(base, "configs", "mcraft_safety_tiny.json"),
              "w") as f:
        json.dump(conf, f)
    cell = {"config": "mcraft_safety_tiny", "traffic": "bfs_l5",
            "kind": "exhaustive_repeat_suite", "chips": 1,
            "params": {"max_diameter": 5, "reference_live_depth": 4,
                       "profile_checks": 1, "suite_parents": 96},
            "why": "the CPU tests' cell of the safety suite"}
    with open(os.path.join(base, "workloads", f"{TINY}.json"), "w") as f:
        json.dump(cell, f)
    bpath = os.path.join(root, "BENCHMARK.json")
    b = harness.read_json(bpath)
    b["workloads"].append({"name": TINY, "config": "mcraft_safety_tiny",
                           "traffic": "bfs_l5", "chips": 1,
                           "why": "the CPU tests' cell"})
    for m in b["per_layer"]:
        if "mcraft_safety.bfs_l11" in m.get("workloads", ()):
            m["workloads"].append(TINY)
    with open(bpath, "w") as f:
        json.dump(b, f)
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_cell_runs_correct(tmp_path, one_thread, trace):
    root = tiny_tree(str(tmp_path))
    result, compared = run_cpu(root, TINY, trace=trace)
    assert result["correct"] is True, result["compared"]
    assert compared["invariants_wrong"] == (0, 0)
    assert compared["suite_lanes_wrong"] == (0, 0)
    with open(os.path.join(root, ".portbench", "run", "checks.json")) as f:
        checks = json.load(f)
    assert all(c["invariants"] == config()["invariants"]
               and c["generated"] == 5616 for c in checks)
    if trace:
        # No device trace on the CPU: the lanes launch's time is absent.
        assert set(result["metrics"]) == {"front.generated_per_distinct"}
        assert result["metrics"]["front.generated_per_distinct"][
            "value"] == pytest.approx(5616 / 2300)
    else:
        assert set(result["metrics"]) == {"setup_s", "states_per_s"}


@pytest.mark.parametrize("invariants,cfg_invariants,refused", [
    (None, ["TypeOK"], "evaluates"),
    (["TypeOK"], ["TypeOK"], "build")])
def test_prepare_refuses_a_typeok_only_engine(tmp_path, one_thread,
                                              invariants, cfg_invariants,
                                              refused):
    root = tiny_tree(str(tmp_path), invariants, cfg_invariants)
    with pytest.raises(ValueError, match=refused):
        run_cpu(root, TINY)


def test_a_program_that_records_no_list():
    """Without ``invariants`` on its result (``prepare`` finds no such
    field), the kind judges a check by the engine's names; where the
    result has the field, a check whose summary lacks it is wrong."""
    k = kind()
    res = types.SimpleNamespace(
        distinct=1, generated=0, diameter=0, levels=[1], stop_reason="x",
        violation=None, deadlock=None, action_counts={}, phases={},
        batches=0, steps=0, chunks=0)
    got = k.summary(res, 0.0, 1.0)
    assert "invariants" not in got
    check = answer_check()
    del check["invariants"]
    run = types.SimpleNamespace(
        config=config(), checks=[check], profile=None,
        params={"max_diameter": 5, "reference_live_depth": 4},
        suite_lanes={"lanes": 100, "wrong": 0}, records_invariants=False)
    run.inv_names = list(config()["invariants"])
    assert compare.is_correct(k.judge(run))
    run.inv_names = ["TypeOK"]
    assert k.judge(run)["invariants_wrong"] == (1, 0)
    run.inv_names = list(config()["invariants"])
    run.records_invariants = True
    assert k.judge(run)["invariants_wrong"] == (1, 0)
    front = types.SimpleNamespace(suite=True, reconfig=False)
    assert k.front_build(front) == SUITE
    front.suite = False
    assert k.front_build(front) == "typeok"
    assert k.front_build(None) is None


def test_generated_per_distinct_reads_the_window_s_checks():
    reader = harness.metric_reader("front.generated_per_distinct", BASE)
    run = types.SimpleNamespace(checks=[
        {"distinct": 2300, "generated": 5616},
        {"distinct": 2300, "generated": 5616}])
    assert reader.read(run) == pytest.approx(5616 / 2300)
    assert reader.read(types.SimpleNamespace(checks=[])) is None


def test_lanes_ns_per_state_reads_the_lanes_launch():
    reader = harness.metric_reader("front.lanes_ns_per_state", BASE).read
    lanes = "void (anonymous namespace)::lanes_kernel<true, false>(rtt::Dims)"
    prof = types.SimpleNamespace(
        dev=[(lanes, 0.0, 3.0), ("masks_kernel", 3.0, 9.0),
             (lanes, 10.0, 11.0)],
        checks=[{"generated": 1000}, {"generated": 1000}])
    assert reader(types.SimpleNamespace(profile=prof)) == pytest.approx(2.0)
    prof.dev = [("masks_kernel", 3.0, 9.0)]
    assert reader(types.SimpleNamespace(profile=prof)) is None
    assert reader(types.SimpleNamespace(profile=None)) is None


@pytest.fixture(scope="module")
def small_front():
    """The configuration's front on the CPU at a batch of 64, and its
    invariant functions."""
    from raft_tla_tpu_torch.engine.check import (resolve_constraint,
                                                 resolve_invariants)
    from raft_tla_tpu_torch.models.actions2 import build_v2
    from raft_tla_tpu_torch.ops import compact as compact_mod
    from raft_tla_tpu_torch.ops.chunk_front_cuda import Front
    from raft_tla_tpu_torch.utils.cfg import load_config
    setup = load_config(os.path.join(REPO, config()["cfg"]))
    fns = list(resolve_invariants(setup).values())
    K = compact_mod.choose_k(64, setup.dims.n_instances, None)
    front = Front(dims=setup.dims, v2=build_v2(setup.dims, "cpu"),
                  inv_fns=fns, constraint=resolve_constraint(setup), B=64,
                  K=K, device="cpu")
    return setup.dims, front, fns


def lanes_of(front, dims):
    import torch
    conf = config()
    return kind().suite_lanes(front, dims, torch.device("cpu"),
                              oracle.Dims(**conf["constants"]),
                              conf["invariants"], 96, 2**31 + 11)


@pytest.mark.parametrize("dropped", [None, "MessagesInv", "LogMatching"])
def test_the_front_s_lanes_against_the_reference(one_thread, small_front,
                                                 dropped):
    """The front's first failing invariant a lane is the reference's; with
    one predicate dropped from the front's list (the codes the launch
    takes, and the plain version's id) the lanes disagree."""
    from raft_tla_tpu_torch.models.invariants import build_inv_id
    dims, front, fns = small_front
    saved = front._inv_id
    if dropped is not None:
        front._inv_id = build_inv_id([f for f in fns
                                      if f.predicate != dropped])
    try:
        got = lanes_of(front, dims)
    finally:
        front._inv_id = saved
    assert got["lanes"] > 1000
    assert sum(got["first"].values()) == got["lanes"]
    if dropped is None:
        assert got["wrong"] == 0
    else:
        assert got["first"].get(dropped, 0) > 0 and got["wrong"] > 0


def test_the_control_runs_on_the_new_profile(monkeypatch):
    asked = []
    real = compare.load_profile
    monkeypatch.setattr(compare, "load_profile",
                        lambda name: (asked.append(name), real(name))[1])
    assert control.run_control(NAME, 5, 1, bits=12)["correct"] is False
    assert control.run_control(NAME, 5, 1, bits=64)["correct"] is True
    assert set(asked) == {NAME}
    out = subprocess.run(
        [sys.executable, os.path.join(BASE, "reference", "control.py"),
         "--config", NAME, "--depth", "5", "--seed", "1", "--bits", "12"],
        capture_output=True, text=True, check=True, cwd=REPO)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["config"] == NAME and got["correct"] is False
