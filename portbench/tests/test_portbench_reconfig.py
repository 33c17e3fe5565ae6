"""The reconfiguration cell: its reference, its traffic kind, its metrics
and its control, on the CPU.

``reference/reconfig.py`` (which imports no torch and nothing of the
program) gives the successor sets of the port's ``models/oracle.py``
with ``ReconfigDims`` on seeded parents holding config entries, its
first failing invariant covers all ten on ``models/reconfig.py
random_states``'s successors, and its frozen profile of
``reconfig3_safety`` holds the JAX engine's pins of reconfig3 to depth
12 and the live search's prefix; ``exhaustive_repeat_reconfig``'s judge
passes the profile's answer and fails a count, a ``joint``, a ``built``
or a list unlike it and a front lane unlike the reference; ``prepare``
refuses a front without the ``reconfig_suite`` build and a cfg with
other targets; a whole run of a tiny cell of the configuration is
correct; the two new metrics read a synthetic run; the control comes
out not correct."""

import dataclasses
import json
import os
import subprocess
import sys
import types

import pytest

from conftest import REPO, make_tree, run_cpu
from portbench import harness
from portbench.reference import compare, oracle, reconfig

BASE = os.path.join(REPO, "portbench")
NAME = "reconfig3_safety"
TINY = "reconfig3_tiny.bfs_l5"
KIND = "exhaustive_repeat_reconfig"

#: The JAX engine's counts of configs/reconfig3.cfg from Init
#: (BASELINE.md, chip_smoke.py RECONFIG_*): the frontier a level, the
#: cumulative distinct and generated at depths 11 and 12, the families'
#: generated counts at depth 12.
LEVELS = [1, 3, 18, 79, 318, 1218, 4433, 15510, 52467, 172129, 548904,
          1703691, 5151718]
DISTINCT = {11: 6005270, 12: 19780533}
GENERATED = {11: 17354943, 12: 57713052}
FAMILIES_L12 = {
    "Restart": 7496313, "Timeout": 7495146, "RequestVote": 13861020,
    "BecomeLeader": 2883, "ClientRequest": 1167, "AdvanceCommitIndex": 1167,
    "AppendEntries": 2334, "Receive": 9617343, "DuplicateMessage": 9617343,
    "DropMessage": 9617343, "InitiateReconfig": 993, "FinalizeReconfig": 0}


def config():
    return harness.load_config(NAME, BASE)


def kind():
    return harness.traffic_kind(KIND, BASE)


def ref_dims():
    return reconfig.dims_of(config())


def port_setup():
    from raft_tla_tpu_torch.utils.cfg import load_config
    return load_config(os.path.join(REPO, config()["cfg"]))


def to_ref(s):
    return oracle.PyState(**{f.name: getattr(s, f.name)
                             for f in dataclasses.fields(s)})


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; from portbench.reference import reconfig; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'raft_tla_tpu', 'raft_tla_tpu_torch', "
            "'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_successor_sets_equal_the_port_oracle(one_thread):
    """500 seeded parents holding config entries (a third of their log
    and message values, joint and final, a tenth of those invalid):
    every (action, successor) of the reference is the port oracle's."""
    from raft_tla_tpu_torch.models import oracle as port_oracle
    from raft_tla_tpu_torch.models.reconfig import random_states
    setup, dims = port_setup(), ref_dims()
    parents = random_states(setup.dims, 500, seed=2**31 + 27)
    assert sum(any(v >= reconfig.CFG_BASE for lg in s.log for _t, v in lg)
               for s in parents) > 200
    fams = set()
    for s in parents:
        want = sorted((a, dataclasses.astuple(t)) for a, t in
                      port_oracle.successors(s, setup.dims))
        got = sorted((a, dataclasses.astuple(t)) for a, t in
                     reconfig.successors(to_ref(s), dims))
        assert got == want
        fams.update(a[0] for a, _t in got)
    assert fams == set(range(12))


def test_the_reconfig_parents_fail_every_invariant_first_somewhere():
    """The successors of ``release``'s parents (2,048 a run) fail each of
    the ten first somewhere over two runs' seeds, and hold all ten
    somewhere.  LeaderCompleteness, last in the list, is first on 0 to
    ~15 of a run's ~27,000 lanes (0 at the first seed here): the
    predicates before it that read the same committed prefixes fail
    first."""
    from raft_tla_tpu_torch.models.reconfig import random_states
    setup, dims, names = port_setup(), ref_dims(), config()["invariants"]
    first = {}
    for seed in (4100000007, 4100000013):
        first[seed] = set()
        for s in random_states(setup.dims, 2048, seed=seed):
            for _a, t in reconfig.successors(to_ref(s), dims):
                first[seed].add(reconfig.first_failing(t, dims, names))
        assert first[seed] >= set(names[:-1]) | {None}
    assert set.union(*first.values()) == set(names) | {None}


def test_type_ok_admits_config_values_and_refuses_others():
    dims = ref_dims()
    ok = [reconfig.joint_value(7, 3), reconfig.joint_value(3, 7),
          reconfig.final_value(3), reconfig.final_value(7), 1]
    bad = [0, 2, reconfig.joint_value(7, 0), reconfig.joint_value(8, 3),
           reconfig.CFG_BASE]
    assert all(reconfig.value_ok(v, dims) for v in ok)
    assert not any(reconfig.value_ok(v, dims) for v in bad)
    s = oracle.init_state(dims)
    assert reconfig.type_ok(s.replace(log=(((1, ok[0]),), (), ())), dims)
    assert not reconfig.type_ok(s.replace(log=(((1, bad[2]),), (), ())),
                                dims)


def test_the_profile_holds_the_pins_and_the_live_search():
    prof = compare.load_profile(NAME)
    assert prof["families"] == list(reconfig.FAMILY_NAMES)
    assert prof["levels"] == LEVELS
    for depth in (11, 12):
        assert (prof["distinct"][depth], prof["generated"][depth]) == \
            (DISTINCT[depth], GENERATED[depth])
    assert dict(zip(reconfig.FAMILY_NAMES, prof["actions"][12])) == \
        FAMILIES_L12
    assert prof["violation"] is None and prof["deadlock"] is False
    # No leader before level 9, so no config entry before level 10; from
    # there the joint states are counted.
    assert prof["joint"][:10] == [0] * 10 and prof["joint"][12] > 0
    assert prof["joint"] == sorted(prof["joint"])
    bounded = compare.load_profile("mcraft_bounded")
    assert prof["distinct"][:10] == bounded["distinct"][:10]
    live = reconfig.bfs_reconfig(ref_dims(), 6, config()["invariants"])
    assert live.violation is None and not live.deadlock
    assert reconfig.profile_gap(live, prof) == 0
    assert all(name in prof["what"] for name in config()["invariants"])


def answer_check(depth=5, **change):
    """A check that answers as the profile does at ``depth``."""
    prof = compare.load_profile(NAME)
    check = {"levels": prof["levels"][:depth + 1],
             "distinct": prof["distinct"][depth],
             "generated": prof["generated"][depth],
             "action_counts": dict(zip(reconfig.FAMILY_NAMES,
                                       prof["actions"][depth])),
             "diameter": depth, "stop_reason": compare.STOP_AT_DEPTH,
             "violation": None, "deadlock": False,
             "invariants": list(config()["invariants"]),
             "built": prof["distinct"][depth] - 1,
             "joint": prof["joint"][depth]}
    check.update(change)
    return check


def judged(*checks, lanes=None, depth=5):
    run = types.SimpleNamespace(
        config=config(), checks=list(checks), profile=None, n_roots=1,
        params={"max_diameter": depth, "reference_live_depth": 4},
        suite_lanes=lanes or {"lanes": 100, "wrong": 0})
    return kind().judge(run)


def test_judge_passes_the_profile_s_answer():
    got = judged(answer_check(), answer_check())
    assert compare.is_correct(got), got
    assert got["joint_gap"] == got["built_gap"] == (0, 0)
    got = judged(answer_check(12), depth=12)
    assert compare.is_correct(got), got


@pytest.mark.parametrize("change,key", [
    ({"violation": "LogMatching", "stop_reason": "violation"},
     "checks_wrong"),
    ({"distinct": 2301}, "distinct_gap"),
    ({"joint": 1}, "joint_gap"),
    ({"built": 2300}, "built_gap"),
    ({"action_counts": {"InitiateReconfig": 1}}, "action_gap"),
    ({"invariants": ["TypeOK"]}, "invariants_wrong")])
def test_judge_fails_a_wrong_check(change, key):
    got = judged(answer_check(), answer_check(**change))
    assert not compare.is_correct(got)
    assert got["checks_wrong"] == (1, 0)
    assert got[key][0] >= 1


@pytest.mark.parametrize("lanes,wrong", [
    ({"lanes": 100, "wrong": 3}, 3), ({"lanes": 0, "wrong": 0}, 1)])
def test_judge_fails_lanes_unlike_the_reference_or_none(lanes, wrong):
    got = judged(answer_check(), lanes=lanes)
    assert got["suite_lanes_wrong"] == (wrong, 0)
    assert not compare.is_correct(got)


def tiny_tree(root, invariants=None, targets=None):
    """The checkout-like tree with a tiny cell of the configuration: its
    constants and engine plan, a batch and tables the CPU holds, and
    optionally another list, or other targets, in the configuration."""
    make_tree(root)
    base = os.path.join(root, "portbench")
    conf = config()
    conf["engine"].update(batch=64, queue_capacity=8192,
                          seen_capacity=65536)
    if invariants is not None:
        conf["invariants"] = invariants
        path = os.path.join(root, "tiny_reconfig.cfg")
        with open(os.path.join(REPO, conf["cfg"])) as f:
            head, _sep, _rest = f.read().partition("INVARIANTS")
        with open(path, "w") as f:
            f.write(head + "INVARIANTS " + " ".join(invariants)
                    + "\n\nCONSTRAINT BoundedSpace\n")
        conf["cfg"] = "tiny_reconfig.cfg"
    if targets is not None:
        conf["constants"]["targets"] = targets
    with open(os.path.join(base, "configs", "reconfig3_tiny.json"),
              "w") as f:
        json.dump(conf, f)
    cell = {"config": "reconfig3_tiny", "traffic": "bfs_l5", "kind": KIND,
            "chips": 1,
            "params": {"max_diameter": 5, "reference_live_depth": 4,
                       "profile_checks": 1, "suite_parents": 64},
            "why": "the CPU tests' cell of the reconfiguration variant"}
    with open(os.path.join(base, "workloads", f"{TINY}.json"), "w") as f:
        json.dump(cell, f)
    bpath = os.path.join(root, "BENCHMARK.json")
    b = harness.read_json(bpath)
    b["workloads"].append({"name": TINY, "config": "reconfig3_tiny",
                           "traffic": "bfs_l5", "chips": 1,
                           "why": "the CPU tests' cell"})
    for m in b["per_layer"]:
        if "reconfig3_safety.bfs_l12" in m.get("workloads", ()):
            m["workloads"].append(TINY)
    with open(bpath, "w") as f:
        json.dump(b, f)
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_cell_runs_correct(tmp_path, one_thread, trace):
    root = tiny_tree(str(tmp_path))
    result, compared = run_cpu(root, TINY, trace=trace)
    assert result["correct"] is True, result["compared"]
    for key in ("invariants_wrong", "joint_gap", "built_gap",
                "suite_lanes_wrong"):
        assert compared[key] == (0, 0), key
    with open(os.path.join(root, ".portbench", "run", "checks.json")) as f:
        checks = json.load(f)
    assert all(c["invariants"] == config()["invariants"]
               and c["generated"] == 5616 and c["built"] == 2299
               and c["joint"] == 0 for c in checks)
    if trace:
        # No device trace on the CPU: the roofline has nothing to read.
        assert set(result["metrics"]) == {"front.joint_per_distinct"}
        assert result["metrics"]["front.joint_per_distinct"]["value"] == 0
    else:
        assert set(result["metrics"]) == {"setup_s", "states_per_s"}


@pytest.mark.parametrize("invariants,targets,refused", [
    (["TypeOK"], None, "build"),
    (None, [3], "cfg reads as")])
def test_prepare_refuses_another_build_or_other_targets(
        tmp_path, one_thread, invariants, targets, refused):
    root = tiny_tree(str(tmp_path), invariants, targets)
    with pytest.raises(ValueError, match=refused):
        run_cpu(root, TINY)


def test_the_front_s_lanes_against_the_reference(one_thread):
    """The port's front on the CPU (``front_plain``, the card's twin) on
    96 of ``release``'s parents: every lane's first failing invariant is
    the reference's, config entries reach the lanes, and with
    LogMatching dropped from the front's list the lanes disagree."""
    import torch
    from raft_tla_tpu_torch.engine.check import (resolve_constraint,
                                                 resolve_invariants)
    from raft_tla_tpu_torch.models.actions2 import build_v2
    from raft_tla_tpu_torch.models.invariants import build_inv_id
    from raft_tla_tpu_torch.ops import compact as compact_mod
    from raft_tla_tpu_torch.ops.chunk_front_cuda import Front
    setup = port_setup()
    fns = list(resolve_invariants(setup).values())
    K = compact_mod.choose_k(64, setup.dims.n_instances, None)
    front = Front(dims=setup.dims, v2=build_v2(setup.dims, "cpu"),
                  inv_fns=fns, constraint=resolve_constraint(setup), B=64,
                  K=K, device="cpu")
    assert front.build_name == "reconfig_suite"
    names = config()["invariants"]
    args = (front, setup.dims, torch.device("cpu"), ref_dims(), names, 96,
            2**31 + 11)
    got = kind().suite_lanes(*args)
    assert got["lanes"] > 1000 and got["wrong"] == 0
    assert got["config"] > got["lanes"] // 4
    assert sum(got["first"].values()) == got["lanes"]
    front._inv_id = build_inv_id([f for f in fns
                                  if f.predicate != "LogMatching"])
    got = kind().suite_lanes(*args)
    assert got["first"].get("LogMatching", 0) > 0 and got["wrong"] > 0


def test_joint_per_distinct_reads_the_window_s_checks():
    read = harness.metric_reader("front.joint_per_distinct", BASE).read
    run = types.SimpleNamespace(checks=[
        {"distinct": 1000, "joint": 10}, {"distinct": 1000, "joint": 10}])
    assert read(run) == pytest.approx(0.01)
    run.checks[1] = {"distinct": 1000}
    assert read(run) is None
    assert read(types.SimpleNamespace(checks=[])) is None


def test_reconfig_front_roofline_by_hand():
    mod = harness.metric_reader("reconfig_front_roofline", BASE)
    c = {"levels": [1, 2, 3], "diameter": 2, "distinct": 6,
         "generated": 10}
    assert mod.least_bytes([c], 474) == 3 * 474 + 10 * 9
    lanes = "void (anonymous namespace)::lanes_kernel<true, true, true>(Dims)"
    dev = [(lanes, 0.0, 1.0), ("void masks_kernel<true>(Dims)", 1.0, 1.5),
           ("void rtt::compact_scan_kernel(int)", 1.5, 2.0),
           (lanes, 2.0, 2.5), ("fused_tail_copy", 2.5, 9.0)]
    run = types.SimpleNamespace(
        profile=types.SimpleNamespace(dev=dev, checks=[c]),
        peaks={"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12}},
        device_kind="NVIDIA H100 80GB HBM3", row_bytes=474)
    want = 100.0 * (3 * 474 + 10 * 9) / (2.5e-6 * 3.35e12)
    assert mod.read(run) == pytest.approx(want)
    run.profile.dev = dev[:2] + dev[3:]
    assert mod.read(run) is None            # the compaction missing
    run.profile = None
    assert mod.read(run) is None


def test_the_control_is_not_correct():
    """The reference keyed on a seeded hash of a few bits (the control,
    as the 32-bit search is at depth 12) comes out not correct against
    the profile; keyed on 64 bits it is correct."""
    conf = config()
    for bits, correct in ((12, False), (64, True)):
        answer = reconfig.freeze(conf, 5, key_bits=bits, seed=7)
        assert reconfig.control_verdict(conf, 5, answer)["correct"] is \
            correct
