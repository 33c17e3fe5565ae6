"""Traffic kind ``exhaustive_repeat_reconfig``: ``exhaustive_repeat``'s
closed loop of one client's exhaustive checks from ``Init`` on one warm
engine, for a configuration of the joint-consensus reconfiguration
variant (``constants`` with ``targets``, ``configs/reconfig3.cfg``'s
TargetConfigs) checked against a list of invariants beyond TypeOK.

Set-up, window and profile are ``exhaustive_repeat``'s (a private copy of
that module, so that its check summaries gain fields and its constants
check the targets, without touching the kinds the other cells run): each
check also records ``invariants`` (``EngineResult.invariants``),
``built`` and ``joint`` (the successors the v4 front's build launch built,
and of them those in which some server's latest config entry is joint).

``prepare`` refuses a cfg whose constants or targets are not the
configuration's, an engine whose invariants are not its list, and a v4
front that does not run the ``reconfig_suite`` build.  Every predicate
holds on every reachable state, so ``release`` drives the engine's own
front (the object the window timed, at its batch) on ``suite_parents``
unstructured parents drawn from ``--seed`` with a seeded share of config
values in their log and message entries (``models/reconfig.py
random_states``), and holds each live lane's first failing invariant
against ``reference/reconfig.py first_failing`` on the decoded successor,
before the engine's memory is given back (outside the window and the
set-up).  ``judge`` holds every check against the reference's search
(``reconfig.bfs_reconfig``): live to ``reference_live_depth`` in every
run, deeper from the frozen profile (``profiles/<config>.json``) the live
levels must match, over the twelve families; ``joint_gap`` and
``built_gap`` hold each check's ``joint`` to the profile's and its
``built`` to its distinct states less the roots.

Parameters as ``exhaustive_repeat``'s, and ``suite_parents``.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib.util
import os
import sys

from portbench.reference import compare, oracle, reconfig

BUILD = "reconfig_suite"


def _private_base():
    """A copy of ``exhaustive_repeat`` of this kind's own."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "exhaustive_repeat.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_traffic_exhaustive_repeat_of_reconfig", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


_base = _private_base()
_plain_summary = _base.summary
State, Profile = _base.State, _base.Profile


def summary(res, t_start: float, t_end: float) -> dict:
    """``exhaustive_repeat``'s summary, with the invariants the check
    evaluated and its ``built`` and ``joint`` where the result has them."""
    out = _plain_summary(res, t_start, t_end)
    for field in ("invariants", "built", "joint"):
        if hasattr(res, field):
            value = getattr(res, field)
            out[field] = list(value) if field == "invariants" else value
    return out


def check_constants(setup, constants: dict) -> None:
    """The program's reading of the cfg, targets included, has to be the
    configuration's."""
    got = {"n_servers": setup.dims.n_servers,
           "n_values": setup.dims.n_values,
           "max_term": setup.bounds.max_term,
           "max_log_len": setup.bounds.max_log_len,
           "max_msg_count": setup.bounds.max_msg_count,
           "targets": list(getattr(setup.dims, "targets", ()))}
    if got != constants:
        raise ValueError(f"the cfg reads as {got}, the configuration "
                         f"states {constants}")


# The copy's set-up checks the targets, and its window and profile
# summarise each check with this kind's.
_base.summary = summary
_base._check_constants = check_constants


def front_of(engine):
    """The v4 front the engine's step runs (None on other plans)."""
    front = engine._step.body.stages.front
    return front if hasattr(front, "suite") else None


def prepare(run) -> State:
    state = _base.prepare(run)
    eng = state.engine
    want = list(run.config["invariants"])
    if list(eng.inv_names) != want:
        raise ValueError(f"the program evaluates {list(eng.inv_names)}, "
                         f"the configuration states {want}")
    front = front_of(eng)
    build = getattr(front, "build_name", None)
    if build != BUILD:
        raise ValueError(f"the program's front runs the {build!r} build, "
                         f"not the {BUILD!r} one")
    return state


def window(state: State, run, seconds: float):
    return _base.window(state, run, seconds)


def profile(state: State, run) -> Profile:
    return _base.profile(state, run)


def suite_lanes(front, dims, device, ref_dims: reconfig.Dims, names,
                parents: int, seed: int) -> dict:
    """``front`` (of the program's ``dims``, on ``device``) on ``parents``
    parents of ``models/reconfig.py random_states`` at ``seed``,
    ``front.B`` a call, each call from the first parent the last one
    left: ``lanes``, the live lanes; ``wrong``, those whose first failing
    invariant (an index into ``names``, -1 where all hold) is not
    ``reconfig.first_failing``'s on the decoded successor; ``first``, the
    lanes by the reference's first failing name; ``config``, the lanes
    whose successor holds a config entry."""
    import torch
    from raft_tla_tpu_torch.models.reconfig import random_states
    from raft_tla_tpu_torch.models.schema import (
        StateBatch, decode_state, encode_state, flatten_state,
        stack_states, unflatten_state)
    states = random_states(dims, parents, seed=seed)
    rows = flatten_state(stack_states([encode_state(s, dims)
                                       for s in states], "cpu"), dims)
    B = front.B
    lanes = wrong = config = offset = 0
    first = collections.Counter()
    while offset < rows.shape[0]:
        part = rows[offset:offset + B]
        batch = torch.zeros((B, rows.shape[1]), dtype=torch.uint8)
        batch[:part.shape[0]] = part
        valid = torch.arange(B) < part.shape[0]
        out = front(batch.to(device), valid.to(device))
        total = int(out.total)
        got = out.inv[:total].cpu().tolist()
        cols = [c.numpy() for c in unflatten_state(
            out.krows[:total].cpu(), dims)]
        for i in range(total):
            s = decode_state(StateBatch(*(c[i] for c in cols)), dims)
            t = oracle.PyState(**{f.name: getattr(s, f.name)
                                  for f in dataclasses.fields(s)})
            ref = reconfig.first_failing(t, ref_dims, names)
            lanes += 1
            first[str(ref)] += 1
            config += any(v >= reconfig.CFG_BASE for log in t.log
                          for _t, v in log)
            wrong += got[i] != (-1 if ref is None else names.index(ref))
        offset += max(int(out.P), 1)
    return {"lanes": lanes, "wrong": wrong, "config": config,
            "first": dict(first)}


def release(state: State, run) -> None:
    """The front's lanes against the reference's first failing
    invariant, then the engine's device memory given back."""
    eng = state.engine
    run.suite_lanes = suite_lanes(
        front_of(eng), eng.dims, eng.device, reconfig.dims_of(run.config),
        list(run.config["invariants"]), int(run.params["suite_parents"]),
        run.seed & (2**64 - 1))
    print(f"suite lanes: {run.suite_lanes}", file=sys.stderr, flush=True)
    _base.release(state, run)


def reference_answer(config: dict, depth: int, live_depth: int):
    """The reference's answer to a check to ``depth`` with the
    configuration's invariants (with ``joint``, the distinct states with
    a joint configuration), and the widest gap between its live search to
    ``live_depth`` and the frozen profile."""
    prof = compare.load_profile(config["name"])
    if depth >= len(prof["actions"]):
        raise ValueError(f"{config['name']}: the reference profile stops "
                         f"at level {len(prof['actions']) - 1}, not {depth}")
    live = reconfig.bfs_reconfig(reconfig.dims_of(config),
                                 min(live_depth, depth),
                                 config["invariants"])
    answer = {"levels": prof["levels"][:depth + 1],
              "distinct": prof["distinct"][depth],
              "generated": prof["generated"][depth],
              "actions": dict(zip(reconfig.FAMILY_NAMES,
                                  prof["actions"][depth])),
              "joint": prof["joint"][depth],
              "diameter": depth, "stop_reason": compare.STOP_AT_DEPTH,
              "violation": prof["violation"], "deadlock": prof["deadlock"]}
    return answer, reconfig.profile_gap(live, prof)


def judge(run) -> dict:
    """Every check of the window (and of the traced sub-window) against
    the reference's answer, its invariants the configuration's list, its
    ``joint`` the reference's and its ``built`` its distinct states less
    the roots.  ``suite_lanes_wrong``: the front's lanes whose first
    failing invariant is not the reference's (1 where no lane was
    compared)."""
    ref, gap = reference_answer(run.config, run.params["max_diameter"],
                                run.params["reference_live_depth"])
    want = list(run.config["invariants"])
    checks = list(run.checks)
    if run.profile is not None:
        checks += run.profile.checks
    out = compare.judge(checks, ref, prefix_gap=gap)
    roots = run.n_roots or 0
    bad = [c.get("invariants") != want
           or c.get("joint") != ref["joint"]
           or c.get("built") != c["distinct"] - roots
           or compare.judge([c], ref)["checks_wrong"][0] for c in checks]
    out["checks_wrong"] = (sum(bad) if checks else 1, 0)
    out["invariants_wrong"] = (sum(c.get("invariants") != want
                                   for c in checks), 0)
    out["joint_gap"] = (max((abs(c.get("joint", -1) - ref["joint"])
                             for c in checks), default=1), 0)
    out["built_gap"] = (max((abs(c.get("built", -1) - (c["distinct"] - roots))
                             for c in checks), default=1), 0)
    lanes = getattr(run, "suite_lanes", None) or {"lanes": 0}
    out["suite_lanes_wrong"] = (lanes["wrong"] if lanes["lanes"] else 1, 0)
    return out
