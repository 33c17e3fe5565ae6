"""Traffic kind ``exhaustive_repeat_suite``: ``exhaustive_repeat``'s
closed loop of one client's exhaustive checks from ``Init`` on one warm
engine, for a configuration that checks a list of invariants beyond
TypeOK (its ``invariants``, in the cfg's order).

Set-up, window and profile are ``exhaustive_repeat``'s (a private copy
of that module, so that its check summaries gain a field without
touching the kind the other cells run): each check also records
``invariants``, the names the program evaluated
(``EngineResult.invariants``).  A program whose result has that field
and whose checks lack it is wrong, so a lost summary fails loudly; a
program without the field is judged by the engine's ``inv_names``.

``prepare`` refuses an engine whose invariants are not the
configuration's, or whose v4 front does not run the lanes launch's
build with the safety suite.  Every predicate holds on every reachable
state, so the checks' answers cannot see a predicate that never fires;
``release`` therefore drives the engine's own front (the object the
window timed, at its batch) on ``suite_parents`` unstructured parents
drawn from ``--seed`` (``models/smoke.py random_states``), whose
successors violate every predicate somewhere, and holds each live
lane's first failing invariant against ``reference/suite.py
first_failing`` on the decoded successor, before the engine's memory
is given back (outside the window and the set-up).  ``judge`` holds
every check against the reference's search with the same list
(``suite.bfs_suite``): live to ``reference_live_depth`` in every run,
deeper from the frozen profile (``profiles/<config>.json``) the live
levels must match; a check whose list is not the configuration's is
wrong, and so is every lane whose first failing invariant is not the
reference's (``suite_lanes_wrong``).

Parameters as ``exhaustive_repeat``'s, and ``suite_parents``.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib.util
import os
import sys

from portbench.reference import compare, oracle, suite

SUITE_BUILD = "suite"


def _private_base():
    """A copy of ``exhaustive_repeat`` of this kind's own."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "exhaustive_repeat.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_traffic_exhaustive_repeat_of_suite", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


_base = _private_base()
_plain_summary = _base.summary
State, Profile = _base.State, _base.Profile


def summary(res, t_start: float, t_end: float) -> dict:
    """``exhaustive_repeat``'s summary, with the invariants the check
    evaluated where the result has them."""
    out = _plain_summary(res, t_start, t_end)
    if hasattr(res, "invariants"):
        out["invariants"] = list(res.invariants)
    return out


# The copy's window and profile summarise each check with this kind's.
_base.summary = summary


def front_of(engine):
    """The v4 front the engine's step runs (None on other plans)."""
    front = engine._step.body.stages.front
    return front if hasattr(front, "suite") else None


def front_build(front) -> str:
    """The build of a front's lanes launch: ``typeok``, ``suite`` or
    ``reconfig`` (None without a front)."""
    if front is None:
        return None
    return ("reconfig" if front.reconfig
            else SUITE_BUILD if front.suite else "typeok")


def prepare(run) -> State:
    from raft_tla_tpu_torch.engine.bfs import EngineResult
    state = _base.prepare(run)
    eng = state.engine
    want = list(run.config["invariants"])
    if list(eng.inv_names) != want:
        raise ValueError(f"the program evaluates {list(eng.inv_names)}, "
                         f"the configuration states {want}")
    build = front_build(front_of(eng))
    if build != SUITE_BUILD:
        raise ValueError(f"the program's front runs the {build!r} build, "
                         f"not the {SUITE_BUILD!r} one")
    # Whether a check's summary has to say what it evaluated, and what it
    # evaluated where it cannot.
    run.records_invariants = "invariants" in {
        f.name for f in dataclasses.fields(EngineResult)}
    run.inv_names = want
    return state


def window(state: State, run, seconds: float):
    return _base.window(state, run, seconds)


def profile(state: State, run) -> Profile:
    return _base.profile(state, run)


def suite_lanes(front, dims, device, ref_dims: oracle.Dims, names,
                parents: int, seed: int) -> dict:
    """``front`` (of the program's ``dims``, on ``device``) on ``parents``
    random parents (``random_states`` at ``seed``, at most one message
    each: with more, most lanes fail MessagesInv first), ``front.B`` a
    call, each call from the first parent the last one left: ``lanes``,
    the live lanes; ``wrong``, those whose first failing invariant (an
    index into ``names``, -1 where all hold) is not
    ``suite.first_failing``'s on the decoded successor; ``first``, the
    lanes by the reference's first failing name."""
    import torch
    from raft_tla_tpu_torch.models import smoke
    from raft_tla_tpu_torch.models.schema import (
        StateBatch, decode_state, encode_state, flatten_state,
        stack_states, unflatten_state)
    states = smoke.random_states(dims, parents, seed=seed, max_msgs=1)
    rows = flatten_state(stack_states([encode_state(s, dims)
                                       for s in states], "cpu"), dims)
    B = front.B
    lanes = wrong = offset = 0
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
            ref = suite.first_failing(
                oracle.PyState(**{f.name: getattr(s, f.name)
                                  for f in dataclasses.fields(s)}),
                ref_dims, names)
            lanes += 1
            first[str(ref)] += 1
            wrong += got[i] != (-1 if ref is None else names.index(ref))
        offset += max(int(out.P), 1)
    return {"lanes": lanes, "wrong": wrong, "first": dict(first)}


def release(state: State, run) -> None:
    """The front's lanes against the reference's first failing
    invariant, then the engine's device memory given back."""
    eng = state.engine
    run.suite_lanes = suite_lanes(
        front_of(eng), eng.dims, eng.device,
        oracle.Dims(**run.config["constants"]),
        list(run.config["invariants"]), int(run.params["suite_parents"]),
        run.seed & (2**64 - 1))
    print(f"suite lanes: {run.suite_lanes}", file=sys.stderr, flush=True)
    _base.release(state, run)


def reference_answer(config: dict, depth: int, live_depth: int):
    """The reference's answer to a check to ``depth`` with the
    configuration's invariants, and the widest gap between its live
    search to ``live_depth`` and the frozen profile."""
    dims = oracle.Dims(**config["constants"])
    # The answer from the frozen profile (the oracle's search to level 0
    # is the root alone); the live levels are the suite's search.
    answer, _gap = compare.reference_answer(config["name"], dims, depth,
                                            live_depth=0)
    live = suite.bfs_suite(dims, min(live_depth, depth),
                           config["invariants"])
    return answer, suite.profile_gap(live,
                                     compare.load_profile(config["name"]))


def judge(run) -> dict:
    """Every check of the window (and of the traced sub-window) against
    the reference's answer; a check whose invariants are not the
    configuration's is wrong too.  ``suite_lanes_wrong``: the front's
    lanes whose first failing invariant is not the reference's (1 where
    no lane was compared)."""
    ref, gap = reference_answer(run.config, run.params["max_diameter"],
                                run.params["reference_live_depth"])
    want = list(run.config["invariants"])
    checks = list(run.checks)
    if run.profile is not None:
        checks += run.profile.checks
    out = compare.judge(checks, ref, prefix_gap=gap)
    if getattr(run, "records_invariants", True):
        lists = [c.get("invariants") for c in checks]
    else:
        lists = [run.inv_names] * len(checks)
    bad_list = [got != want for got in lists]
    wrong = sum(1 for c, bad in zip(checks, bad_list)
                if bad or compare.judge([c], ref)["checks_wrong"][0])
    out["checks_wrong"] = (wrong if checks else 1, 0)
    out["invariants_wrong"] = (sum(bad_list), 0)
    lanes = getattr(run, "suite_lanes", None) or {"lanes": 0}
    out["suite_lanes_wrong"] = (lanes["wrong"] if lanes["lanes"] else 1, 0)
    return out
