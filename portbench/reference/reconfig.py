"""The plain reference of the joint-consensus reconfiguration variant:
raft.tla's transition system with membership change as the Raft paper's
Section 6 (Figs. 10-11) gives it, TypeOK and the nine safety predicates,
and TLC's search with them.

The variant, as ``configs/reconfig3.cfg`` runs it:

- **Configurations ride in the log.**  ``CFG_BASE + (old << 8) + new`` is
  the joint configuration C_old,new and ``CFG_BASE + new`` the final
  configuration C_new (membership bitmasks over the servers, server i is
  bit i); client values 1..V stay below ``CFG_BASE``, so config entries
  replicate and truncate through AppendEntries as any other entry does.
- **A server uses the latest configuration in its own log**, committed
  or not, and the full membership when its log holds none (``config_of``).
- **Quorums** (``quorum``): under a joint configuration a majority of
  C_old and a majority of C_new; under a final one a majority of it.
  BecomeLeader counts the votes granted to i, AdvanceCommitIndex the
  servers whose match index reaches an index (with i itself), each by
  i's own configuration.
- **InitiateReconfig(i, c)**: a leader whose configuration is final (one
  change at a time) appends the joint entry C_current,c for a target
  ``c`` of ``TargetConfigs`` other than its current one.
- **FinalizeReconfig(i)**: a leader whose configuration is the joint
  C_old,new, with its commitIndex at that entry or past it, appends
  C_new.
- **TypeOK** admits a log value that is a client value or a config
  entry whose masks are subsets of the servers, the new one nonempty.

The other eight families are ``oracle.py``'s, unchanged, and the nine
predicates are ``suite.py``'s: raft.tla writes them with simple
majorities, and with every target a majority of the servers (``{3, 7}``
of three servers) every quorum of either configuration is one too, so
they are what joint consensus keeps.  They compare whole log entries,
so a config entry is compared as the full value it is.  This module
imports only ``oracle.py`` and ``suite.py``.  Run as a script it freezes
a configuration's profile, levels 0 to ``--depth`` of ``bfs_reconfig``
with the configuration's ``invariants`` (on the host alone; reconfig3 to
depth 12 holds 19.8M states in memory, ~30 GB and ~25 min of one core):

    python3 portbench/reference/reconfig.py --config reconfig3_safety \
        --depth 12 --out portbench/reference/profiles/reconfig3_safety.json

The control, the same search keyed on 32 bits of a seeded hash (the
nearest precision below the program's 64-bit fingerprints), and its
verdict against the frozen profile (it must come out not correct):

    python3 portbench/reference/reconfig.py --config reconfig3_safety \
        --depth 12 --bits 32 --seed 7 --out control.json
    python3 portbench/reference/reconfig.py --config reconfig3_safety \
        --depth 12 --out control.json --judge
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    __package__ = "portbench.reference"

from . import oracle, suite  # noqa: E402
from .oracle import (A_ADVANCECOMMIT, A_APPENDENTRIES,  # noqa: E402
                     A_BECOMELEADER, A_CLIENTREQUEST, A_DROP, A_DUPLICATE,
                     A_RECEIVE, A_REQUESTVOTE, A_RESTART, A_TIMEOUT,
                     CANDIDATE, LEADER, Answer, PyState, _set, _setrow)

#: Log values at or above it are config entries, below it client values.
CFG_BASE = 1 << 12
A_INITIATE, A_FINALIZE = 10, 11

#: The twelve families: the spec's ten, then the variant's two.
FAMILY_NAMES = oracle.FAMILY_NAMES + ("InitiateReconfig", "FinalizeReconfig")


@dataclasses.dataclass(frozen=True)
class Dims(oracle.Dims):
    """The spec's constants and ``TargetConfigs``: the membership
    bitmasks a leader may move to."""

    targets: Tuple[int, ...] = ()

    def __post_init__(self):
        full = (1 << self.n_servers) - 1
        if not self.targets or not all(1 <= c <= full for c in self.targets):
            raise ValueError(f"targets {self.targets} are not nonempty "
                             f"subsets of {self.n_servers} servers")
        object.__setattr__(self, "targets", tuple(self.targets))


def joint_value(old: int, new: int) -> int:
    """The log value of the joint entry C_old,new."""
    return CFG_BASE + (old << 8) + new


def final_value(new: int) -> int:
    """The log value of the final entry C_new."""
    return CFG_BASE + new


def config_of(log, n: int) -> Tuple[int, int, int]:
    """``(old, new, index)`` of the latest config entry of ``log`` (old 0
    for a final one, index 1-based); ``(0, full, 0)`` with none."""
    for idx in range(len(log), 0, -1):
        v = log[idx - 1][1]
        if v >= CFG_BASE:
            return (v - CFG_BASE) >> 8, (v - CFG_BASE) & 0xFF, idx
    return 0, (1 << n) - 1, 0


def is_joint(s: PyState, n: int) -> bool:
    """Whether some server's latest config entry is joint: where
    BecomeLeader and AdvanceCommitIndex take majorities of both."""
    return any(config_of(log, n)[0] > 0 for log in s.log)


def quorum(s: PyState, i: int, mask: int, n: int) -> bool:
    """Is the server set ``mask`` a quorum in server i's configuration."""
    old, new, _idx = config_of(s.log[i], n)

    def majority(cfg: int) -> bool:
        return 2 * bin(mask & cfg).count("1") > bin(cfg).count("1")

    return majority(old) and majority(new) if old else majority(new)


# -- the two families the joint quorum changes --------------------------------

def become_leader(s: PyState, dims: Dims, i: int) -> Optional[PyState]:
    """BecomeLeader(i) (raft.tla:195-203) with i's configuration."""
    n = dims.n_servers
    if s.role[i] != CANDIDATE or not quorum(s, i, s.votes_granted[i], n):
        return None
    return s.replace(
        role=_set(s.role, i, LEADER),
        next_index=_setrow(s.next_index, i, (len(s.log[i]) + 1,) * n),
        match_index=_setrow(s.match_index, i, (0,) * n))


def advance_commit_index(s: PyState, dims: Dims, i: int) -> Optional[PyState]:
    """AdvanceCommitIndex(i) (raft.tla:219-236) with i's configuration."""
    if s.role[i] != LEADER:
        return None
    n, log_i = dims.n_servers, s.log[i]

    def agree(index: int) -> bool:
        mask = (1 << i) | sum(1 << k for k in range(n)
                              if s.match_index[i][k] >= index)
        return quorum(s, i, mask, n)

    agreed = [idx for idx in range(1, len(log_i) + 1) if agree(idx)]
    commit = s.commit_index[i]
    if agreed and log_i[max(agreed) - 1][0] == s.current_term[i]:
        commit = max(agreed)
    return s.replace(commit_index=_set(s.commit_index, i, commit))


# -- the variant's two families -----------------------------------------------

def _append(s: PyState, i: int, value: int) -> PyState:
    entry = (s.current_term[i], value)
    return s.replace(log=_set(s.log, i, s.log[i] + (entry,)))


def initiate_reconfig(s: PyState, dims: Dims, i: int,
                      c: int) -> Optional[PyState]:
    """InitiateReconfig(i, c): a leader whose configuration C is final
    appends C,c for a target c /= C."""
    old, new, _idx = config_of(s.log[i], dims.n_servers)
    if s.role[i] != LEADER or old or c == new:
        return None
    return _append(s, i, joint_value(new, c))


def finalize_reconfig(s: PyState, dims: Dims, i: int) -> Optional[PyState]:
    """FinalizeReconfig(i): a leader whose configuration is C_old,new,
    committed at its index, appends C_new."""
    old, new, idx = config_of(s.log[i], dims.n_servers)
    if s.role[i] != LEADER or not old or s.commit_index[i] < idx:
        return None
    return _append(s, i, final_value(new))


def successors(s: PyState, dims: Dims) -> List[Tuple[oracle.Action,
                                                      PyState]]:
    """Every (action, successor) of the variant's Next: the spec's ten
    families (BecomeLeader and AdvanceCommitIndex with the joint quorum),
    then InitiateReconfig and FinalizeReconfig."""
    n, v = dims.n_servers, dims.n_values
    out = []

    def add(fam, params, t):
        if t is not None:
            out.append(((fam, params), t))

    for i in range(n):
        add(A_RESTART, (i,), oracle.restart(s, dims, i))
        add(A_TIMEOUT, (i,), oracle.timeout(s, dims, i))
        add(A_BECOMELEADER, (i,), become_leader(s, dims, i))
        add(A_ADVANCECOMMIT, (i,), advance_commit_index(s, dims, i))
        for j in range(n):
            add(A_REQUESTVOTE, (i, j), oracle.request_vote(s, dims, i, j))
            add(A_APPENDENTRIES, (i, j),
                oracle.append_entries(s, dims, i, j))
        for val in range(1, v + 1):
            add(A_CLIENTREQUEST, (i, val),
                oracle.client_request(s, dims, i, val))
    for m, _count in s.messages:
        add(A_RECEIVE, (m,), oracle.receive(s, dims, m))
        add(A_DUPLICATE, (m,), oracle.duplicate_message(s, m))
        add(A_DROP, (m,), oracle.drop_message(s, m))
    for i in range(n):
        for c in dims.targets:
            add(A_INITIATE, (i, c), initiate_reconfig(s, dims, i, c))
        add(A_FINALIZE, (i,), finalize_reconfig(s, dims, i))
    return out


# -- TypeOK and the nine ------------------------------------------------------

def value_ok(val: int, dims: Dims) -> bool:
    """A client value, or a config entry: old a subset of the servers,
    new a nonempty one."""
    if 1 <= val <= dims.n_values:
        return True
    full = (1 << dims.n_servers) - 1
    enc = val - CFG_BASE
    return (val >= CFG_BASE and enc >> 16 == 0 and 1 <= enc & 0xFF <= full
            and enc >> 8 <= full)


def type_ok(s: PyState, dims: Dims) -> bool:
    """TypeOK with the config values (``oracle.type_ok`` for the rest)."""
    if not all(value_ok(val, dims) for log in s.log for _t, val in log):
        return False
    client = s.replace(log=tuple(tuple((t, 1) for t, _v in log)
                                 for log in s.log))
    return oracle.type_ok(client, dims)


#: Name -> predicate: TypeOK widened, then ``suite.py``'s nine.
PREDICATES = dict(suite.PREDICATES, TypeOK=type_ok)


def first_failing(s: PyState, dims: Dims,
                  names: Sequence[str]) -> Optional[str]:
    """The first of ``names`` (in order) that ``s`` violates, else None."""
    missing = [nm for nm in names if nm not in PREDICATES]
    if missing:
        raise KeyError(f"no reference predicate for {missing}")
    for name in names:
        if not PREDICATES[name](s, dims):
            return name
    return None


# -- TLC's search -------------------------------------------------------------

@dataclasses.dataclass
class ReconfigAnswer(Answer):
    """``oracle.Answer`` over the twelve families, and per level the
    cumulative count of distinct states with a joint configuration
    (``is_joint``)."""

    joint: List[int] = dataclasses.field(default_factory=list)
    violating_state: Optional[PyState] = None


def bfs_reconfig(dims: Dims, depth: int, names: Sequence[str],
                 progress=None, key_bits: Optional[int] = None,
                 seed: int = 0) -> ReconfigAnswer:
    """``suite.bfs_suite``'s search from ``Init`` to ``depth`` levels with
    the variant's successors: every new distinct state (one that fails the
    constraint too) checked against ``names`` in order, the first failing
    name recorded.  Keyed on the state itself, or with ``key_bits`` on the
    low ``key_bits`` bits of ``hash((seed, state))`` (a fingerprint of
    that many bits, as ``oracle.bfs`` keys the control).  ``progress``,
    where given, is called with the answer after each level."""
    first_failing(oracle.init_state(dims), dims, names)   # names resolve
    n = dims.n_servers
    mask = None if key_bits is None else (1 << key_bits) - 1
    seen: set = set()
    ans = ReconfigAnswer(levels=[], distinct=[], generated=[])
    count = generated = joint = 0

    def admit(t: PyState) -> bool:
        nonlocal count, joint
        key = t if mask is None else hash((seed, t)) & mask
        if key in seen:
            return False
        seen.add(key)
        count += 1
        joint += is_joint(t, n)
        failing = first_failing(t, dims, names)
        if ans.violation is None and failing is not None:
            ans.violation = failing
            ans.violating_state = t
        return oracle.bounded_space(t, dims)

    def close(n_level: int, by_family) -> None:
        ans.levels.append(n_level)
        ans.distinct.append(count)
        ans.generated.append(generated)
        ans.actions.append(list(by_family))
        ans.joint.append(joint)
        if progress is not None:
            progress(ans)

    root = oracle.init_state(dims)
    frontier = [root] if admit(root) else []
    by_family = [0] * len(FAMILY_NAMES)
    close(len(frontier), by_family)
    for level in range(1, depth + 1):
        keep = level < depth            # the last level is counted, not kept
        nxt, n_next = [], 0
        for s in frontier:
            succ = successors(s, dims)
            generated += len(succ)
            if not succ:
                ans.deadlock = True
            for (fam, _params), t in succ:
                by_family[fam] += 1
                if admit(t):
                    n_next += 1
                    if keep:
                        nxt.append(t)
        frontier = nxt
        close(n_next, by_family)
    return ans


def profile_gap(live: ReconfigAnswer, prof: dict) -> int:
    """``suite.profile_gap`` with the joint counts too."""
    gap = suite.profile_gap(live, prof)
    for a, b in zip(live.joint, prof["joint"]):
        gap = max(gap, abs(a - b))
    return gap


def dims_of(config: dict) -> Dims:
    """The reference's constants of a configuration (its JSON)."""
    c = dict(config["constants"])
    return Dims(targets=tuple(c.pop("targets")), **c)


# -- the frozen profile -------------------------------------------------------

def freeze(config: dict, depth: int, key_bits: Optional[int] = None,
           seed: int = 0) -> dict:
    """A configuration's profile: ``bfs_reconfig`` with its
    ``invariants`` to ``depth``, in the layout of
    ``profiles/<config>.json``; a violation found is recorded with the
    state.  With ``key_bits``, the control's search in the same layout."""
    t = time.time()

    def progress(ans):
        print(f"level {len(ans.levels) - 1}: {ans.levels[-1]} new, "
              f"{ans.distinct[-1]} distinct, {ans.generated[-1]} generated, "
              f"{ans.joint[-1]} joint, {time.time() - t:.0f} s",
              file=sys.stderr, flush=True)

    ans = bfs_reconfig(dims_of(config), depth, config["invariants"],
                       progress, key_bits, seed)
    keyed = ("the state itself" if key_bits is None else
             f"the low {key_bits} bits of hash((seed {seed}, state))")
    out = {"what": (f"{config['name']} from Init: levels 0-{depth} of "
                    f"portbench/reference/reconfig.py bfs_reconfig (the "
                    f"oracle's transition system with joint-consensus "
                    f"membership change, keyed on {keyed}) with "
                    f"the invariants {', '.join(config['invariants'])}, "
                    f"each checked on every distinct state; actions: the "
                    f"cumulative generated count of each family in the "
                    f"order of reconfig.FAMILY_NAMES; joint: the "
                    f"cumulative distinct states in which some server's "
                    f"latest config entry is joint; "
                    f"{datetime.date.today().isoformat()}, "
                    f"{time.time() - t:.0f} s"),
           "families": list(FAMILY_NAMES),
           "levels": ans.levels, "distinct": ans.distinct,
           "generated": ans.generated, "joint": ans.joint,
           "violation": ans.violation, "deadlock": ans.deadlock,
           "actions": ans.actions}
    if ans.violation is not None:
        out["violating_state"] = repr(ans.violating_state)
    return out


def control_verdict(config: dict, depth: int, answer: dict) -> dict:
    """A search's answer (``freeze``'s layout; the control's) judged as a
    check of the program would be against the frozen profile
    (``compare.judge``, and ``joint_gap``): the compared numbers with
    their limits, and whether they make it correct."""
    from . import compare
    prof = compare.load_profile(config["name"])
    ref = {"levels": prof["levels"][:depth + 1],
           "distinct": prof["distinct"][depth],
           "generated": prof["generated"][depth],
           "actions": dict(zip(FAMILY_NAMES, prof["actions"][depth])),
           "diameter": depth, "stop_reason": compare.STOP_AT_DEPTH,
           "violation": prof["violation"], "deadlock": prof["deadlock"]}
    check = {"levels": answer["levels"][:depth + 1],
             "distinct": answer["distinct"][depth],
             "generated": answer["generated"][depth],
             "action_counts": dict(zip(FAMILY_NAMES,
                                       answer["actions"][depth])),
             "diameter": depth, "stop_reason": compare.STOP_AT_DEPTH,
             "violation": answer["violation"],
             "deadlock": answer["deadlock"]}
    compared = compare.judge([check], ref)
    compared["joint_gap"] = (abs(answer["joint"][depth]
                                 - prof["joint"][depth]), 0)
    return {"correct": compare.is_correct(compared),
            "compared": {k: {"value": v, "limit": lim}
                         for k, (v, lim) in compared.items()}}


def load_config(name: str) -> dict:
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "configs", f"{name}.json")
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="freeze a reconfiguration "
                                 "configuration's profile, or run the "
                                 "control (--bits) and judge it")
    ap.add_argument("--config", required=True)
    ap.add_argument("--depth", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--bits", type=int, default=None,
                    help="key the search on this many bits of a seeded "
                    "hash (the control)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--judge", action="store_true",
                    help="judge the answer in --out against the frozen "
                    "profile (control_verdict) and print the verdict")
    a = ap.parse_args(argv)
    config = load_config(a.config)
    if a.judge:
        with open(a.out) as f:
            print(json.dumps(control_verdict(config, a.depth, json.load(f))),
                  flush=True)
        return 0
    prof = freeze(config, a.depth, a.bits, a.seed)
    with open(a.out, "w") as f:
        json.dump(prof, f)
    print(json.dumps({k: v for k, v in prof.items() if k != "actions"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
