"""Canonical pure-Python state: the host-side view of one Raft state.

An immutable, hashable mirror of the spec's state vector, used for roots,
violations and counterexample steps.  Messages are flat tuples
``(mtype, msource, mdest, mterm, payload...)`` with the payload per type

    RVQ: (mlastLogTerm, mlastLogIndex)
    RVR: (mvoteGranted, mlog)            mlog = ((term, value), ...)
    AEQ: (mprevLogIndex, mprevLogTerm, mentries, mcommitIndex)
    AER: (msuccess, mmatchIndex)

and the bag is a ``frozenset`` of ``(message, count)`` pairs.  Same
layout as the JAX package's ``models/pystate.py``, so the two convert with
``dataclasses.astuple``.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, Tuple

from .dims import FOLLOWER, MSG_TYPE_NAMES, NIL, RVQ, RVR, AEQ, RaftDims

Entry = Tuple[int, int]
Log = Tuple[Entry, ...]
Message = Tuple
Bag = FrozenSet[Tuple[Message, int]]


@dataclasses.dataclass(frozen=True)
class PyState:
    """One global state of the Raft spec."""

    current_term: Tuple[int, ...]
    role: Tuple[int, ...]
    voted_for: Tuple[int, ...]
    log: Tuple[Log, ...]
    commit_index: Tuple[int, ...]
    votes_responded: Tuple[int, ...]
    votes_granted: Tuple[int, ...]
    next_index: Tuple[Tuple[int, ...], ...]
    match_index: Tuple[Tuple[int, ...], ...]
    messages: Bag

    def replace(self, **kw) -> "PyState":
        return dataclasses.replace(self, **kw)


def init_state(dims: RaftDims) -> PyState:
    """The unique initial state (``Init``)."""
    n = dims.n_servers
    return PyState(
        current_term=(1,) * n,
        role=(FOLLOWER,) * n,
        voted_for=(NIL,) * n,
        log=((),) * n,
        commit_index=(0,) * n,
        votes_responded=(0,) * n,
        votes_granted=(0,) * n,
        next_index=tuple((1,) * n for _ in range(n)),
        match_index=tuple((0,) * n for _ in range(n)),
        messages=frozenset(),
    )


# The bag: WithMessage / WithoutMessage / Reply of the spec.

def bag_add(bag: Bag, m: Message) -> Bag:
    d = dict(bag)
    d[m] = d.get(m, 0) + 1
    return frozenset(d.items())


def bag_remove(bag: Bag, m: Message) -> Bag:
    d = dict(bag)
    c = d.get(m, 0)
    if c <= 1:
        d.pop(m, None)
    else:
        d[m] = c - 1
    return frozenset(d.items())


def bag_reply(bag: Bag, response: Message, request: Message) -> Bag:
    """Add ``response`` and remove ``request`` in one step."""
    return bag_remove(bag_add(bag, response), request)


# Printing: ``state_fields`` is the one decoded view of a state (JSON-able,
# per-server fields and the message bag); ``format_state``, ``diff_states``
# and the counterexample explainer (engine/explain.py) all render from it,
# as in the JAX package's ``models/pystate.py``.  A reconfiguration
# variant's config entries print as their encoded log values.

ROLE_LETTERS = {0: "F", 1: "C", 2: "L"}
ROLE_NAMES = {0: "Follower", 1: "Candidate", 2: "Leader"}


def format_message(m: Message, dims: RaftDims) -> str:
    t = m[0]
    head = f"{MSG_TYPE_NAMES[t]} r{m[1]+1}->r{m[2]+1} term={m[3]}"
    if t == RVQ:
        return head + f" lastLogTerm={m[4]} lastLogIndex={m[5]}"
    if t == RVR:
        return head + f" granted={bool(m[4])} mlog={list(m[5])}"
    if t == AEQ:
        return (head + f" prevLogIndex={m[4]} prevLogTerm={m[5]}"
                f" entries={list(m[6])} commitIndex={m[7]}")
    return head + f" success={bool(m[4])} matchIndex={m[5]}"


def state_fields(s: PyState, dims: RaftDims) -> dict:
    """``{"r<i>.<field>": value}`` per server and the sorted message bag
    under ``"messages"``."""
    n = dims.n_servers
    out = {}
    for i in range(n):
        r = f"r{i+1}"
        out[f"{r}.term"] = s.current_term[i]
        out[f"{r}.role"] = ROLE_LETTERS.get(s.role[i], str(s.role[i]))
        out[f"{r}.votedFor"] = ("Nil" if s.voted_for[i] == NIL
                                else f"r{s.voted_for[i]}")
        out[f"{r}.log"] = [list(e) for e in s.log[i]]
        out[f"{r}.commitIndex"] = s.commit_index[i]
        out[f"{r}.votesResponded"] = f"{s.votes_responded[i]:0{n}b}"
        out[f"{r}.votesGranted"] = f"{s.votes_granted[i]:0{n}b}"
        out[f"{r}.nextIndex"] = list(s.next_index[i])
        out[f"{r}.matchIndex"] = list(s.match_index[i])
    out["messages"] = [{"count": c, "msg": format_message(m, dims)}
                       for m, c in sorted(s.messages)]
    return out


def diff_states(a: PyState, b: PyState, dims: RaftDims) -> dict:
    """The fields changed from ``a`` to ``b`` as ``{key: [old, new]}``
    over the ``state_fields`` keys; the bag as ``messages.added`` and
    ``messages.removed`` lines."""
    fa, fb = state_fields(a, dims), state_fields(b, dims)
    out = {}
    for k in fa:
        if k == "messages":
            continue
        if fa[k] != fb[k]:
            out[k] = [fa[k], fb[k]]
    da = dict(a.messages)
    db = dict(b.messages)
    added = [f"{db[m] - da.get(m, 0)}x {format_message(m, dims)}"
             for m in sorted(db) if db[m] > da.get(m, 0)]
    removed = [f"{da[m] - db.get(m, 0)}x {format_message(m, dims)}"
               for m in sorted(da) if da[m] > db.get(m, 0)]
    if added:
        out["messages.added"] = added
    if removed:
        out["messages.removed"] = removed
    return out


def format_state(s: PyState, dims: RaftDims) -> str:
    n = dims.n_servers
    f = state_fields(s, dims)
    lines = []
    for i in range(n):
        r = f"r{i+1}"
        log = [tuple(e) for e in f[f"{r}.log"]]
        lines.append(
            f"  {r}: term={f[f'{r}.term']} role={f[f'{r}.role']}"
            f" votedFor={f[f'{r}.votedFor']} log={log}"
            f" commit={f[f'{r}.commitIndex']}"
            f" resp={f[f'{r}.votesResponded']} gran={f[f'{r}.votesGranted']}"
            f" nextIndex={f[f'{r}.nextIndex']}"
            f" matchIndex={f[f'{r}.matchIndex']}")
    msgs = f["messages"]
    lines.append(f"  messages ({len(msgs)} distinct):")
    for m in msgs:
        lines.append(f"    {m['count']}x {m['msg']}")
    return "\n".join(lines)


def probe_states(dims: RaftDims):
    """Type-correct states that together enable every base action
    instance (the JAX package's POR probes; they need not be reachable):
    the initial state; every server a candidate with a granted quorum and
    no recorded responses; every server a leader; every message slot
    holding a distinct single-copy request whose term is above every
    server's."""
    from .dims import CANDIDATE, LEADER
    n = dims.n_servers
    base = init_state(dims)
    full = (1 << n) - 1
    out = [base]
    out.append(base.replace(role=(CANDIDATE,) * n,
                            current_term=(2,) * n,
                            votes_granted=(full,) * n))
    out.append(base.replace(role=(LEADER,) * n, current_term=(2,) * n))
    msgs = []
    for s in range(dims.n_msg_slots):
        src = s % n
        dst = (s // n) % n
        last_idx = s // (n * n)
        msgs.append(((RVQ, src, dst, 2, 0, last_idx), 1))
    out.append(base.replace(messages=frozenset(msgs)))
    return out
