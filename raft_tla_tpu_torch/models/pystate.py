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


ROLE_LETTERS = {0: "F", 1: "C", 2: "L"}


def format_message(m: Message) -> str:
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


def format_state(s: PyState, dims: RaftDims) -> str:
    lines = []
    for i in range(dims.n_servers):
        vf = "Nil" if s.voted_for[i] == NIL else f"r{s.voted_for[i]}"
        lines.append(
            f"  r{i+1}: term={s.current_term[i]} "
            f"role={ROLE_LETTERS.get(s.role[i], s.role[i])} "
            f"votedFor={vf}"
            f" log={list(s.log[i])} commit={s.commit_index[i]}"
            f" nextIndex={list(s.next_index[i])}"
            f" matchIndex={list(s.match_index[i])}")
    msgs = sorted(s.messages)
    lines.append(f"  messages ({len(msgs)} distinct):")
    for m, c in msgs:
        lines.append(f"    {c}x {format_message(m)}")
    return "\n".join(lines)
