"""Invariant and state-constraint predicates on batched states.

``type_ok`` is the residual content of TypeOK that the fixed-width
encoding does not force (roles, votedFor, log lanes, bitmasks, message
rows); ``no_leader`` is the deliberately falsifiable ``NoLeaderElected``
canary; the safety suite lives in ``models/safety.py``.
``build_constraint`` is ``BoundedSpace`` over the cfg bounds: a state
that fails it is counted and checked but never expanded.  Each
predicate maps ``StateBatch [X] -> [X] bool``; the JAX package's
``models/invariants.py`` defines the same predicates per state.

Each built predicate carries its registry name as ``.predicate`` (and the
constraint its ``.bounds``): the v4 front kernel evaluates the predicates
it has device code for by name (``ops/chunk_front_cuda.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .dims import LEADER, RaftDims
from .pystate import PyState
from .safety import SAFETY_INVARIANTS
from .schema import StateBatch


@dataclasses.dataclass(frozen=True)
class Bounds:
    """CONSTRAINT bounds for exhaustive runs."""

    max_term: Optional[int] = None        # \A i : currentTerm[i] <= MaxTerm
    max_log_len: Optional[int] = None     # \A i : Len(log[i]) <= MaxLogLen
    max_msg_count: Optional[int] = None   # \A m : messages[m] <= MaxMsgCount
    max_in_flight: Optional[int] = None   # Cardinality(DOMAIN messages)


def build_type_ok(dims: RaftDims):
    N, L = dims.n_servers, dims.max_log
    value_ok = dims.build_value_ok()     # entries in Value, as a variant
                                         # widens it

    def type_ok(st: StateBatch):
        lane = torch.arange(L, device=st.term.device)
        in_log = lane[None, None, :] < st.log_len[:, :, None]
        occ = st.msg_cnt > 0
        mt, src, dst = st.msg[:, :, 0], st.msg[:, :, 1], st.msg[:, :, 2]
        val_ok = value_ok(st.log_val)
        checks = [
            ((st.role >= 0) & (st.role <= 2)).all(1),
            ((st.voted_for >= 0) & (st.voted_for <= N)).all(1),
            torch.where(in_log, (st.log_term >= 0) & val_ok,
                        (st.log_term == 0) & (st.log_val == 0)).all(2).all(1),
            ((st.log_len >= 0) & (st.log_len <= L)).all(1),
            (st.term >= 0).all(1) & (st.commit >= 0).all(1),
            ((st.votes_resp >= 0) & (st.votes_resp < (1 << N))).all(1),
            ((st.votes_gran >= 0) & (st.votes_gran < (1 << N))).all(1),
            (st.next_idx >= 1).all(2).all(1),
            (st.match_idx >= 0).all(2).all(1),
            torch.where(occ,
                        (mt >= 1) & (mt <= 4) & (src >= 1) & (src <= N)
                        & (dst >= 1) & (dst <= N) & (st.msg[:, :, 3] >= 0),
                        (st.msg == 0).all(2)).all(1),
            (st.msg_cnt >= 0).all(1),
        ]
        out = checks[0]
        for c in checks[1:]:
            out = out & c
        return out

    type_ok.predicate = "TypeOK"
    return type_ok


def type_ok_py(s: PyState, dims: RaftDims) -> bool:
    """TypeOK on one ``PyState``: the content checks of ``build_type_ok``
    that a PyState can fail."""
    n = dims.n_servers
    ok = all(0 <= r <= 2 for r in s.role)
    ok &= all(0 <= vf <= n for vf in s.voted_for)
    ok &= all(t >= 0 and dims.value_ok_py(val)
              for log in s.log for (t, val) in log)
    ok &= all(t >= 0 for t in s.current_term)
    ok &= all(c >= 0 for c in s.commit_index)
    ok &= all(0 <= m < (1 << n)
              for m in s.votes_responded + s.votes_granted)
    ok &= all(x >= 1 for row in s.next_index for x in row)
    ok &= all(x >= 0 for row in s.match_index for x in row)
    ok &= all(c >= 1 for _m, c in s.messages)
    return ok


def build_no_leader(dims: RaftDims):
    def no_leader(st: StateBatch):
        return (st.role != LEADER).all(1)

    no_leader.predicate = "NoLeaderElected"
    return no_leader


def build_inv_id(inv_fns):
    """``inv_id(st) -> [X] int64``: index of the first violated invariant
    in ``inv_fns`` order, -1 where all hold."""

    def inv_id(st: StateBatch):
        out = torch.full(st.term.shape[:1], -1, dtype=torch.int64,
                         device=st.term.device)
        for q in range(len(inv_fns) - 1, -1, -1):
            out = torch.where(inv_fns[q](st), out, q)
        return out

    return inv_id


def build_constraint(dims: RaftDims, bounds: Bounds):
    def constraint(st: StateBatch):
        ok = torch.ones(st.term.shape[:1], dtype=torch.bool,
                        device=st.term.device)
        if bounds.max_term is not None:
            ok = ok & (st.term <= bounds.max_term).all(1)
        if bounds.max_log_len is not None:
            ok = ok & (st.log_len <= bounds.max_log_len).all(1)
        if bounds.max_msg_count is not None:
            ok = ok & (st.msg_cnt <= bounds.max_msg_count).all(1)
        if bounds.max_in_flight is not None:
            ok = ok & ((st.msg_cnt > 0).sum(1) <= bounds.max_in_flight)
        return ok

    constraint.predicate = "BoundedSpace"
    constraint.bounds = bounds
    return constraint


def invariant_registry():
    """Name -> builder of every invariant a cfg can name: TypeOK, the
    NoLeaderElected canary and the safety suite (``models/safety.py``), in
    the JAX package's order."""
    return {"TypeOK": build_type_ok, "NoLeaderElected": build_no_leader,
            **SAFETY_INVARIANTS}
