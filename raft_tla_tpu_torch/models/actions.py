"""The classical (v1) successor pipeline on batched tensors.

The JAX package's ``models/actions.py``: each disjunct of ``Next``
(``raft.tla`` :421-430) is a branch-free function ``kernel(st, *params)
-> (enabled, overflow, successor)`` on a ``StateBatch`` of X rows with
one action instance a row (params ``[X, 1]``, the convention of the
variant hooks' ``dims.build_extra_kernels``), and ``build_expand``
evaluates every instance of the grid (``dims.family_sizes``, in the order
of ``dims.family_offsets``) for every parent of a batch.

The semantics are transcribed with the same faithfulness notes as
``models/oracle.py``: the hidden AppendEntriesAlreadyDone guard
(raft.tla:309 with :317), UpdateTerm leaving the message in flight
(:378), single-entry truncation (:323-324).  The ``Receive`` disjuncts
are pairwise exclusive (the term comparisons partition </=/>, the role
guards partition Follower/Candidate, the three Accept cases are
disjoint), so ``Receive`` is one select cascade with at most one
successor a message slot.  ``overflow`` marks the states the fixed-width
encoding cannot hold (a log past L, more than M distinct messages); the
engine stops on any.

Memory: the JAX package evaluates the whole ``[B, G]`` grid as structs
under ``vmap``.  Here each family runs on its parents repeated once per
instance, in pieces of at most ``lane_cap`` lanes, and each piece's
successors are packed straight into one ``[B·G, sw]`` uint8 row buffer
with their pack guard, so no struct of the whole grid is ever held: at
MCraft_bounded's batch of 2048 the buffer is 2048·132 rows.  Each
family writes its own columns of the grid, so the values are those of
the JAX package's dispatch, which stacks the families of each expansion
group (``family_groups``, kept in ``models/dims.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .actions2 import _add1, _first_true, _row, _set1, _set2, _setrow, \
    _t1, _t2, _w
from .dims import (  # noqa: F401  (family_groups: the JAX name)
    AEQ, AER, CANDIDATE, FOLLOWER, LEADER, NIL, RVQ, RVR, RaftDims,
    family_groups)
from .schema import (StateBatch, flatten_state, gather_states, pack_ok,
                     state_width)

#: Most lanes (parent x instance) one piece of the expansion holds.
LANE_CAP = 1 << 16


class Candidates(NamedTuple):
    """``build_expand``'s successors of a ``[B]`` batch: ``rows [B·G, sw]``
    uint8 (lane ``b·G + g``) and ``pack_ok [B, G]`` bool, whether each
    successor fits its row (the JAX engines fold ``en & ~pack_ok`` into
    the overflow)."""

    rows: torch.Tensor
    pack_ok: torch.Tensor


def _sel(cond, then_st: StateBatch, else_st: StateBatch) -> StateBatch:
    """Field-wise select on a ``[X, 1]`` condition."""
    return StateBatch(*(_w(cond, a, b) for a, b in zip(then_st, else_st)))


def build_kernels(dims: RaftDims, device):
    """``[(name, kernel, params)]`` in ``dims.family_names`` order: each
    ``kernel(st, *p) -> (enabled [X, 1], overflow [X, 1], successor)``
    for one instance a row (``p`` ``[X, 1]``), ``params`` the family's
    ``[C]`` parameter tables in grid order."""
    N, V, L, M, W = (dims.n_servers, dims.n_values, dims.max_log,
                     dims.n_msg_slots, dims.msg_width)
    quorum = dims.build_quorum()
    ar_n = torch.arange(N, device=device)
    idxs = torch.arange(1, L + 1, device=device)

    # -- helpers ------------------------------------------------------------
    def last_term(st, i):
        """LastTerm(log[i]) — raft.tla:84."""
        ln = _t1(st.log_len, i)
        return torch.where(ln > 0,
                           _t2(st.log_term, i, (ln - 1).clamp(0, L - 1)), 0)

    def mrow(cols: dict, like):
        """``[X, W]`` message rows from ``{column: [X, 1] tensor}``."""
        z = torch.zeros_like(like)
        return torch.cat([cols.get(c, z) for c in range(W)], 1)

    def base_cols(mtype, src, dst, mterm):
        return {0: torch.full_like(mterm, mtype + 1), 1: src + 1,
                2: dst + 1, 3: mterm}

    def bag_send(st, mvec):
        """Send(m) — raft.tla:95: the count +1, a free slot taken for a
        new message.  ``(successor, ok)``; not ok is a slot overflow."""
        eq = (st.msg == mvec.unsqueeze(1)).all(-1) & (st.msg_cnt > 0)
        has_eq = eq.any(1, keepdim=True)
        free = st.msg_cnt == 0
        ok = has_eq | free.any(1, keepdim=True)
        idx = torch.where(has_eq, _first_true(eq).unsqueeze(1),
                          _first_true(free).unsqueeze(1))
        row = _w(has_eq | ~ok, _row(st.msg, idx), mvec.unsqueeze(1))
        return st._replace(
            msg=_setrow(st.msg, idx, row),
            msg_cnt=_add1(st.msg_cnt, idx, torch.where(ok, 1, 0))), ok

    def bag_discard_slot(st, s):
        """Discard one copy of slot s's message — raft.tla:99; the row is
        zeroed when its count reaches 0 (a canonical free slot)."""
        new_cnt = _add1(st.msg_cnt, s, -1)
        cur = _row(st.msg, s)
        row = _w(_t1(new_cnt, s) > 0, cur, torch.zeros_like(cur))
        return st._replace(msg=_setrow(st.msg, s, row), msg_cnt=new_cnt)

    def reply_slot(st, resp, s):
        """Reply(resp, m @ slot s) — raft.tla:102-103."""
        return bag_send(bag_discard_slot(st, s), resp)

    def yes(i):
        return torch.ones_like(i, dtype=torch.bool)

    def no(i):
        return torch.zeros_like(i, dtype=torch.bool)

    # -- spontaneous server actions (raft.tla:136-236) ----------------------
    def restart(st, i):
        """Restart(i) — raft.tla:136-143."""
        one_row = torch.ones_like(st.next_idx[:, :1, :])
        new = st._replace(
            role=_set1(st.role, i, FOLLOWER),
            votes_resp=_set1(st.votes_resp, i, 0),
            votes_gran=_set1(st.votes_gran, i, 0),
            next_idx=_setrow(st.next_idx, i, one_row),
            match_idx=_setrow(st.match_idx, i, torch.zeros_like(one_row)),
            commit=_set1(st.commit, i, 0))
        return yes(i), no(i), new

    def timeout(st, i):
        """Timeout(i) — raft.tla:146-154 (no self-vote)."""
        role_i = _t1(st.role, i)
        en = (role_i == FOLLOWER) | (role_i == CANDIDATE)
        new = st._replace(
            role=_set1(st.role, i, CANDIDATE),
            term=_add1(st.term, i, 1),
            voted_for=_set1(st.voted_for, i, NIL),
            votes_resp=_set1(st.votes_resp, i, 0),
            votes_gran=_set1(st.votes_gran, i, 0))
        return en, no(i), new

    def request_vote(st, i, j):
        """RequestVote(i, j) — raft.tla:157-166 (i = j allowed)."""
        en = ((_t1(st.role, i) == CANDIDATE)
              & (((_t1(st.votes_resp, i) >> j) & 1) == 0))
        cols = base_cols(RVQ, i, j, _t1(st.term, i))
        cols[4] = last_term(st, i)
        cols[5] = _t1(st.log_len, i)
        new, ok = bag_send(st, mrow(cols, i))
        return en & ok, en & ~ok, new

    def append_entries(st, i, j):
        """AppendEntries(i, j) — raft.tla:171-192 (<= 1 entry)."""
        en = (i != j) & (_t1(st.role, i) == LEADER)
        ln = _t1(st.log_len, i)
        ni = _t2(st.next_idx, i, j)
        prev = ni - 1
        prev_term = torch.where(
            (prev > 0) & (prev <= ln),
            _t2(st.log_term, i, (prev - 1).clamp(0, L - 1)), 0)
        last_entry = torch.minimum(ln, ni)                     # :182
        n_ent = (ln >= ni).to(ln.dtype)                        # :183
        k = (ni - 1).clamp(0, L - 1)
        cols = base_cols(AEQ, i, j, _t1(st.term, i))
        cols[4] = prev
        cols[5] = prev_term
        cols[6] = n_ent
        cols[7] = torch.where(n_ent > 0, _t2(st.log_term, i, k), 0)
        cols[8] = torch.where(n_ent > 0, _t2(st.log_val, i, k), 0)
        cols[9] = torch.minimum(_t1(st.commit, i), last_entry)  # :189
        new, ok = bag_send(st, mrow(cols, i))
        return en & ok, en & ~ok, new

    def become_leader(st, i):
        """BecomeLeader(i) — raft.tla:195-203, the quorum through
        ``dims.build_quorum``."""
        member = ((_t1(st.votes_gran, i).unsqueeze(-1) >> ar_n) & 1) > 0
        en = (_t1(st.role, i) == CANDIDATE) & quorum(st, i, member)
        ln = _t1(st.log_len, i)
        row = (ln + 1).unsqueeze(-1).expand(-1, -1, N)
        new = st._replace(
            role=_set1(st.role, i, LEADER),
            next_idx=_setrow(st.next_idx, i, row),
            match_idx=_setrow(st.match_idx, i, torch.zeros_like(row)))
        return en, no(i), new

    def client_request(st, i, v):
        """ClientRequest(i, v) — raft.tla:206-213."""
        ln = _t1(st.log_len, i)
        is_leader = _t1(st.role, i) == LEADER
        fits = ln < L
        k = ln.clamp(0, L - 1)
        new = st._replace(
            log_term=_set2(st.log_term, i, k, _t1(st.term, i)),
            log_val=_set2(st.log_val, i, k, v),
            log_len=_add1(st.log_len, i, 1))
        return is_leader & fits, is_leader & ~fits, new

    def advance_commit(st, i):
        """AdvanceCommitIndex(i) — raft.tla:219-236 with the own-term rule
        (:229-230)."""
        en = _t1(st.role, i) == LEADER
        mi_row = _row(st.match_idx, i)                         # [X, 1, N]
        # Agree(index) == {i} \cup {k : matchIndex[i][k] >= index} :222-223
        member = ((mi_row.unsqueeze(2) >= idxs[None, None, :, None])
                  | (ar_n[None, None, None, :] == i[..., None, None]))
        ok = (quorum(st, i, member)
              & (idxs[None, None, :] <= _t1(st.log_len, i).unsqueeze(-1)))
        any_ok = ok.any(-1)
        max_agree = torch.where(ok, idxs, 0).max(-1).values      # Max :232
        own_term = (_t2(st.log_term, i, (max_agree - 1).clamp(0, L - 1))
                    == _t1(st.term, i))
        new_commit = torch.where(any_ok & own_term, max_agree,
                                 _t1(st.commit, i))
        return en, no(i), st._replace(commit=_set1(st.commit, i, new_commit))

    # -- Receive(m) (raft.tla:388-403) ------------------------------------
    def receive(st, s):
        """Receive of slot s's message: a select cascade over the pairwise
        exclusive disjuncts; at most one fires."""
        mvec = _row(st.msg, s).squeeze(1)                      # [X, W]

        def col(c):
            return mvec[:, c:c + 1]

        occ = _t1(st.msg_cnt, s) > 0
        mtype = col(0) - 1
        # i = mdest, j = msource (raft.tla:389-390), clamped so the reads
        # stay in range on a free row; every use is gated on occupancy.
        j = (col(1) - 1).clamp(0, N - 1)
        i = (col(2) - 1).clamp(0, N - 1)
        mterm = col(3)
        t_i = _t1(st.term, i)
        role_i = _t1(st.role, i)
        ln = _t1(st.log_len, i)

        # UpdateTerm — raft.tla:373-379; the message stays in flight.
        en_ut = occ & (mterm > t_i)
        st_ut = st._replace(term=_set1(st.term, i, mterm),
                            role=_set1(st.role, i, FOLLOWER),
                            voted_for=_set1(st.voted_for, i, NIL))
        le = occ & (mterm <= t_i)

        # HandleRequestVoteRequest — raft.tla:244-263.
        lt = last_term(st, i)
        rvq_logok = (col(4) > lt) | ((col(4) == lt) & (col(5) >= ln))
        vf_i = _t1(st.voted_for, i)
        grant = ((mterm == t_i) & rvq_logok
                 & ((vf_i == NIL) | (vf_i == j + 1)))
        cols = base_cols(RVR, i, j, t_i)
        cols[4] = grant.to(mterm.dtype)
        cols[5] = ln
        lrow_t = _row(st.log_term, i).squeeze(1)
        lrow_v = _row(st.log_val, i).squeeze(1)
        for k in range(L):                  # mlog: the full log :257-259
            cols[6 + k] = lrow_t[:, k:k + 1]
            cols[6 + L + k] = lrow_v[:, k:k + 1]
        rvr_resp = mrow(cols, mterm)
        st_rvq = st._replace(voted_for=_w(
            grant, _set1(st.voted_for, i, j + 1), st.voted_for))
        st_rvq, rvq_ok = reply_slot(st_rvq, rvr_resp, s)
        en_rvq = le & (mtype == RVQ)

        # RequestVoteResponse: DropStaleResponse :382-385 / Handle :267-279.
        en_rvr_drop = le & (mtype == RVR) & (mterm < t_i)
        en_rvr = le & (mtype == RVR) & (mterm == t_i)
        st_rvr = bag_discard_slot(st._replace(
            votes_resp=_set1(st.votes_resp, i,
                             _t1(st.votes_resp, i) | (1 << j)),
            votes_gran=_set1(st.votes_gran, i,
                             _t1(st.votes_gran, i)
                             | (torch.where(col(4) > 0, 1, 0) << j))), s)

        # AppendEntriesRequest — raft.tla:347-356.
        prev, pterm, n_ent = col(4), col(5), col(6)
        eterm, eval_, mcommit = col(7), col(8), col(9)
        aeq_logok = (prev == 0) | (
            (prev > 0) & (prev <= ln)
            & (pterm == _t2(st.log_term, i, (prev - 1).clamp(0, L - 1))))
        en_aeq = le & (mtype == AEQ)
        # Reject — :281-293.
        en_rej = en_aeq & ((mterm < t_i)
                           | ((mterm == t_i) & (role_i == FOLLOWER)
                              & ~aeq_logok))
        st_rej, rej_ok = reply_slot(st, mrow(base_cols(AER, i, j, t_i),
                                             mterm), s)
        # ReturnToFollowerState — :295-299 (the message stays).
        en_rtf = en_aeq & (mterm == t_i) & (role_i == CANDIDATE)
        st_rtf = st._replace(role=_set1(st.role, i, FOLLOWER))
        # Accept — :333-341, index == mprevLogIndex + 1.
        acc = en_aeq & (mterm == t_i) & (role_i == FOLLOWER) & aeq_logok
        index = prev + 1
        have_at = ln >= index
        term_at = _t2(st.log_term, i, (index - 1).clamp(0, L - 1))
        done_shape = (n_ent == 0) | (have_at & (term_at == eterm))
        # AlreadyDone — :301-317 with the :317 hidden guard.
        en_done = acc & done_shape & (mcommit == _t1(st.commit, i))
        cols = base_cols(AER, i, j, t_i)
        cols[4] = torch.ones_like(mterm)
        cols[5] = prev + n_ent                                 # :313
        st_done, done_ok = reply_slot(st, mrow(cols, mterm), s)
        # Conflict — :319-325: one trailing entry dropped, no reply.
        en_conf = acc & (n_ent > 0) & have_at & (term_at != eterm)
        k_last = (ln - 1).clamp(0, L - 1)
        zero = torch.zeros_like(ln)
        st_conf = st._replace(
            log_term=_set2(st.log_term, i, k_last, zero),
            log_val=_set2(st.log_val, i, k_last, zero),
            log_len=_add1(st.log_len, i, -1))
        # NoConflict — :327-331: mentries[1] appended.
        fits = ln < L
        en_noc = acc & (n_ent > 0) & (ln == prev)
        k_app = ln.clamp(0, L - 1)
        st_noc = st._replace(
            log_term=_set2(st.log_term, i, k_app, eterm),
            log_val=_set2(st.log_val, i, k_app, eval_),
            log_len=_add1(st.log_len, i, 1))

        # AppendEntriesResponse: DropStale :402 / Handle :360-370.
        en_aer_drop = le & (mtype == AER) & (mterm < t_i)
        en_aer = le & (mtype == AER) & (mterm == t_i)
        succ, mmatch = col(4) > 0, col(5)
        st_aer = bag_discard_slot(st._replace(
            next_idx=_set2(st.next_idx, i, j, torch.where(
                succ, mmatch + 1,
                torch.clamp(_t2(st.next_idx, i, j) - 1, min=1))),
            match_idx=_set2(st.match_idx, i, j, torch.where(
                succ, mmatch, _t2(st.match_idx, i, j)))), s)

        st_drop = bag_discard_slot(st, s)

        overflow = ((en_rvq & ~rvq_ok) | (en_rej & ~rej_ok)
                    | (en_done & ~done_ok) | (en_noc & ~fits))
        enabled = (en_ut | en_rvq | en_rvr_drop | en_rvr | en_rej | en_rtf
                   | en_done | en_conf | en_noc | en_aer_drop
                   | en_aer) & ~overflow
        out = st
        for cond, branch in (
                (en_ut, st_ut), (en_rvq, st_rvq),
                (en_rvr_drop | en_aer_drop, st_drop),
                (en_rvr, st_rvr), (en_rej, st_rej), (en_rtf, st_rtf),
                (en_done, st_done), (en_conf, st_conf), (en_noc, st_noc),
                (en_aer, st_aer)):
            out = _sel(cond, branch, out)
        return enabled, overflow, out

    def duplicate(st, s):
        """DuplicateMessage — raft.tla:410-412 (the count +1)."""
        occ = _t1(st.msg_cnt, s) > 0
        return occ, no(s), st._replace(
            msg_cnt=_add1(st.msg_cnt, s, torch.where(occ, 1, 0)))

    def drop(st, s):
        """DropMessage — raft.tla:415-417 (the count -1)."""
        occ = _t1(st.msg_cnt, s) > 0
        return occ, no(s), bag_discard_slot(st, s)

    # -- the grid (Next — raft.tla:421-430) --------------------------------
    servers = torch.arange(N, device=device)
    ii = servers.repeat_interleave(N)
    jj = servers.repeat(N)
    ci = servers.repeat_interleave(V)
    cv = torch.arange(1, V + 1, device=device).repeat(N)
    slots = torch.arange(M, device=device)
    kernels = [
        ("Restart", restart, (servers,)),
        ("Timeout", timeout, (servers,)),
        ("RequestVote", request_vote, (ii, jj)),
        ("BecomeLeader", become_leader, (servers,)),
        ("ClientRequest", client_request, (ci, cv)),
        ("AdvanceCommitIndex", advance_commit, (servers,)),
        ("AppendEntries", append_entries, (ii, jj)),
        ("Receive", receive, (slots,)),
        ("DuplicateMessage", duplicate, (slots,)),
        ("DropMessage", drop, (slots,)),
    ]
    for (params, kern), (name, _sz) in zip(dims.build_extra_kernels(device),
                                           dims.extra_families):
        kernels.append((name, kern, tuple(params)))
    return kernels


def build_expand(dims: RaftDims, device, lane_cap: int = LANE_CAP):
    """``expand(st) -> (cands, en, ovf)`` for a ``StateBatch`` of B
    parents: ``cands`` the ``Candidates`` of every instance of every
    parent, ``en`` and ``ovf`` ``[B, G]`` bool in ``dims.family_offsets``
    order (the kernels' guards, without the pack guard)."""
    kernels = build_kernels(dims, device)
    G, sw = dims.n_instances, state_width(dims)
    offsets = dims.family_offsets

    def expand(st: StateBatch):
        X = st.term.shape[0]
        dev = st.term.device
        en = torch.empty((X, G), dtype=torch.bool, device=dev)
        ovf = torch.empty_like(en)
        pk = torch.empty_like(en)
        rows = torch.empty((X * G, sw), dtype=torch.uint8, device=dev)
        rows3 = rows.view(X, G, sw)
        for f, (_name, kern, params) in enumerate(kernels):
            R, off = int(params[0].shape[0]), offsets[f]
            step = max(1, lane_cap // R)
            for x0 in range(0, X, step):
                xs = min(step, X - x0)
                part = StateBatch(*(a.narrow(0, x0, xs) for a in st))
                rep = gather_states(part, torch.arange(
                    xs, device=dev).repeat_interleave(R))
                p = [t.repeat(xs).unsqueeze(1) for t in params]
                e, o, succ = kern(rep, *p)
                en[x0:x0 + xs, off:off + R] = e.view(xs, R)
                ovf[x0:x0 + xs, off:off + R] = o.view(xs, R)
                pk[x0:x0 + xs, off:off + R] = pack_ok(succ, dims).view(xs, R)
                rows3[x0:x0 + xs, off:off + R] = flatten_state(
                    succ, dims).view(xs, R, sw)
        return Candidates(rows=rows, pack_ok=pk), en, ovf

    return expand
