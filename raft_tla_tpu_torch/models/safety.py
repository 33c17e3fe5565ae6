"""The spec's correctness-invariant suite (raft.tla:896-1180) as batched
predicates, with pure-Python mirrors.

Each builder returns a predicate ``StateBatch [X] -> [X] bool`` (True where
the invariant holds), in the idiom of ``models/invariants.py``
``build_type_ok``, tagged with its registry name as ``.predicate``; the v4
front kernel has device code for each (``csrc/raft_model.cuh``).  This is
the JAX package's ``models/safety.py`` with the batch axis written out.
Its readings of the spec, kept here:

- ``Committed(i) == SubSeq(log[i], 1, commitIndex[i])`` (raft.tla:896);
  with ``commitIndex[i] > Len(log[i])`` it is undefined and is a prefix of
  nothing (the TLC-error reading).
- ``RequestVoteResponseInv`` (:903-910) reads ``m.mdest`` where the spec's
  :910 has the typo ``m.dest``.
- ``AppendEntriesRequestInv`` (:924-930): the first conjunct
  (``log[src][prev+1] = mentries[1]``) is unguarded, so an index out of
  the log's domain is a violation; the second is guarded by
  ``prev > 0 /\\ prev <= Len``.
- ``MessagesInv`` (:941-946) conjoins the four per-message invariants over
  every in-flight message.
- ``ElectionSafety`` (:1124-1129): ``Max`` of an empty index set is 0.
- ``LogMatching`` (:1132-1136) compares whole records, term and value.
- ``VotesGrantedInv`` (:1145-1153) uses SequencesExt's ``IsPrefix``.
- ``QuorumLogInv`` (:1157-1161): every quorum holds a good server iff the
  bad ones are no majority, ``2 * |bad| <= N``.

Indices into a server or a log lane clamp as the JAX package's gathers
do: a message's ``src``/``dst`` and the entry positions ``prev`` and
``prev - 1`` may lie outside their range in unstructured states.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from .dims import AEQ, CANDIDATE, LEADER, NIL, RVQ, RVR, RaftDims
from .pystate import PyState
from .schema import StateBatch

# -- helpers on a batch ------------------------------------------------------


def _last_terms(st: StateBatch, L: int) -> torch.Tensor:
    """LastTerm(log[i]) for every server (raft.tla:84).  [X, N]."""
    at = (st.log_len - 1).clamp(0, L - 1)
    last = st.log_term.gather(2, at[:, :, None]).squeeze(2)
    return torch.where(st.log_len > 0, last, torch.zeros_like(last))


def _entry_eq(st: StateBatch) -> torch.Tensor:
    """E[x, a, b, l]: log[a][l+1] and log[b][l+1] are the same record.
    [X, N, N, L]."""
    te = st.log_term[:, :, None, :] == st.log_term[:, None, :, :]
    ve = st.log_val[:, :, None, :] == st.log_val[:, None, :, :]
    return te & ve


def _committed_prefix(st: StateBatch, L: int) -> torch.Tensor:
    """P[x, a, b] = IsPrefix(Committed(a), log[b]).  [X, N, N]."""
    lane = torch.arange(L, device=st.term.device)
    within = lane[None, None, None, :] < st.commit[:, :, None, None]
    match = (~within | _entry_eq(st)).all(3)
    well_def = st.commit <= st.log_len
    return (well_def[:, :, None]
            & (st.commit[:, :, None] <= st.log_len[:, None, :]) & match)


def _log_gather(log: torch.Tensor, srv: torch.Tensor,
                at: torch.Tensor) -> torch.Tensor:
    """``log[b, srv[b, m], at[b, m]]`` for a log field [X, N, L]."""
    X, N, L = log.shape
    return log.reshape(X, N * L).gather(1, srv * L + at)


# -- the nine predicates -----------------------------------------------------


def build_messages_inv(dims: RaftDims):
    """MessagesInv (raft.tla:941-946): MessageTermsLtCurrentTerm,
    RequestVoteResponseInv, RequestVoteRequestInv and
    AppendEntriesRequestInv on every in-flight message."""
    N, L = dims.n_servers, dims.max_log

    def messages_inv(st: StateBatch):
        msg = st.msg
        occ = st.msg_cnt > 0                                    # [X, M]
        mt = msg[:, :, 0] - 1
        src = (msg[:, :, 1] - 1).clamp(0, N - 1)
        dst = (msg[:, :, 2] - 1).clamp(0, N - 1)
        mterm = msg[:, :, 3]
        lt = _last_terms(st, L)
        len_src = st.log_len.gather(1, src)
        len_dst = st.log_len.gather(1, dst)
        lt_src, lt_dst = lt.gather(1, src), lt.gather(1, dst)
        t_src = st.term.gather(1, src)
        t_dst = st.term.gather(1, dst)

        terms_ok = mterm <= t_src                               # :934-935

        rvr_ante = ((mt == RVR) & (msg[:, :, 4] > 0) & (t_src == t_dst)
                    & (t_src == mterm))                         # :903-910
        rvr_cons = (lt_dst > lt_src) | ((lt_dst == lt_src)
                                        & (len_dst >= len_src))
        rvr_ok = ~rvr_ante | rvr_cons

        rvq_ante = ((mt == RVQ)
                    & (st.role.gather(1, src) == CANDIDATE)
                    & (t_src == mterm))                         # :915-920
        rvq_cons = (msg[:, :, 5] == len_src) & (msg[:, :, 4] == lt_src)
        rvq_ok = ~rvq_ante | rvq_cons

        prev, pterm = msg[:, :, 4], msg[:, :, 5]                # :924-930
        n_ent, eterm, evalue = msg[:, :, 6], msg[:, :, 7], msg[:, :, 8]
        aeq_ante = (mt == AEQ) & (n_ent > 0) & (mterm == t_src)
        at1 = prev.clamp(0, L - 1)                  # prev + 1, 0-based
        entry1_ok = ((prev + 1 >= 1) & (prev + 1 <= len_src)
                     & (_log_gather(st.log_term, src, at1) == eterm)
                     & (_log_gather(st.log_val, src, at1) == evalue))
        atp = (prev - 1).clamp(0, L - 1)
        prev_in = (prev > 0) & (prev <= len_src)
        pterm_ok = ~prev_in | (_log_gather(st.log_term, src, atp) == pterm)
        aeq_ok = ~aeq_ante | (entry1_ok & pterm_ok)

        return (~occ | (terms_ok & rvr_ok & rvq_ok & aeq_ok)).all(1)

    messages_inv.predicate = "MessagesInv"
    return messages_inv


def build_leader_votes_quorum(dims: RaftDims):
    """LeaderVotesQuorum (raft.tla:1033-1037)."""
    N = dims.n_servers

    def leader_votes_quorum(st: StateBatch):
        me = torch.arange(N, device=st.term.device)
        # voters[x, i, j]: j counts toward i's leadership quorum.
        higher = st.term[:, None, :] > st.term[:, :, None]
        voted = ((st.term[:, None, :] == st.term[:, :, None])
                 & (st.voted_for[:, None, :] == me[None, :, None] + 1))
        cnt = (higher | voted).sum(2)
        return ((st.role != LEADER) | (2 * cnt > N)).all(1)

    leader_votes_quorum.predicate = "LeaderVotesQuorum"
    return leader_votes_quorum


def build_candidate_term_not_in_log(dims: RaftDims):
    """CandidateTermNotInLog (raft.tla:1041-1047)."""
    N, L = dims.n_servers, dims.max_log

    def candidate_term_not_in_log(st: StateBatch):
        dev = st.term.device
        me = torch.arange(N, device=dev)
        same_term = st.term[:, None, :] == st.term[:, :, None]  # [X, i, j]
        votable = ((st.voted_for[:, None, :] == me[None, :, None] + 1)
                   | (st.voted_for[:, None, :] == NIL))
        cnt = (same_term & votable).sum(2)
        electable = (st.role == CANDIDATE) & (2 * cnt > N)      # [X, i]
        lane = torch.arange(L, device=dev)
        in_log = lane[None, None, :] < st.log_len[:, :, None]   # [X, j, L]
        term_hit = (st.log_term[:, None, :, :]
                    == st.term[:, :, None, None])               # [X, i, j, L]
        in_any_log = (in_log[:, None] & term_hit).flatten(2).any(2)
        return (~electable | ~in_any_log).all(1)

    candidate_term_not_in_log.predicate = "CandidateTermNotInLog"
    return candidate_term_not_in_log


def build_election_safety(dims: RaftDims):
    """ElectionSafety (raft.tla:1124-1129), an empty Max taken as 0."""
    L = dims.max_log

    def election_safety(st: StateBatch):
        lane = torch.arange(L, device=st.term.device)
        in_log = lane[None, None, :] < st.log_len[:, :, None]   # [X, j, L]
        hit = in_log[:, None] & (st.log_term[:, None, :, :]
                                 == st.term[:, :, None, None])
        # A[x, i, j]: the greatest index in log[j] with term currentTerm[i].
        A = torch.where(hit, lane + 1, torch.zeros_like(lane)).amax(3)
        own = A.diagonal(dim1=1, dim2=2)                        # A[x, i, i]
        return ((st.role != LEADER)[:, :, None]
                | (own[:, :, None] >= A)).flatten(1).all(1)

    election_safety.predicate = "ElectionSafety"
    return election_safety


def build_log_matching(dims: RaftDims):
    """LogMatching (raft.tla:1132-1136)."""
    L = dims.max_log

    def log_matching(st: StateBatch):
        lane = torch.arange(L, device=st.term.device)
        eq = _entry_eq(st)                                      # [X, i, j, L]
        # prefix_eq[x, i, j, l]: SubSeq(log[i],1,l+1) = SubSeq(log[j],1,l+1).
        prefix_eq = eq.to(torch.int8).cumprod(3).bool()
        in_both = lane < torch.minimum(st.log_len[:, :, None],
                                       st.log_len[:, None, :])[..., None]
        term_eq = st.log_term[:, :, None, :] == st.log_term[:, None, :, :]
        return (~in_both | ~term_eq | prefix_eq).flatten(1).all(1)

    log_matching.predicate = "LogMatching"
    return log_matching


def build_votes_granted_inv(dims: RaftDims):
    """VotesGrantedInv (raft.tla:1145-1153)."""
    N, L = dims.n_servers, dims.max_log

    def votes_granted_inv(st: StateBatch):
        j = torch.arange(N, device=st.term.device)
        granted = ((st.votes_gran[:, :, None] >> j) & 1) > 0    # [X, i, j]
        same_term = st.term[:, :, None] == st.term[:, None, :]
        # IsPrefix(Committed(j), log[i]): P[j, i].
        pref = _committed_prefix(st, L).transpose(1, 2)         # [X, i, j]
        return (~granted | ~same_term | pref).flatten(1).all(1)

    votes_granted_inv.predicate = "VotesGrantedInv"
    return votes_granted_inv


def build_quorum_log_inv(dims: RaftDims):
    """QuorumLogInv (raft.tla:1157-1161), as a popcount."""
    N, L = dims.n_servers, dims.max_log

    def quorum_log_inv(st: StateBatch):
        bad = (~_committed_prefix(st, L)).sum(2)                # [X, i]
        return (2 * bad <= N).all(1)

    quorum_log_inv.predicate = "QuorumLogInv"
    return quorum_log_inv


def build_more_up_to_date_correct(dims: RaftDims):
    """MoreUpToDateCorrect (raft.tla:1167-1172)."""
    L = dims.max_log

    def more_up_to_date_correct(st: StateBatch):
        lt = _last_terms(st, L)
        newer = ((lt[:, :, None] > lt[:, None, :])
                 | ((lt[:, :, None] == lt[:, None, :])
                    & (st.log_len[:, :, None] >= st.log_len[:, None, :])))
        pref = _committed_prefix(st, L).transpose(1, 2)         # [X, i, j]
        return (~newer | pref).flatten(1).all(1)

    more_up_to_date_correct.predicate = "MoreUpToDateCorrect"
    return more_up_to_date_correct


def build_leader_completeness(dims: RaftDims):
    """LeaderCompleteness (raft.tla:1176-1180)."""
    L = dims.max_log

    def leader_completeness(st: StateBatch):
        pref = _committed_prefix(st, L).transpose(1, 2)         # [X, i, j]
        return (~(st.role == LEADER)[:, :, None] | pref).flatten(1).all(1)

    leader_completeness.predicate = "LeaderCompleteness"
    return leader_completeness


#: Name -> builder, in the spec's order of definition.
SAFETY_INVARIANTS: Dict[str, Callable] = {
    "MessagesInv": build_messages_inv,
    "LeaderVotesQuorum": build_leader_votes_quorum,
    "CandidateTermNotInLog": build_candidate_term_not_in_log,
    "ElectionSafety": build_election_safety,
    "LogMatching": build_log_matching,
    "VotesGrantedInv": build_votes_granted_inv,
    "QuorumLogInv": build_quorum_log_inv,
    "MoreUpToDateCorrect": build_more_up_to_date_correct,
    "LeaderCompleteness": build_leader_completeness,
}


# -- pure-Python mirrors on one PyState --------------------------------------


def _py_last_term(log):
    return log[-1][0] if log else 0


def _py_committed(s: PyState, a: int):
    """Committed(a); None where commitIndex > Len leaves it undefined."""
    if s.commit_index[a] > len(s.log[a]):
        return None
    return s.log[a][:s.commit_index[a]]


def _py_is_prefix_committed(s: PyState, a: int, b: int) -> bool:
    c = _py_committed(s, a)
    return c is not None and s.log[b][:len(c)] == c


def messages_inv_py(s: PyState, dims: RaftDims) -> bool:
    for (m, _cnt) in s.messages:
        mt, src, dst, mterm = m[0], m[1], m[2], m[3]
        if mterm > s.current_term[src]:                 # :934-935
            return False
        if mt == RVR and m[4] \
                and s.current_term[src] == s.current_term[dst] \
                and s.current_term[src] == mterm:       # :903-910
            lts, ltd = _py_last_term(s.log[src]), _py_last_term(s.log[dst])
            if not (ltd > lts or (ltd == lts
                                  and len(s.log[dst]) >= len(s.log[src]))):
                return False
        if mt == RVQ and s.role[src] == CANDIDATE \
                and s.current_term[src] == mterm:       # :915-920
            if m[5] != len(s.log[src]) or m[4] != _py_last_term(s.log[src]):
                return False
        if mt == AEQ and m[6] and mterm == s.current_term[src]:  # :924-930
            prev, pterm, entries = m[4], m[5], m[6]
            if not (1 <= prev + 1 <= len(s.log[src])
                    and s.log[src][prev] == entries[0]):
                return False
            if 0 < prev <= len(s.log[src]) \
                    and s.log[src][prev - 1][0] != pterm:
                return False
    return True


def leader_votes_quorum_py(s: PyState, dims: RaftDims) -> bool:
    n = dims.n_servers
    for i in range(n):
        if s.role[i] != LEADER:
            continue
        cnt = sum(
            1 for j in range(n)
            if s.current_term[j] > s.current_term[i]
            or (s.current_term[j] == s.current_term[i]
                and s.voted_for[j] == i + 1))
        if not 2 * cnt > n:
            return False
    return True


def candidate_term_not_in_log_py(s: PyState, dims: RaftDims) -> bool:
    n = dims.n_servers
    for i in range(n):
        if s.role[i] != CANDIDATE:
            continue
        cnt = sum(
            1 for j in range(n)
            if s.current_term[j] == s.current_term[i]
            and s.voted_for[j] in (i + 1, NIL))
        if 2 * cnt > n:
            for j in range(n):
                if any(t == s.current_term[i] for (t, _v) in s.log[j]):
                    return False
    return True


def election_safety_py(s: PyState, dims: RaftDims) -> bool:
    n = dims.n_servers

    def max_idx(j, t):
        hits = [k + 1 for k, (et, _v) in enumerate(s.log[j]) if et == t]
        return max(hits) if hits else 0

    for i in range(n):
        if s.role[i] != LEADER:
            continue
        for j in range(n):
            if max_idx(i, s.current_term[i]) < max_idx(j, s.current_term[i]):
                return False
    return True


def log_matching_py(s: PyState, dims: RaftDims) -> bool:
    n = dims.n_servers
    for i in range(n):
        for j in range(n):
            for k in range(min(len(s.log[i]), len(s.log[j]))):
                if s.log[i][k][0] == s.log[j][k][0] \
                        and s.log[i][:k + 1] != s.log[j][:k + 1]:
                    return False
    return True


def votes_granted_inv_py(s: PyState, dims: RaftDims) -> bool:
    n = dims.n_servers
    for i in range(n):
        for j in range(n):
            if (s.votes_granted[i] >> j) & 1 \
                    and s.current_term[i] == s.current_term[j] \
                    and not _py_is_prefix_committed(s, j, i):
                return False
    return True


def quorum_log_inv_py(s: PyState, dims: RaftDims) -> bool:
    n = dims.n_servers
    for i in range(n):
        bad = sum(1 for j in range(n)
                  if not _py_is_prefix_committed(s, i, j))
        if 2 * bad > n:
            return False
    return True


def more_up_to_date_correct_py(s: PyState, dims: RaftDims) -> bool:
    n = dims.n_servers
    for i in range(n):
        for j in range(n):
            lti, ltj = _py_last_term(s.log[i]), _py_last_term(s.log[j])
            if (lti > ltj or (lti == ltj
                              and len(s.log[i]) >= len(s.log[j]))) \
                    and not _py_is_prefix_committed(s, j, i):
                return False
    return True


def leader_completeness_py(s: PyState, dims: RaftDims) -> bool:
    n = dims.n_servers
    for i in range(n):
        if s.role[i] == LEADER:
            for j in range(n):
                if not _py_is_prefix_committed(s, j, i):
                    return False
    return True


SAFETY_INVARIANTS_PY: Dict[str, Callable] = {
    "MessagesInv": messages_inv_py,
    "LeaderVotesQuorum": leader_votes_quorum_py,
    "CandidateTermNotInLog": candidate_term_not_in_log_py,
    "ElectionSafety": election_safety_py,
    "LogMatching": log_matching_py,
    "VotesGrantedInv": votes_granted_inv_py,
    "QuorumLogInv": quorum_log_inv_py,
    "MoreUpToDateCorrect": more_up_to_date_correct_py,
    "LeaderCompleteness": leader_completeness_py,
}
