"""The plain reference of raft.tla's safety suite: TypeOK and the nine
predicates over ``oracle.PyState``, and TLC's search with them.

``raft.tla`` keeps its correctness invariants after the module's end
(:896-1180), where TLC never evaluates them; ``MCraft_safety.cfg`` checks
all ten.  Each predicate below is written from the spec's definition,
quoted in its docstring, over the oracle's state (servers and values are
0-based, ``voted_for`` is 0 for Nil and j + 1 for server j, vote sets
are bitmasks, messages are flat tuples, the bag a frozenset of (message,
count)).  Where the spec leaves a value undefined, or a definition needs
a reading, the reading is written out beside the predicate it governs:

- ``Committed(i) == SubSeq(log[i], 1, commitIndex[i])`` (:896) is
  undefined when ``commitIndex[i] > Len(log[i])``; TLC would stop with an
  error there, so it is read as a prefix of nothing: ``IsPrefix`` with
  it is FALSE (``_is_prefix_committed``).
- ``RequestVoteResponseInv`` (:903-910) reads ``m.dest`` at :910, a typo
  for ``m.mdest`` (TLC would stop on the missing field); it is read as
  ``m.mdest``.
- ``AppendEntriesRequestInv`` (:924-930): its first conjunct,
  ``log[m.msource][m.mprevLogIndex + 1] = m.mentries[1]``, is unguarded,
  so an index outside the log's domain is the TLC error and reads as a
  violation; the second is guarded by ``mprevLogIndex > 0 /\\
  mprevLogIndex <= Len``.
- ``ElectionSafety`` (:1124-1129): ``Max`` (:106-108) of an empty index
  set is 0.
- ``QuorumLogInv`` (:1157-1161) quantifies over every quorum (``Quorum``,
  :81, the subsets of more than half the servers); searching them all is
  the same as asking that the servers whose log lacks the committed
  prefix be no majority, ``2 * |bad| <= N``.  Both are written out and
  must agree (``quorum_log_inv``).

``IsPrefix(s, t) == Len(s) <= Len(t) /\\ SubSeq(t, 1, Len(s)) = s`` is
SequencesExt's (community modules).  This module imports nothing but the
oracle.  Run as a script it freezes a configuration's profile, levels 0
to ``--depth`` of ``bfs_suite`` with the configuration's ``invariants``
(on the host alone; MCraft to depth 11 holds ~6M states in memory):

    python3 portbench/reference/suite.py --config mcraft_safety \
        --depth 11 --out portbench/reference/profiles/mcraft_safety.json
"""

from __future__ import annotations

import argparse
import datetime
import itertools
import json
import os
import sys
import time
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Sequence

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    __package__ = "portbench.reference"

from .oracle import (AEQ, CANDIDATE, FAMILY_NAMES, LEADER, NIL,  # noqa: E402
                     RVQ, RVR, Answer, Dims, PyState, bounded_space,
                     init_state, last_term, successors, type_ok)


# -- the spec's operators ---------------------------------------------------

def _committed(s: PyState, i: int):
    """Committed(i) (:896), None where it is undefined."""
    if s.commit_index[i] > len(s.log[i]):
        return None
    return s.log[i][:s.commit_index[i]]


def _is_prefix_committed(s: PyState, i: int, j: int) -> bool:
    """IsPrefix(Committed(i), log[j]); FALSE where Committed(i) is
    undefined."""
    c = _committed(s, i)
    return (c is not None and len(c) <= len(s.log[j])
            and s.log[j][:len(c)] == c)


@lru_cache(maxsize=None)
def _quorums(n: int):
    """Quorum (:81): every set of servers, a tuple of indices, of more
    than half of the n."""
    return tuple(q for k in range(n + 1) if 2 * k > n
                 for q in itertools.combinations(range(n), k))


def _max_index(log, term: int) -> int:
    """Max({n \\in DOMAIN log : log[n].term = term}), 0 for the empty
    set."""
    hits = [n for n in range(1, len(log) + 1) if log[n - 1][0] == term]
    return max(hits) if hits else 0


def _up_to_date(s: PyState, i: int, j: int) -> bool:
    """log[i] at least as up to date as log[j]: a later last term, or the
    same and at least as long."""
    ti, tj = last_term(s.log[i]), last_term(s.log[j])
    return ti > tj or (ti == tj and len(s.log[i]) >= len(s.log[j]))


# -- the per-message invariants (MessagesInv's conjuncts) -------------------

def _request_vote_response_ok(s: PyState, m) -> bool:
    """RequestVoteResponseInv (:903-910), for one message:
    m.mtype = RequestVoteResponse /\\ m.mvoteGranted
    /\\ currentTerm[m.msource] = currentTerm[m.mdest]
    /\\ currentTerm[m.msource] = m.mterm
    => log[m.mdest] is at least as up to date as log[m.msource].
    :910 writes ``m.dest``; read as ``m.mdest``."""
    if m[0] != RVR or not m[4]:
        return True
    src, dst, mterm = m[1], m[2], m[3]
    if not (s.current_term[src] == s.current_term[dst] == mterm):
        return True
    return _up_to_date(s, dst, src)


def _request_vote_request_ok(s: PyState, m) -> bool:
    """RequestVoteRequestInv (:915-920), for one message:
    m.mtype = RequestVoteRequest /\\ state[m.msource] = Candidate
    /\\ currentTerm[m.msource] = m.mterm
    => m.mlastLogIndex = Len(log[m.msource])
       /\\ m.mlastLogTerm = LastTerm(log[m.msource])."""
    if m[0] != RVQ:
        return True
    src, mterm = m[1], m[3]
    if s.role[src] != CANDIDATE or s.current_term[src] != mterm:
        return True
    return m[5] == len(s.log[src]) and m[4] == last_term(s.log[src])


def _append_entries_request_ok(s: PyState, m) -> bool:
    """AppendEntriesRequestInv (:924-930), for one message:
    m.mtype = AppendEntriesRequest /\\ m.mentries /= << >>
    /\\ m.mterm = currentTerm[m.msource]
    => /\\ log[m.msource][m.mprevLogIndex + 1] = m.mentries[1]
       /\\ m.mprevLogIndex > 0 /\\ m.mprevLogIndex <= Len(log[m.msource])
          => log[m.msource][m.mprevLogIndex].term = m.mprevLogTerm.
    The first conjunct is unguarded: an index outside DOMAIN
    log[m.msource] is the TLC error, read as a violation."""
    if m[0] != AEQ or not m[6]:
        return True
    src, mterm, prev, prev_term, entries = m[1], m[3], m[4], m[5], m[6]
    if mterm != s.current_term[src]:
        return True
    log = s.log[src]
    if not 1 <= prev + 1 <= len(log):
        return False
    if log[prev] != entries[0]:
        return False
    if 0 < prev <= len(log) and log[prev - 1][0] != prev_term:
        return False
    return True


def _message_term_ok(s: PyState, m) -> bool:
    """MessageTermsLtCurrentTerm (:934-935), for one message:
    m.mterm <= currentTerm[m.msource]."""
    return m[3] <= s.current_term[m[1]]


# -- the nine ------------------------------------------------------------------

def messages_inv(s: PyState, dims: Dims) -> bool:
    """MessagesInv (:941-946): \\A m \\in DOMAIN messages: the four
    per-message invariants (a message's count does not matter)."""
    return all(_message_term_ok(s, m) and _request_vote_response_ok(s, m)
               and _request_vote_request_ok(s, m)
               and _append_entries_request_ok(s, m)
               for m, _count in s.messages)


def leader_votes_quorum(s: PyState, dims: Dims) -> bool:
    """LeaderVotesQuorum (:1033-1037): \\A i: state[i] = Leader =>
    {j : currentTerm[j] > currentTerm[i]
         \\/ (currentTerm[j] = currentTerm[i] /\\ votedFor[j] = i)}
    \\in Quorum."""
    n = dims.n_servers
    for i in range(n):
        if s.role[i] != LEADER:
            continue
        ti = s.current_term[i]
        voters = [j for j in range(n)
                  if s.current_term[j] > ti
                  or (s.current_term[j] == ti and s.voted_for[j] == i + 1)]
        if not 2 * len(voters) > n:
            return False
    return True


def candidate_term_not_in_log(s: PyState, dims: Dims) -> bool:
    """CandidateTermNotInLog (:1041-1047): \\A i:
    state[i] = Candidate
    /\\ {j : currentTerm[j] = currentTerm[i]
           /\\ votedFor[j] \\in {i, Nil}} \\in Quorum
    => \\A j, n \\in DOMAIN log[j]: log[j][n].term /= currentTerm[i]."""
    n = dims.n_servers
    for i in range(n):
        if s.role[i] != CANDIDATE:
            continue
        ti = s.current_term[i]
        votable = [j for j in range(n)
                   if s.current_term[j] == ti
                   and s.voted_for[j] in (i + 1, NIL)]
        if 2 * len(votable) > n and any(term == ti for log in s.log
                                         for term, _v in log):
            return False
    return True


def election_safety(s: PyState, dims: Dims) -> bool:
    """ElectionSafety (:1124-1129): \\A i: state[i] = Leader => \\A j:
    Max({n \\in DOMAIN log[i] : log[i][n].term = currentTerm[i]})
    >= Max({n \\in DOMAIN log[j] : log[j][n].term = currentTerm[i]}).
    Max of the empty set is 0."""
    n = dims.n_servers
    for i in range(n):
        if s.role[i] != LEADER:
            continue
        ti = s.current_term[i]
        own = _max_index(s.log[i], ti)
        if any(_max_index(s.log[j], ti) > own for j in range(n)):
            return False
    return True


def log_matching(s: PyState, dims: Dims) -> bool:
    """LogMatching (:1132-1136): \\A i, j:
    \\A n \\in (DOMAIN log[i] \\cap DOMAIN log[j]):
    log[i][n].term = log[j][n].term
    => SubSeq(log[i], 1, n) = SubSeq(log[j], 1, n)
    (whole records, term and value)."""
    n = dims.n_servers
    for i in range(n):
        for j in range(i + 1, n):
            a, b = s.log[i], s.log[j]
            for k in range(1, min(len(a), len(b)) + 1):
                if a[k - 1][0] == b[k - 1][0] and a[:k] != b[:k]:
                    return False
    return True


def votes_granted_inv(s: PyState, dims: Dims) -> bool:
    """VotesGrantedInv (:1145-1153): \\A i, j:
    j \\in votesGranted[i] /\\ currentTerm[i] = currentTerm[j]
    => IsPrefix(Committed(j), log[i])."""
    n = dims.n_servers
    for i in range(n):
        for j in range(n):
            if (s.votes_granted[i] >> j) & 1 \
                    and s.current_term[i] == s.current_term[j] \
                    and not _is_prefix_committed(s, j, i):
                return False
    return True


def quorum_log_inv(s: PyState, dims: Dims) -> bool:
    """QuorumLogInv (:1157-1161): \\A i: \\A S \\in Quorum: \\E j \\in S:
    IsPrefix(Committed(i), log[j]).  Every quorum meets a server that
    holds the prefix exactly when those that lack it are no majority,
    ``2 * |bad| <= N``: both readings are computed and must agree."""
    n = dims.n_servers
    quorums = _quorums(n)
    for i in range(n):
        good = [_is_prefix_committed(s, i, j) for j in range(n)]
        every = all(any(good[j] for j in q) for q in quorums)
        count = 2 * good.count(False) <= n
        if every != count:
            raise AssertionError("QuorumLogInv: the two readings differ")
        if not every:
            return False
    return True


def more_up_to_date_correct(s: PyState, dims: Dims) -> bool:
    """MoreUpToDateCorrect (:1167-1172): \\A i, j:
    (LastTerm(log[i]) > LastTerm(log[j])
     \\/ (LastTerm(log[i]) = LastTerm(log[j])
         /\\ Len(log[i]) >= Len(log[j])))
    => IsPrefix(Committed(j), log[i])."""
    n = dims.n_servers
    for i in range(n):
        for j in range(n):
            if _up_to_date(s, i, j) and not _is_prefix_committed(s, j, i):
                return False
    return True


def leader_completeness(s: PyState, dims: Dims) -> bool:
    """LeaderCompleteness (:1176-1180): \\A i: state[i] = Leader =>
    \\A j: IsPrefix(Committed(j), log[i])."""
    n = dims.n_servers
    for i in range(n):
        if s.role[i] == LEADER and not all(
                _is_prefix_committed(s, j, i) for j in range(n)):
            return False
    return True


#: Name -> predicate (True where the invariant holds): TypeOK, the
#: oracle's, then the nine in the spec's order.
PREDICATES: Dict[str, Callable[[PyState, Dims], bool]] = {
    "TypeOK": type_ok,
    "MessagesInv": messages_inv,
    "LeaderVotesQuorum": leader_votes_quorum,
    "CandidateTermNotInLog": candidate_term_not_in_log,
    "ElectionSafety": election_safety,
    "LogMatching": log_matching,
    "VotesGrantedInv": votes_granted_inv,
    "QuorumLogInv": quorum_log_inv,
    "MoreUpToDateCorrect": more_up_to_date_correct,
    "LeaderCompleteness": leader_completeness,
}


def resolve(names: Sequence[str]) -> List[Callable[[PyState, Dims], bool]]:
    """The predicates of ``names``, in order; ``KeyError`` for a name this
    reference has none for."""
    missing = [nm for nm in names if nm not in PREDICATES]
    if missing:
        raise KeyError(f"no reference predicate for {missing}; it has "
                       f"{list(PREDICATES)}")
    return [PREDICATES[nm] for nm in names]


def first_failing(s: PyState, dims: Dims,
                  names: Sequence[str]) -> Optional[str]:
    """The first of ``names`` (in order) that ``s`` violates, else None."""
    for name, pred in zip(names, resolve(names)):
        if not pred(s, dims):
            return name
    return None


# -- TLC's search with the list -----------------------------------------------

def bfs_suite(dims: Dims, depth: int, names: Sequence[str]) -> Answer:
    """``oracle.bfs``'s exhaustive breadth-first search from ``Init`` to
    ``depth`` levels, keyed on the state itself, with ``names`` in place
    of TypeOK alone: every new distinct state, one that fails the
    constraint too, is checked against the list in its order, and the
    first failing name (in search order) is recorded as the violation.
    As in ``oracle.bfs`` the search goes on to the depth after it."""
    resolve(names)                  # an unknown name raises before the search
    seen: set = set()
    ans = Answer(levels=[], distinct=[], generated=[])
    count = generated = 0

    def admit(t: PyState) -> bool:
        nonlocal count
        if t in seen:
            return False
        seen.add(t)
        count += 1
        failing = first_failing(t, dims, names)
        if ans.violation is None:
            ans.violation = failing
        return bounded_space(t, dims)

    root = init_state(dims)
    frontier = [root] if admit(root) else []
    ans.levels.append(len(frontier))
    ans.distinct.append(count)
    ans.generated.append(generated)
    by_family = [0] * len(FAMILY_NAMES)
    ans.actions.append(list(by_family))
    for level in range(1, depth + 1):
        keep = level < depth         # the last level is counted, not kept
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
        ans.levels.append(n_next)
        ans.distinct.append(count)
        ans.generated.append(generated)
        ans.actions.append(list(by_family))
    return ans


def profile_gap(live: Answer, prof: dict) -> int:
    """The widest gap between a live search and a frozen profile over the
    levels both hold (levels, distinct, generated, each family's count),
    and 1 where the live search found a violation or a deadlock."""
    gap = 0
    for key in ("levels", "distinct", "generated"):
        for a, b in zip(getattr(live, key), prof[key]):
            gap = max(gap, abs(a - b))
    for a, b in zip(live.actions, prof["actions"]):
        gap = max([gap] + [abs(x - y) for x, y in zip(a, b)])
    if live.violation is not None or live.deadlock:
        gap = max(gap, 1)
    return gap


# -- the frozen profile -----------------------------------------------------

def freeze(config: dict, depth: int) -> dict:
    """A configuration's profile: ``bfs_suite`` with its ``invariants``
    to ``depth``, in the layout of ``profiles/<config>.json``."""
    t = time.time()
    ans = bfs_suite(Dims(**config["constants"]), depth,
                    config["invariants"])
    return {"what": (f"{config['name']} from Init: levels 0-{depth} of "
                     f"portbench/reference/suite.py bfs_suite (the "
                     f"oracle's transition system, keyed on the state "
                     f"itself) with the invariants "
                     f"{', '.join(config['invariants'])}, each checked on "
                     f"every distinct state; actions: the cumulative "
                     f"generated count of each family in the order of "
                     f"oracle.FAMILY_NAMES; "
                     f"{datetime.date.today().isoformat()}, "
                     f"{time.time() - t:.0f} s"),
            "levels": ans.levels, "distinct": ans.distinct,
            "generated": ans.generated, "violation": ans.violation,
            "deadlock": ans.deadlock, "actions": ans.actions}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="freeze a configuration's "
                                 "profile with its invariants")
    ap.add_argument("--config", required=True)
    ap.add_argument("--depth", type=int, required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "configs", f"{a.config}.json")
    with open(path) as f:
        prof = freeze(json.load(f), a.depth)
    with open(a.out, "w") as f:
        json.dump(prof, f)
    print(json.dumps({k: v for k, v in prof.items() if k != "actions"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
