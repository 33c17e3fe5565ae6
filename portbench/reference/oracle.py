"""The plain reference: a pure-Python interpreter of the Raft spec.

A frozen copy of the port's ``models/oracle.py`` (itself the JAX
package's), a direct transcription of ``raft.tla``'s transition system
(actions :136-430), with its own state type, constants and bag helpers,
so it imports no torch and nothing of the program.  ``bfs`` is TLC's
exhaustive breadth-first search over it (a state that fails the
constraint is generated, counted as distinct and checked, never
expanded), keyed either on the state itself (exact) or on a truncated
seeded hash of it (``key_bits``: the control of ``control.py``).

Faithfulness notes (what must match TLC's semantics):

- ``AppendEntriesAlreadyDone`` (raft.tla:301-317) conjoins
  ``commitIndex' = m.mcommitIndex`` (:309) with ``UNCHANGED logVars``
  (:317, the known upstream bug) and ``logVars`` includes ``commitIndex``
  (:51), so the action is enabled only when ``m.mcommitIndex =
  commitIndex[i]``.  The bug is kept: fixing it changes the state count.
- ``UpdateTerm`` (raft.tla:373-379) leaves the message in flight (:378).
- ``ReturnToFollowerState`` (raft.tla:295-299) does not consume the
  message.
- ``ConflictAppendEntriesRequest`` (raft.tla:319-325) truncates exactly
  ONE trailing entry (:323-324), wherever the conflict is.
- ``Timeout`` does not self-vote (:149-151).
- ``Min``/``Max`` (raft.tla:106-108) are only applied to sets that are
  non-empty at their call sites.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, List, Optional, Tuple

FOLLOWER, CANDIDATE, LEADER = 0, 1, 2
NIL = 0
RVQ, RVR, AEQ, AER = 0, 1, 2, 3
(A_RESTART, A_TIMEOUT, A_REQUESTVOTE, A_BECOMELEADER, A_CLIENTREQUEST,
 A_ADVANCECOMMIT, A_APPENDENTRIES, A_RECEIVE, A_DUPLICATE,
 A_DROP) = range(10)

#: The action families in the order above, named as ``raft.tla`` and the
#: checker's coverage table name them.
FAMILY_NAMES = ("Restart", "Timeout", "RequestVote", "BecomeLeader",
                "ClientRequest", "AdvanceCommitIndex", "AppendEntries",
                "Receive", "DuplicateMessage", "DropMessage")

Entry = Tuple[int, int]
Log = Tuple[Entry, ...]
# Flat tuples (mtype, msource, mdest, mterm, payload...):
#   RVQ (mlastLogTerm, mlastLogIndex); RVR (mvoteGranted, mlog);
#   AEQ (mprevLogIndex, mprevLogTerm, mentries, mcommitIndex);
#   AER (msuccess, mmatchIndex).
Message = Tuple
Bag = FrozenSet[Tuple[Message, int]]


@dataclasses.dataclass(frozen=True)
class Dims:
    """The model's constants: |Server|, |Value| and the BoundedSpace
    bounds (MaxTerm, MaxLogLen, MaxMsgCount)."""

    n_servers: int
    n_values: int
    max_term: int
    max_log_len: int
    max_msg_count: int


@dataclasses.dataclass(frozen=True)
class PyState:
    """One global state of the Raft spec; servers and values are 0-based
    indices, ``voted_for`` is 0 for Nil and j + 1 for server j, vote sets
    are bitmasks, the bag a frozenset of (message, count)."""

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


def init_state(dims: Dims) -> PyState:
    """The unique initial state (``Init``, raft.tla:122-134)."""
    n = dims.n_servers
    return PyState(
        current_term=(1,) * n, role=(FOLLOWER,) * n, voted_for=(NIL,) * n,
        log=((),) * n, commit_index=(0,) * n, votes_responded=(0,) * n,
        votes_granted=(0,) * n,
        next_index=tuple((1,) * n for _ in range(n)),
        match_index=tuple((0,) * n for _ in range(n)),
        messages=frozenset())


def bag_add(bag: Bag, m: Message) -> Bag:
    """WithMessage (raft.tla:92-97)."""
    d = dict(bag)
    d[m] = d.get(m, 0) + 1
    return frozenset(d.items())


def bag_remove(bag: Bag, m: Message) -> Bag:
    """WithoutMessage (raft.tla:99-104)."""
    d = dict(bag)
    c = d.get(m, 0)
    if c <= 1:
        d.pop(m, None)
    else:
        d[m] = c - 1
    return frozenset(d.items())


def bag_reply(bag: Bag, response: Message, request: Message) -> Bag:
    """Reply (raft.tla:110-111): add ``response``, remove ``request``."""
    return bag_remove(bag_add(bag, response), request)


def type_ok(s: PyState, dims: Dims) -> bool:
    """TypeOK: what a state of these tuples can get wrong."""
    n = dims.n_servers
    ok = all(0 <= r <= 2 for r in s.role)
    ok &= all(0 <= vf <= n for vf in s.voted_for)
    ok &= all(t >= 0 and 1 <= val <= dims.n_values
              for log in s.log for (t, val) in log)
    ok &= all(t >= 0 for t in s.current_term)
    ok &= all(c >= 0 for c in s.commit_index)
    ok &= all(0 <= m < (1 << n)
              for m in s.votes_responded + s.votes_granted)
    ok &= all(x >= 1 for row in s.next_index for x in row)
    ok &= all(x >= 0 for row in s.match_index for x in row)
    ok &= all(c >= 1 for _m, c in s.messages)
    return ok


def bounded_space(s: PyState, dims: Dims) -> bool:
    """The BoundedSpace CONSTRAINT: every term <= MaxTerm, every log <=
    MaxLogLen entries, every message at most MaxMsgCount times."""
    return (max(s.current_term) <= dims.max_term
            and max(len(lg) for lg in s.log) <= dims.max_log_len
            and all(c <= dims.max_msg_count for _m, c in s.messages))


# An action instance: (family, params tuple) — params are (i,), (i, j),
# (i, v), or (message,) for the three network families.
Action = Tuple[int, Tuple]


def last_term(log) -> int:
    """LastTerm(xlog) — raft.tla:84."""
    return log[-1][0] if log else 0


def quorum(mask: int, n: int) -> bool:
    """votesGranted[i] \\in Quorum — raft.tla:81 (simple majority)."""
    return 2 * bin(mask).count("1") > n


# ---------------------------------------------------------------------------
# Spontaneous server actions (raft.tla:136-236).

def restart(s: PyState, dims: Dims, i: int) -> Optional[PyState]:
    """Restart(i) — raft.tla:136-143. Keeps currentTerm, votedFor, log."""
    n = dims.n_servers
    return s.replace(
        role=_set(s.role, i, FOLLOWER),
        votes_responded=_set(s.votes_responded, i, 0),
        votes_granted=_set(s.votes_granted, i, 0),
        next_index=_setrow(s.next_index, i, (1,) * n),
        match_index=_setrow(s.match_index, i, (0,) * n),
        commit_index=_set(s.commit_index, i, 0),
    )


def timeout(s: PyState, dims: Dims, i: int) -> Optional[PyState]:
    """Timeout(i) — raft.tla:146-154."""
    if s.role[i] not in (FOLLOWER, CANDIDATE):
        return None
    return s.replace(
        role=_set(s.role, i, CANDIDATE),
        current_term=_set(s.current_term, i, s.current_term[i] + 1),
        voted_for=_set(s.voted_for, i, NIL),          # no self-vote :149-151
        votes_responded=_set(s.votes_responded, i, 0),
        votes_granted=_set(s.votes_granted, i, 0),
    )


def request_vote(s: PyState, dims: Dims, i: int, j: int) -> Optional[PyState]:
    """RequestVote(i, j) — raft.tla:157-166.  i = j is allowed."""
    if s.role[i] != CANDIDATE or (s.votes_responded[i] >> j) & 1:
        return None
    m: Message = (RVQ, i, j, s.current_term[i],
                  last_term(s.log[i]), len(s.log[i]))
    return s.replace(messages=bag_add(s.messages, m))


def append_entries(s: PyState, dims: Dims, i: int, j: int) -> Optional[PyState]:
    """AppendEntries(i, j) — raft.tla:171-192.  Sends <= 1 entry."""
    if i == j or s.role[i] != LEADER:
        return None
    log_i = s.log[i]
    ni = s.next_index[i][j]
    prev_index = ni - 1
    prev_term = (log_i[prev_index - 1][0]
                 if 0 < prev_index <= len(log_i) else 0)     # :177-180
    last_entry = min(len(log_i), ni)                          # :182
    entries = tuple(log_i[ni - 1:last_entry])                 # SubSeq :183
    m: Message = (AEQ, i, j, s.current_term[i],
                  prev_index, prev_term, entries,
                  min(s.commit_index[i], last_entry))         # :189
    return s.replace(messages=bag_add(s.messages, m))


def become_leader(s: PyState, dims: Dims, i: int) -> Optional[PyState]:
    """BecomeLeader(i) — raft.tla:195-203."""
    if s.role[i] != CANDIDATE or not quorum(s.votes_granted[i], dims.n_servers):
        return None
    n = dims.n_servers
    return s.replace(
        role=_set(s.role, i, LEADER),
        next_index=_setrow(s.next_index, i, (len(s.log[i]) + 1,) * n),
        match_index=_setrow(s.match_index, i, (0,) * n),
    )


def client_request(s: PyState, dims: Dims, i: int, v: int) -> Optional[PyState]:
    """ClientRequest(i, v) — raft.tla:206-213."""
    if s.role[i] != LEADER:
        return None
    new_log = s.log[i] + ((s.current_term[i], v),)
    return s.replace(log=_set(s.log, i, new_log))


def advance_commit_index(s: PyState, dims: Dims, i: int) -> Optional[PyState]:
    """AdvanceCommitIndex(i) — raft.tla:219-236."""
    if s.role[i] != LEADER:
        return None
    n = dims.n_servers
    log_i = s.log[i]

    def agree(index: int) -> bool:
        mask = (1 << i) | sum(
            1 << k for k in range(n) if s.match_index[i][k] >= index)
        return quorum(mask, n)                                # :222-226

    agree_indexes = [idx for idx in range(1, len(log_i) + 1) if agree(idx)]
    if agree_indexes and log_i[max(agree_indexes) - 1][0] == s.current_term[i]:
        new_commit = max(agree_indexes)                       # :229-232
    else:
        new_commit = s.commit_index[i]
    return s.replace(commit_index=_set(s.commit_index, i, new_commit))


# ---------------------------------------------------------------------------
# Message handlers (raft.tla:244-403).

def receive(s: PyState, dims: Dims, m: Message) -> Optional[PyState]:
    """Receive(m) — raft.tla:388-403.

    The disjuncts are pairwise mutually exclusive (the mterm comparisons
    partition </=/>, role guards partition Follower/Candidate, logOk splits
    Reject/Accept, and the three Accept sub-cases are disjoint), so at most
    one successor exists per message.
    """
    mtype, j, i, mterm = m[0], m[1], m[2], m[3]   # i=mdest, j=msource :389-390

    # UpdateTerm(i, j, m) — raft.tla:373-379.  Message NOT consumed.
    if mterm > s.current_term[i]:
        return s.replace(
            current_term=_set(s.current_term, i, mterm),
            role=_set(s.role, i, FOLLOWER),
            voted_for=_set(s.voted_for, i, NIL),
        )

    if mtype == RVQ:
        return _handle_request_vote_request(s, dims, i, j, m)
    if mtype == RVR:
        if mterm < s.current_term[i]:                 # DropStaleResponse :382
            return s.replace(messages=bag_remove(s.messages, m))
        return _handle_request_vote_response(s, i, j, m)
    if mtype == AEQ:
        return _handle_append_entries_request(s, dims, i, j, m)
    if mtype == AER:
        if mterm < s.current_term[i]:                 # DropStaleResponse :402
            return s.replace(messages=bag_remove(s.messages, m))
        return _handle_append_entries_response(s, i, j, m)
    raise AssertionError(f"bad mtype {mtype}")


def _handle_request_vote_request(s, dims, i, j, m) -> Optional[PyState]:
    """HandleRequestVoteRequest — raft.tla:244-263 (guard mterm <= currentTerm
    established by caller)."""
    _, _, _, mterm, m_last_term, m_last_index = m
    log_ok = (m_last_term > last_term(s.log[i])
              or (m_last_term == last_term(s.log[i])
                  and m_last_index >= len(s.log[i])))          # :245-247
    grant = (mterm == s.current_term[i] and log_ok
             and s.voted_for[i] in (NIL, j + 1))               # :248-250
    resp: Message = (RVR, i, j, s.current_term[i], int(grant),
                     s.log[i])                # full log copy in mlog :257-259
    return s.replace(
        voted_for=_set(s.voted_for, i, j + 1) if grant else s.voted_for,
        messages=bag_reply(s.messages, resp, m),
    )


def _handle_request_vote_response(s, i, j, m) -> PyState:
    """HandleRequestVoteResponse — raft.tla:267-279 (mterm = currentTerm[i]).
    Tallies even when not Candidate (:268-269)."""
    granted = m[4]
    return s.replace(
        votes_responded=_set(s.votes_responded, i,
                             s.votes_responded[i] | (1 << j)),
        votes_granted=_set(s.votes_granted, i,
                           s.votes_granted[i] | (1 << j) if granted
                           else s.votes_granted[i]),
        messages=bag_remove(s.messages, m),
    )


def _handle_append_entries_request(s, dims, i, j, m) -> Optional[PyState]:
    """HandleAppendEntriesRequest — raft.tla:347-356 and its three branches."""
    _, _, _, mterm, prev_index, prev_term, entries, m_commit = m
    log_i = s.log[i]
    log_ok = (prev_index == 0
              or (0 < prev_index <= len(log_i)
                  and prev_term == log_i[prev_index - 1][0]))  # :348-351

    # RejectAppendEntriesRequest — raft.tla:281-293.
    if (mterm < s.current_term[i]
            or (mterm == s.current_term[i] and s.role[i] == FOLLOWER
                and not log_ok)):
        resp: Message = (AER, i, j, s.current_term[i], 0, 0)
        return s.replace(messages=bag_reply(s.messages, resp, m))

    # ReturnToFollowerState — raft.tla:295-299. Message not consumed.
    if mterm == s.current_term[i] and s.role[i] == CANDIDATE:
        return s.replace(role=_set(s.role, i, FOLLOWER))

    # AcceptAppendEntriesRequest — raft.tla:333-341.
    if mterm == s.current_term[i] and s.role[i] == FOLLOWER and log_ok:
        index = prev_index + 1                                  # :338
        already_done = (entries == ()
                        or (len(log_i) >= index
                            and log_i[index - 1][0] == entries[0][0]))
        if already_done:
            # AppendEntriesAlreadyDone — raft.tla:301-317, including the
            # :317 UNCHANGED-logVars bug: enabled only if mcommitIndex equals
            # the current commitIndex (hidden guard).
            if m_commit != s.commit_index[i]:
                return None
            resp = (AER, i, j, s.current_term[i], 1,
                    prev_index + len(entries))                  # :313
            return s.replace(messages=bag_reply(s.messages, resp, m))
        if len(log_i) >= index and log_i[index - 1][0] != entries[0][0]:
            # ConflictAppendEntriesRequest — raft.tla:319-325: drop exactly
            # one trailing entry; no reply, message stays in flight.
            return s.replace(log=_set(s.log, i, log_i[:-1]))
        if len(log_i) == prev_index:
            # NoConflictAppendEntriesRequest — raft.tla:327-331.
            return s.replace(log=_set(s.log, i, log_i + (entries[0],)))
        return None

    return None  # e.g. Leader receiving same-term AEQ: no branch enabled.


def _handle_append_entries_response(s, i, j, m) -> PyState:
    """HandleAppendEntriesResponse — raft.tla:360-370 (mterm = currentTerm)."""
    success, mmatch = m[4], m[5]
    if success:
        ni = _setcell(s.next_index, i, j, mmatch + 1)
        mi = _setcell(s.match_index, i, j, mmatch)
    else:
        ni = _setcell(s.next_index, i, j, max(s.next_index[i][j] - 1, 1))
        mi = s.match_index
    return s.replace(next_index=ni, match_index=mi,
                     messages=bag_remove(s.messages, m))


def duplicate_message(s: PyState, m: Message) -> PyState:
    """DuplicateMessage(m) — raft.tla:410-412."""
    return s.replace(messages=bag_add(s.messages, m))


def drop_message(s: PyState, m: Message) -> PyState:
    """DropMessage(m) — raft.tla:415-417."""
    return s.replace(messages=bag_remove(s.messages, m))


# ---------------------------------------------------------------------------
# Next — raft.tla:421-430.

def successors(s: PyState, dims: Dims) -> List[Tuple[Action, PyState]]:
    """All (action, successor) pairs of the Next disjunction for state s."""
    n, v = dims.n_servers, dims.n_values
    out: List[Tuple[Action, PyState]] = []

    def add(fam, params, t):
        if t is not None:
            out.append(((fam, params), t))

    for i in range(n):
        add(A_RESTART, (i,), restart(s, dims, i))
        add(A_TIMEOUT, (i,), timeout(s, dims, i))
        add(A_BECOMELEADER, (i,), become_leader(s, dims, i))
        add(A_ADVANCECOMMIT, (i,), advance_commit_index(s, dims, i))
        for j in range(n):
            add(A_REQUESTVOTE, (i, j), request_vote(s, dims, i, j))
            add(A_APPENDENTRIES, (i, j), append_entries(s, dims, i, j))
        for val in range(1, v + 1):
            add(A_CLIENTREQUEST, (i, val), client_request(s, dims, i, val))
    for m, _count in s.messages:          # \E m \in DOMAIN messages
        add(A_RECEIVE, (m,), receive(s, dims, m))
        add(A_DUPLICATE, (m,), duplicate_message(s, m))
        add(A_DROP, (m,), drop_message(s, m))
    return out


def successor_set(s: PyState, dims: Dims) -> set:
    return {t for _a, t in successors(s, dims)}


# ---------------------------------------------------------------------------
# tuple-surgery helpers

def _set(tup: Tuple, i: int, val) -> Tuple:
    return tup[:i] + (val,) + tup[i + 1:]


def _setrow(mat: Tuple[Tuple, ...], i: int, row: Tuple) -> Tuple:
    return mat[:i] + (row,) + mat[i + 1:]


def _setcell(mat: Tuple[Tuple, ...], i: int, j: int, val) -> Tuple:
    return _setrow(mat, i, _set(mat[i], j, val))


# ---------------------------------------------------------------------------
# TLC's exhaustive search.

@dataclasses.dataclass
class Answer:
    """What a check reports: the frontier a level (level 0 the roots;
    the states that pass the constraint, the ones expanded next), and
    per level the cumulative distinct and generated counts, the first
    invariant violation and the first deadlock (None when none);
    ``actions`` per level the cumulative generated count of each family
    (``FAMILY_NAMES`` order)."""

    levels: List[int]
    distinct: List[int]
    generated: List[int]
    actions: List[List[int]] = dataclasses.field(default_factory=list)
    violation: Optional[str] = None
    deadlock: bool = False


def bfs(dims: Dims, depth: int, key_bits: Optional[int] = None,
        seed: int = 0) -> Answer:
    """Breadth-first search from ``Init`` to ``depth`` levels.  With
    ``key_bits`` None a state is seen when the state itself was (exact);
    otherwise when a state with the same low ``key_bits`` bits of
    ``hash((seed, state))`` was (a fingerprint of that many bits, each
    seed a different hash)."""
    mask = None if key_bits is None else (1 << key_bits) - 1
    seen: set = set()
    ans = Answer(levels=[], distinct=[], generated=[])
    count = generated = 0

    def admit(t: PyState) -> bool:
        nonlocal count
        key = t if mask is None else hash((seed, t)) & mask
        if key in seen:
            return False
        seen.add(key)
        count += 1
        if ans.violation is None and not type_ok(t, dims):
            ans.violation = "TypeOK"
        return bounded_space(t, dims)

    root = init_state(dims)
    frontier = [root] if admit(root) else []
    ans.levels.append(len(frontier))
    ans.distinct.append(count)
    ans.generated.append(generated)
    by_family = [0] * len(FAMILY_NAMES)
    ans.actions.append(list(by_family))
    for level in range(1, depth + 1):
        # The last level's states are counted, not kept.
        keep = level < depth
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
