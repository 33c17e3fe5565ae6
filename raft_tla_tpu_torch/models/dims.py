"""Static model dimensions and the action-instance grid.

The spec's abstract constants (``Server``, ``Value``) are bound to finite
model-value sets by the TLC harness (3 servers, 2 values for MCraft).  Here
those bindings become static dimensions: every tensor shape and the whole
action-instance grid follow from one ``RaftDims``.

Encodings (shared with the row format of ``models/schema.py``):

- servers are ``0..N-1``; values are ``1..V`` (``0`` = empty log slot);
- roles ``0=Follower, 1=Candidate, 2=Leader``; ``votedFor`` ``0=Nil``,
  ``j+1`` = server ``j``;
- message types ``0=RequestVoteRequest, 1=RequestVoteResponse,
  2=AppendEntriesRequest, 3=AppendEntriesResponse``;
- vote sets are N-bit masks; logs are ``[L]`` term/value lanes plus a
  length, with the lanes past the length zero.

Message slot layout (one ``[msg_width]`` row plus a count per distinct
in-flight message; column 0 holds ``mtype + 1`` so an all-zero row is a
free slot):

  common:  [0]=mtype+1  [1]=msource+1  [2]=mdest+1  [3]=mterm
  RVReq :  [4]=mlastLogTerm  [5]=mlastLogIndex
  RVResp:  [4]=mvoteGranted  [5]=Len(mlog)  [6:6+L]=mlog terms
           [6+L:6+2L]=mlog values
  AEReq :  [4]=mprevLogIndex (may be -1)  [5]=mprevLogTerm
           [6]=Len(mentries) (<= 1)  [7]=entry term  [8]=entry value
           [9]=mcommitIndex
  AEResp:  [4]=msuccess  [5]=mmatchIndex

This is a copy of the JAX package's ``models/dims.py`` for the base spec
(no variant families): the port imports nothing of that package.
"""

from __future__ import annotations

import dataclasses

FOLLOWER, CANDIDATE, LEADER = 0, 1, 2
NIL = 0

RVQ, RVR, AEQ, AER = 0, 1, 2, 3
MSG_TYPE_NAMES = ("RequestVoteRequest", "RequestVoteResponse",
                  "AppendEntriesRequest", "AppendEntriesResponse")

# Action-family codes, in the order of the Next disjunction.
A_RESTART = 0
A_TIMEOUT = 1
A_REQUESTVOTE = 2
A_BECOMELEADER = 3
A_CLIENTREQUEST = 4
A_ADVANCECOMMIT = 5
A_APPENDENTRIES = 6
A_RECEIVE = 7
A_DUPLICATE = 8
A_DROP = 9

FAMILY_NAMES = ("Restart", "Timeout", "RequestVote", "BecomeLeader",
                "ClientRequest", "AdvanceCommitIndex", "AppendEntries",
                "Receive", "DuplicateMessage", "DropMessage")


@dataclasses.dataclass(frozen=True)
class RaftDims:
    """Static shape parameters of one checker instance."""

    n_servers: int
    n_values: int
    max_log: int = 8
    n_msg_slots: int = 32

    def __post_init__(self):
        if not (1 <= self.n_servers <= 8):
            raise ValueError("n_servers must be in 1..8 (bitmask encoding)")
        if not (1 <= self.n_values <= 255):
            raise ValueError("n_values must be in 1..255 (uint8 row packing)")
        if not (1 <= self.max_log <= 127):
            raise ValueError("max_log must be in 1..127 (uint8 row packing)")
        _audit_lane_widths(self)

    @property
    def payload_width(self) -> int:
        return max(6, 2 + 2 * self.max_log)

    @property
    def msg_width(self) -> int:
        return 4 + self.payload_width

    @property
    def family_sizes(self) -> tuple:
        n, v, m = self.n_servers, self.n_values, self.n_msg_slots
        return (n, n, n * n, n, n * v, n, n * n, m, m, m)

    @property
    def family_names(self) -> tuple:
        return FAMILY_NAMES

    @property
    def family_offsets(self) -> tuple:
        offs, acc = [], 0
        for s in self.family_sizes:
            offs.append(acc)
            acc += s
        return tuple(offs)

    @property
    def n_instances(self) -> int:
        return sum(self.family_sizes)

    def instance_info(self, g: int) -> tuple:
        """Grid index -> (family, params dict), for trace printing."""
        n, v = self.n_servers, self.n_values
        for fam, (off, size) in enumerate(zip(self.family_offsets,
                                              self.family_sizes)):
            if off <= g < off + size:
                k = g - off
                if fam in (A_RESTART, A_TIMEOUT, A_BECOMELEADER,
                           A_ADVANCECOMMIT):
                    return fam, {"i": k}
                if fam in (A_REQUESTVOTE, A_APPENDENTRIES):
                    return fam, {"i": k // n, "j": k % n}
                if fam == A_CLIENTREQUEST:
                    return fam, {"i": k // v, "v": k % v + 1}
                return fam, {"slot": k}
        raise IndexError(g)

    def describe_instance(self, g: int) -> str:
        fam, p = self.instance_info(g)
        return (f"{self.family_names[fam]}("
                f"{', '.join(f'{k}={v}' for k, v in p.items())})")


def _audit_lane_widths(dims: RaftDims) -> None:
    """Every packed field whose largest value is static must fit its uint8
    lane; a too-narrow lane is a construction error, never a silent wrap."""
    n, L = dims.n_servers, dims.max_log
    checks = (
        ("votes_resp/votes_gran bitmask", (1 << n) - 1, 255),
        ("voted_for", n, 255),
        ("log_len / commit / match_idx", L, 255),
        ("next_idx", L + 1, 255),
        ("log_val / msg value columns", dims.n_values, 255),
        ("msg columns 1-2 (src+1, dst+1)", n, 255),
        ("msg column 4 index uses (mprevLogIndex)", L, 127),
        ("msg index/count columns", L + 1, 255),
    )
    for field, domain_max, limit in checks:
        if domain_max > limit:
            raise ValueError(
                f"packed lane too narrow: field {field!r} reaches "
                f"{domain_max} but its lane holds at most {limit}")
