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

This is a copy of the JAX package's ``models/dims.py``, the variant hooks
included: a spec variant (``models/reconfig.py``'s joint-consensus
extension) subclasses ``RaftDims`` and overrides them, and the v2
pipeline (``models/actions2.py``), the invariants and the row format
dispatch through them.  The hooks here take and give batched tensors
(a leading row axis, per-lane index tensors ``[X, R]``) where the JAX
ones take one state.  The port imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

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
    def max_log_value(self) -> int:
        """The largest value a log-entry value lane (and the message
        columns that carry values) can hold: client values 1..V here;
        variants with encoded values override it, and the lane audit
        checks it against ``256 ** value_bytes - 1``."""
        return self.n_values

    @property
    def value_bytes(self) -> int:
        """Bytes a log-entry value takes in the packed row: 1 here; 2
        appends high-byte planes for the value lanes (``models/schema.py``
        ``state_width``)."""
        return 1

    @property
    def payload_width(self) -> int:
        return max(6, 2 + 2 * self.max_log)

    @property
    def msg_width(self) -> int:
        return 4 + self.payload_width

    @property
    def family_sizes(self) -> tuple:
        n, v, m = self.n_servers, self.n_values, self.n_msg_slots
        base = (n, n, n * n, n, n * v, n, n * n, m, m, m)
        return base + tuple(sz for _name, sz in self.extra_families)

    @property
    def family_names(self) -> tuple:
        return FAMILY_NAMES + tuple(nm for nm, _sz in self.extra_families)

    # -- model-variant hooks ------------------------------------------------

    @property
    def extra_families(self) -> tuple:
        """Action families past the spec's ten: ``(name, instances)``."""
        return ()

    def build_quorum(self):
        """``quorum(st, i, member) -> bool``: is ``member`` a quorum from
        server i's view.  ``i`` is ``[X, R]``, ``member`` ``[X, R, ...,
        N]`` of 0/1 or bool; the result drops the last axis.  Here the
        spec's simple majority of Server."""
        n = self.n_servers

        def quorum(st, i, member):
            return 2 * member.sum(-1) > n

        return quorum

    def quorum_py(self, s, i: int, mask: int) -> bool:
        """Quorum on a membership bitmask, for one ``PyState``."""
        return 2 * bin(mask).count("1") > self.n_servers

    def build_extra_kernels(self, device):
        """Per extra family ``(param_tables, kernel)``: the tables are
        ``[C]`` tensors (the family's instances in grid order) and
        ``kernel(st, *params) -> (enabled, overflow, successor)`` with
        params ``[X, 1]``.  None here."""
        return []

    def build_extra_v2(self, fp_helpers):
        """Per extra family ``lane_fn(st, *params) -> ((d_base0,
        d_base1), (d_msum0, d_msum1), successor)`` for one lane a row
        (params ``[X, 1]``, from ``build_extra_kernels``' tables), or None
        when the variant has no v2 kernels.  None needed here."""
        return []

    def build_extra_masks_v2(self):
        """Per extra family ``mask_fn(st, pack_ok_parent, *params) ->
        (enabled, overflow)`` (params ``[X, C]``), equal to the
        extra kernel's ``(en, ovf | (en & ~pack_ok(successor)))``; None
        has the masks take that from the kernels."""
        return None

    def extra_successors_py(self, s):
        """The extra families' successors of one ``PyState``, for the
        oracle (``models/oracle.py``): ``((family, params), successor)``
        pairs.  None here."""
        return ()

    def build_value_ok(self):
        """Elementwise: is a log-entry value well-typed (in Value)."""
        v = self.n_values

        def value_ok(vals: torch.Tensor) -> torch.Tensor:
            return (vals >= 1) & (vals <= v)

        return value_ok

    def value_ok_py(self, val: int) -> bool:
        return 1 <= val <= self.n_values

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


#: The base families grouped by parameter grid, by position in the family
#: list: the JAX package's ``models/actions.py`` ``_BASE_GROUPS`` (its v1
#: expansion stacks each group into one dispatch).
_BASE_GROUPS = (
    ("server", (0, 1, 3, 5)),         # Restart/Timeout/BecomeLeader/ACI (i,)
    ("server_pair", (2, 6)),          # RequestVote/AppendEntries (i, j)
    ("server_value", (4,)),           # ClientRequest (i, v)
    ("slot", (7, 8, 9)),              # Receive/Duplicate/Drop (s,)
)
_BASE_FAMILY_NAMES = ("Restart", "Timeout", "RequestVote", "BecomeLeader",
                      "ClientRequest", "AdvanceCommitIndex",
                      "AppendEntries", "Receive", "DuplicateMessage",
                      "DropMessage")


def family_groups(dims: RaftDims) -> List[dict]:
    """``[{"group", "families", "kernels", "lanes"}]``: the base families
    by parameter grid, each extra (variant) family a group of its own;
    ``kernels`` the families in the group, ``lanes`` its instances.  The
    JAX package's ``models/actions.py`` ``family_groups``: the engines'
    ``EngineResult.family_groups``, which the run report's
    ``family_groups`` and its ``expansion groups`` line come from."""
    names = list(dims.family_names)
    sizes = list(dims.family_sizes)
    if tuple(names[:10]) != _BASE_FAMILY_NAMES:
        return [{"group": n, "families": [n], "kernels": 1,
                 "lanes": int(s)} for n, s in zip(names, sizes)]
    out = [{"group": gname, "families": [names[m] for m in members],
            "kernels": len(members),
            "lanes": int(sum(sizes[m] for m in members))}
           for gname, members in _BASE_GROUPS]
    out += [{"group": names[k], "families": [names[k]], "kernels": 1,
             "lanes": int(sizes[k])} for k in range(10, len(names))]
    return out


def _audit_lane_widths(dims: RaftDims) -> None:
    """Every packed field whose largest value is static must fit its lane
    (uint8, or ``value_bytes`` bytes for values); a too-narrow lane is a
    construction error, never a silent wrap."""
    n, L = dims.n_servers, dims.max_log
    checks = (
        ("votes_resp/votes_gran bitmask", (1 << n) - 1, 255),
        ("voted_for", n, 255),
        ("log_len / commit / match_idx", L, 255),
        ("next_idx", L + 1, 255),
        ("log_val / msg value columns", dims.max_log_value,
         256 ** dims.value_bytes - 1),
        ("msg columns 1-2 (src+1, dst+1)", n, 255),
        ("msg column 4 index uses (mprevLogIndex)", L, 127),
        ("msg index/count columns", L + 1, 255),
    )
    for field, domain_max, limit in checks:
        if domain_max > limit:
            raise ValueError(
                f"packed lane too narrow: field {field!r} reaches "
                f"{domain_max} but its lane holds at most {limit}")
