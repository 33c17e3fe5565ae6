"""The lane/field map: one queryable description of the packed encoding.

``schema.flatten_state`` packs a ``StateBatch`` into a uint8 row; this
module is the machine-readable description of that row which the
analyzers and the error paths share (the JAX package's
``analysis/lane_map.py``, kept here as the port's own copy):

- :func:`row_layout` — packed-row offset -> (field, index) decoding;
- :func:`lane_capacities` — per field (and per message column) the
  range the packed row can represent;
- :func:`field_domains` — the *declared* per-field value domains (the
  lane audit's assumptions, used by the bounds pass as its widening
  envelope and verified against the kernels there);
- :func:`msg_col_name` — semantic name of a message-row column;
- :data:`FIELD_WRITERS` — which base action families write each field
  (``tests/test_torch_analysis.py`` holds this table against the traced
  write sets, so it cannot silently drift).

Import-light on purpose: numpy only, imported inside the functions that
need it, so ``schema.check_packable`` can pull the decoders into its
error messages without an import cycle.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

#: StateBatch field order (= schema.StateBatch._fields; asserted in tests).
FIELDS = ("term", "role", "voted_for", "log_term", "log_val", "log_len",
          "commit", "votes_resp", "votes_gran", "next_idx", "match_idx",
          "msg", "msg_cnt")

#: Base action families that WRITE each field (derived from the spec's
#: variable footprint, raft.tla:136-430; cross-checked against the traced
#: kernels by tests/test_torch_analysis.py).
FIELD_WRITERS: Dict[str, Tuple[str, ...]] = {
    "term": ("Timeout", "Receive"),
    "role": ("Restart", "Timeout", "BecomeLeader", "Receive"),
    "voted_for": ("Timeout", "Receive"),
    "log_term": ("ClientRequest", "Receive"),
    "log_val": ("ClientRequest", "Receive"),
    "log_len": ("ClientRequest", "Receive"),
    # Receive is absent: AppendEntriesAlreadyDone's :309 commit write is
    # conjoined with UNCHANGED logVars (:317, the replicated upstream
    # bug), so it is enabled only when the write is a no-op.
    "commit": ("Restart", "AdvanceCommitIndex"),
    "votes_resp": ("Restart", "Timeout", "Receive"),
    "votes_gran": ("Restart", "Timeout", "Receive"),
    "next_idx": ("Restart", "BecomeLeader", "Receive"),
    "match_idx": ("Restart", "BecomeLeader", "Receive"),
    "msg": ("RequestVote", "AppendEntries", "Receive", "DropMessage"),
    "msg_cnt": ("RequestVote", "AppendEntries", "Receive",
                "DuplicateMessage", "DropMessage"),
}

#: Fields whose growth is unbounded by the spec and whose packed-lane
#: fit is enforced at runtime by ``schema.pack_ok`` (overflow
#: is a hard engine error, never silent aliasing).  Lane findings on
#: these degrade to WARNING when no cfg constraint bounds the growth.
GROWTH_GUARDED = ("term", "log_term", "msg_cnt", "msg")


def field_shapes(dims) -> Dict[str, Tuple[int, ...]]:
    n, L = dims.n_servers, dims.max_log
    M, W = dims.n_msg_slots, dims.msg_width
    return {"term": (n,), "role": (n,), "voted_for": (n,),
            "log_term": (n, L), "log_val": (n, L), "log_len": (n,),
            "commit": (n,), "votes_resp": (n,), "votes_gran": (n,),
            "next_idx": (n, n), "match_idx": (n, n),
            "msg": (M, W), "msg_cnt": (M,)}


def row_layout(dims) -> List[Tuple[str, int, int, Tuple[int, ...]]]:
    """Packed uint8 row layout: ``[(field, offset, size, shape), ...]``
    in ``schema.flatten_state`` order (base layout; the value high-byte
    planes under ``value_bytes == 2`` follow after)."""
    out, off = [], 0
    for f in FIELDS:
        shp = field_shapes(dims)[f]
        size = 1
        for d in shp:
            size *= d
        out.append((f, off, size, shp))
        off += size
    return out


def decode_row_offset(dims, offset: int) -> Tuple[str, Tuple[int, ...]]:
    """Packed-row byte offset -> (field, element index)."""
    for f, off, size, shp in row_layout(dims):
        if off <= offset < off + size:
            rel, idx = offset - off, []
            for d in reversed(shp):
                idx.append(rel % d)
                rel //= d
            return f, tuple(reversed(idx))
    raise IndexError(offset)


def msg_col_name(col: int, dims) -> str:
    """Semantic name of message-row column ``col`` (the payload union of
    dims.py's slot layout)."""
    L = dims.max_log
    base = {0: "mtype+1", 1: "msource+1", 2: "mdest+1", 3: "mterm",
            4: "RVReq mlastLogTerm / RVResp mvoteGranted / "
               "AEReq mprevLogIndex / AEResp msuccess",
            5: "RVReq mlastLogIndex / RVResp Len(mlog) / "
               "AEReq mprevLogTerm / AEResp mmatchIndex",
            6: "AEReq Len(mentries) / RVResp mlog term lane 0",
            9: "AEReq mcommitIndex / RVResp mlog lane"}
    if col in base:
        return base[col]
    if 6 <= col < 6 + L:
        extra = " / AEReq entry term" if col == 7 else ""
        return f"RVResp mlog term lane {col - 6}{extra}"
    if 6 + L <= col < 6 + 2 * L:
        extra = " / AEReq entry value" if col == 8 else ""
        return f"RVResp mlog value lane {col - 6 - L}{extra}"
    return f"payload column {col}"


def lane_capacities(dims) -> Dict[str, Tuple[object, object]]:
    """Per-field packed-lane ranges ``{field: (lo, hi)}``; ``msg`` maps
    to per-column ``(lo[W], hi[W])`` lists.  This is what the uint8 row
    (plus the value high-byte planes under ``value_bytes == 2``) can
    represent without aliasing — the bound the bounds pass proves."""
    import numpy as np
    vmax = 256 ** dims.value_bytes - 1
    W = dims.msg_width
    caps: Dict[str, Tuple[object, object]] = {
        f: (0, 255) for f in FIELDS}
    caps["log_val"] = (0, vmax)
    col_lo = np.zeros(W, np.int64)
    col_hi = np.full(W, 255, np.int64)
    col_lo[4], col_hi[4] = -128, 127
    for c in _msg_value_cols(dims):
        col_hi[c] = vmax
    caps["msg"] = (col_lo, col_hi)
    return caps


def _msg_value_cols(dims):
    """The message columns that have a high-byte plane: the packer's
    value columns (``models/schema.py``) under ``value_bytes == 2``,
    else none."""
    from ..models.schema import _msg_value_cols as value_cols
    return value_cols(dims) if dims.value_bytes == 2 else ()


def field_domains(dims) -> Dict[str, Tuple[object, object]]:
    """Declared per-field value domains — the machine-readable version
    of the lane audit (``dims._audit_lane_widths``).  The bounds pass uses
    these only as its *widening envelope* for fields whose interval
    does not converge on its own (index-exchange cycles, unbounded
    growth), and reports every field where one action step escapes the
    envelope, so a wrong entry here is surfaced, not silently trusted.
    ``msg`` maps to per-column arrays."""
    import numpy as np
    n, L = dims.n_servers, dims.max_log
    W = dims.msg_width
    vmax = dims.max_log_value
    dom: Dict[str, Tuple[object, object]] = {
        "term": (0, 255),                  # growth lane (pack-guarded)
        "role": (0, 2),
        "voted_for": (0, n),
        "log_term": (0, 255),              # carries term values
        "log_val": (0, vmax),
        "log_len": (0, L),
        "commit": (0, L),
        "votes_resp": (0, (1 << n) - 1),
        "votes_gran": (0, (1 << n) - 1),
        "next_idx": (1, L + 1),
        "match_idx": (0, L),
        "msg_cnt": (0, 255),               # growth lane (pack-guarded)
    }
    col_lo = np.zeros(W, np.int64)
    col_hi = np.zeros(W, np.int64)
    col_hi[0] = 5                          # mtype+1 (0 = free slot)
    col_hi[1] = col_hi[2] = n              # msource+1 / mdest+1
    col_hi[3] = 255                        # mterm (growth, pack-guarded)
    col_lo[4], col_hi[4] = -1, 127         # index uses int8; term uses
    # Columns 5.. carry terms, mlog terms, counts, indices, or values —
    # all byte lanes (the term-carrying ones runtime-guarded via the
    # sender's mterm; the lane audit in models/dims.py).
    for c in range(5, W):
        col_hi[c] = 255
    for c in _msg_value_cols(dims):
        col_hi[c] = max(col_hi[c], vmax)
    dom["msg"] = (col_lo, col_hi)
    return dom


def msg_type_domains(dims) -> List[Tuple[object, object]]:
    """Declared per-message-TYPE payload domains ``[(lo[W], hi[W])]``
    for mtype 0..3 (dims.py slot layout).  The bounds pass case-splits
    ``Receive`` on the received message's type with these, which is
    what keeps union payload lanes (e.g. column 5 = AEResp mmatchIndex
    OR AEReq mprevLogTerm) from smearing a term bound into an index
    computation.  Like :func:`field_domains` these are declared
    envelopes of the schemas raft.tla:443-475 under the uint8 packing;
    the runtime pack guard remains the backstop for the term-carrying
    columns."""
    import numpy as np
    n, L = dims.n_servers, dims.max_log
    W = dims.msg_width
    vmax = dims.max_log_value
    out = []
    for t in range(4):
        lo = np.zeros(W, np.int64)
        hi = np.zeros(W, np.int64)
        lo[0] = hi[0] = t + 1
        lo[1] = lo[2] = 1
        hi[1] = hi[2] = n
        hi[3] = 255                         # mterm (pack-guarded growth)
        if t == 0:      # RequestVoteRequest
            hi[4] = 127                     # mlastLogTerm (pack guard)
            hi[5] = L                       # mlastLogIndex
        elif t == 1:    # RequestVoteResponse
            hi[4] = 1                       # mvoteGranted
            hi[5] = L                       # Len(mlog)
            for c in range(6, 6 + L):       # mlog terms
                hi[c] = 255
            for c in range(6 + L, 6 + 2 * L):   # mlog values
                hi[c] = vmax
        elif t == 2:    # AppendEntriesRequest
            lo[4], hi[4] = -1, 127          # mprevLogIndex (int8 lane)
            hi[5] = 255                     # mprevLogTerm
            hi[6] = 1                       # Len(mentries) <= 1
            if W > 7:
                hi[7] = 255                 # entry term
            if W > 8:
                hi[8] = vmax                # entry value
            if W > 9:
                hi[9] = L                   # mcommitIndex
        else:           # AppendEntriesResponse
            hi[4] = 1                       # msuccess
            hi[5] = L + 1                   # mmatchIndex
        out.append((lo, hi))
    return out


def constraint_bounds(dims, bounds) -> Dict[str, Tuple[object, object]]:
    """Per-field clamps implied by the cfg's CONSTRAINT bounds
    (models/invariants.Bounds): constraint-violating states are counted
    but never *expanded*, so the bounds pass intersects its input states
    with these before applying a kernel."""
    out: Dict[str, Tuple[object, object]] = {}
    if bounds is None:
        return out
    if bounds.max_term is not None:
        out["term"] = (0, bounds.max_term)
    if bounds.max_log_len is not None:
        out["log_len"] = (0, bounds.max_log_len)
    if bounds.max_msg_count is not None:
        out["msg_cnt"] = (0, bounds.max_msg_count)
    return out


def describe_lane(field: str, index: Optional[Tuple[int, ...]],
                  dims) -> str:
    """Human-readable lane description for error messages: field name
    plus, for message rows, the decoded column meaning, plus the action
    families that write the field."""
    where = f"state field {field!r}"
    if field == "msg" and index is not None and len(index) == 2:
        slot, col = index
        where += (f" slot {slot} column {col} "
                  f"({msg_col_name(col, dims)})")
    elif index is not None:
        where += f" at index {tuple(index)}"
    writers = FIELD_WRITERS.get(field)
    if writers:
        where += f"; lane written by action families: {', '.join(writers)}"
    return where
