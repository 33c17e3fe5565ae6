"""Struct-of-arrays state schema and the packed uint8 row format.

``StateBatch`` holds the spec's variables as int64 tensors with one leading
batch axis.  The BFS queues store states as ``[state_width]`` uint8 rows,
the JAX package's row format byte for byte (field order below; message
column 4, ``mprevLogIndex``, is two's complement because it can be -1;
a variant with ``dims.value_bytes == 2`` appends the value lanes' high
bytes after the base layout).

``encode_state``/``decode_state`` convert one ``PyState`` to and from a
numpy ``StateBatch`` on the host; ``stack_states`` batches them into
tensors.  Canonical-form invariants the fingerprint relies on: log lanes at
positions >= log_len are zero, free message slots are all-zero rows.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from .dims import AEQ, RVQ, RVR, RaftDims
from .pystate import PyState


class StateBatch(NamedTuple):
    term: torch.Tensor        # [X, N]
    role: torch.Tensor        # [X, N]
    voted_for: torch.Tensor   # [X, N]   0=Nil
    log_term: torch.Tensor    # [X, N, L]
    log_val: torch.Tensor     # [X, N, L]
    log_len: torch.Tensor     # [X, N]
    commit: torch.Tensor      # [X, N]
    votes_resp: torch.Tensor  # [X, N]   bitmask
    votes_gran: torch.Tensor  # [X, N]   bitmask
    next_idx: torch.Tensor    # [X, N, N]
    match_idx: torch.Tensor   # [X, N, N]
    msg: torch.Tensor         # [X, M, W]
    msg_cnt: torch.Tensor     # [X, M]


def gather_states(st: StateBatch, idx: torch.Tensor) -> StateBatch:
    """Rows ``idx`` of every field (the per-lane parent gather)."""
    return StateBatch(*(f.index_select(0, idx) for f in st))


# -- host side: PyState <-> numpy fields ------------------------------------

def encode_message(m: tuple, dims: RaftDims) -> np.ndarray:
    w = np.zeros(dims.msg_width, np.int64)
    mtype, src, dst, mterm = m[0], m[1], m[2], m[3]
    w[0], w[1], w[2], w[3] = mtype + 1, src + 1, dst + 1, mterm
    if mtype == RVQ:
        w[4], w[5] = m[4], m[5]
    elif mtype == RVR:
        granted, mlog = m[4], m[5]
        w[4], w[5] = granted, len(mlog)
        for k, (t, v) in enumerate(mlog):
            w[6 + k] = t
            w[6 + dims.max_log + k] = v
    elif mtype == AEQ:
        prev, pterm, entries, mcommit = m[4], m[5], m[6], m[7]
        w[4], w[5], w[6] = prev, pterm, len(entries)
        if entries:
            w[7], w[8] = entries[0]
        w[9] = mcommit
    else:
        w[4], w[5] = m[4], m[5]
    return w


def decode_message(w, dims: RaftDims) -> tuple:
    mtype = int(w[0]) - 1
    src, dst, mterm = int(w[1]) - 1, int(w[2]) - 1, int(w[3])
    if mtype == RVQ:
        return (RVQ, src, dst, mterm, int(w[4]), int(w[5]))
    if mtype == RVR:
        mlog = tuple((int(w[6 + k]), int(w[6 + dims.max_log + k]))
                     for k in range(int(w[5])))
        return (RVR, src, dst, mterm, int(w[4]), mlog)
    if mtype == AEQ:
        entries = ((int(w[7]), int(w[8])),) if int(w[6]) else ()
        return (AEQ, src, dst, mterm, int(w[4]), int(w[5]), entries,
                int(w[9]))
    return (3, src, dst, mterm, int(w[4]), int(w[5]))


def encode_state(s: PyState, dims: RaftDims) -> StateBatch:
    """PyState -> single-state StateBatch of numpy int64 arrays."""
    n, L, M = dims.n_servers, dims.max_log, dims.n_msg_slots
    log_term = np.zeros((n, L), np.int64)
    log_val = np.zeros((n, L), np.int64)
    log_len = np.zeros(n, np.int64)
    for i, log in enumerate(s.log):
        if len(log) > L:
            raise ValueError(f"log length {len(log)} exceeds capacity {L}")
        log_len[i] = len(log)
        for k, (t, v) in enumerate(log):
            log_term[i, k], log_val[i, k] = t, v
    bag = sorted(s.messages)
    if len(bag) > M:
        raise ValueError(f"{len(bag)} distinct messages exceed {M} slots")
    msg = np.zeros((M, dims.msg_width), np.int64)
    msg_cnt = np.zeros(M, np.int64)
    for slot, (m, c) in enumerate(bag):
        msg[slot] = encode_message(m, dims)
        msg_cnt[slot] = c
    return StateBatch(
        term=np.asarray(s.current_term, np.int64),
        role=np.asarray(s.role, np.int64),
        voted_for=np.asarray(s.voted_for, np.int64),
        log_term=log_term, log_val=log_val, log_len=log_len,
        commit=np.asarray(s.commit_index, np.int64),
        votes_resp=np.asarray(s.votes_responded, np.int64),
        votes_gran=np.asarray(s.votes_granted, np.int64),
        next_idx=np.asarray(s.next_index, np.int64),
        match_idx=np.asarray(s.match_index, np.int64),
        msg=msg, msg_cnt=msg_cnt)


def stack_states(states: List[StateBatch], device) -> StateBatch:
    """Single-state numpy StateBatches -> one batched tensor StateBatch."""
    return StateBatch(*(torch.as_tensor(np.stack(cols), device=device)
                        for cols in zip(*states)))


def decode_state(st: StateBatch, dims: RaftDims) -> PyState:
    """Single-state StateBatch (no batch axis; numpy or tensors) -> PyState."""
    a = StateBatch(*(np.asarray(x.cpu() if isinstance(x, torch.Tensor)
                                else x) for x in st))
    n = dims.n_servers
    logs = tuple(
        tuple((int(a.log_term[i, k]), int(a.log_val[i, k]))
              for k in range(int(a.log_len[i])))
        for i in range(n))
    bag = frozenset(
        (decode_message(a.msg[s], dims), int(a.msg_cnt[s]))
        for s in range(dims.n_msg_slots) if a.msg_cnt[s] > 0)
    return PyState(
        current_term=tuple(int(x) for x in a.term),
        role=tuple(int(x) for x in a.role),
        voted_for=tuple(int(x) for x in a.voted_for),
        log=logs,
        commit_index=tuple(int(x) for x in a.commit),
        votes_responded=tuple(int(x) for x in a.votes_resp),
        votes_granted=tuple(int(x) for x in a.votes_gran),
        next_index=tuple(tuple(int(x) for x in row) for row in a.next_idx),
        match_index=tuple(tuple(int(x) for x in row) for row in a.match_idx),
        messages=bag)


def check_packable(st: StateBatch, dims: RaftDims) -> None:
    """Raise if a root's field cannot round-trip the packed row: message
    column 4 admits [-128, 127], value lanes (log values, the message
    value columns) [0, 65535] when ``dims.value_bytes == 2``, every other
    value [0, 255]."""
    vhi = 256 ** dims.value_bytes - 1
    for name, arr in zip(StateBatch._fields, st):
        a = np.asarray(arr)
        lo = np.zeros(a.shape, np.int64)
        hi = np.full(a.shape, 255, np.int64)
        if name == "log_val":
            hi[...] = vhi
        if name == "msg":
            hi[..., list(_msg_value_cols(dims))] = vhi
            lo[..., 4], hi[..., 4] = -128, 127
        bad = (a < lo) | (a > hi)
        if bad.any():
            idx = tuple(int(i) for i in np.argwhere(bad)[0])
            raise ValueError(f"value {int(a[idx])} at {name}{list(idx)} is "
                             "outside the packable range of the row")


# -- the packed row ---------------------------------------------------------

ROW_DTYPE = torch.uint8


def _msg_value_cols(dims: RaftDims) -> tuple:
    """Message-row columns that carry log values: the AEReq entry value at
    8 and the RVResp mlog values at [6+L, 6+2L), without repeats (at L 2
    column 8 is both)."""
    L = dims.max_log
    return tuple(sorted({8, *range(6 + L, 6 + 2 * L)}))


def _value_runs(dims: RaftDims) -> list:
    """``_msg_value_cols`` as slices of consecutive columns (one or two):
    tensors are cut by slices, since an index list would be a host tensor,
    which a CUDA graph capture refuses."""
    runs = []
    for c in _msg_value_cols(dims):
        if runs and runs[-1].stop == c:
            runs[-1] = slice(runs[-1].start, c + 1)
        else:
            runs.append(slice(c, c + 1))
    return runs


def _value_columns(msg: torch.Tensor, dims: RaftDims) -> torch.Tensor:
    """[X, M, len(cols)]: the value columns of message rows [X, M, W]."""
    return torch.cat([msg[:, :, r] for r in _value_runs(dims)], 2)


def state_width(dims: RaftDims) -> int:
    n, L, M, W = (dims.n_servers, dims.max_log, dims.n_msg_slots,
                  dims.msg_width)
    base = n * 7 + 2 * n * L + 2 * n * n + M * W + M
    if dims.value_bytes == 2:
        # High-byte planes of the log values [N, L] and of the message
        # value columns [M, columns], after the base layout.
        base += n * L + M * len(_msg_value_cols(dims))
    return base


def pack_ok(st: StateBatch, dims: RaftDims) -> torch.Tensor:
    """[X] bool: every unbounded-growth field still fits the packed row
    (terms, bag counts, message terms; column 4 is signed, so <= 127; with
    ``dims.value_bytes == 2`` the value lanes <= 65535)."""
    ok = ((st.term <= 255).all(1) & (st.msg_cnt <= 255).all(1)
          & (st.msg[:, :, 3] <= 255).all(1)
          & (st.msg[:, :, 4] <= 127).all(1))
    if dims.value_bytes == 2:
        ok = (ok & (st.log_val <= 65535).all(2).all(1)
              & (_value_columns(st.msg, dims) <= 65535).all(2).all(1))
    return ok


def flatten_state(st: StateBatch, dims: RaftDims) -> torch.Tensor:
    """StateBatch [X] -> [X, state_width] uint8 rows (values wrap mod 256,
    so column 4's -1 is stored as 255).  With ``dims.value_bytes == 2``
    the row ends with the value lanes' high bytes (log values, then the
    message value columns), so values up to 65535 survive."""
    x = st.term.shape[0]
    parts = [f.reshape(x, -1) for f in st]
    if dims.value_bytes == 2:
        parts.append(st.log_val.reshape(x, -1) >> 8)
        parts.append((_value_columns(st.msg, dims) >> 8).reshape(x, -1))
    return (torch.cat(parts, 1) & 0xFF).to(ROW_DTYPE)


def unflatten_state(rows: torch.Tensor, dims: RaftDims) -> StateBatch:
    """[X, state_width] uint8 rows -> int64 StateBatch (column 4 of each
    message row sign-extended; value lanes reassembled from their low
    byte and high plane when ``dims.value_bytes == 2``)."""
    n, L, M, W = (dims.n_servers, dims.max_log, dims.n_msg_slots,
                  dims.msg_width)
    r = rows.to(torch.int64)
    x = r.shape[0]
    sizes = [n, n, n, n * L, n * L, n, n, n, n, n * n, n * n, M * W, M]
    shapes = [(n,), (n,), (n,), (n, L), (n, L), (n,), (n,), (n,), (n,),
              (n, n), (n, n), (M, W), (M,)]
    out, off = [], 0
    for sz, shp in zip(sizes, shapes):
        out.append(r[:, off:off + sz].reshape((x,) + shp))
        off += sz
    msg = out[11].clone()
    col4 = msg[:, :, 4]
    msg[:, :, 4] = torch.where(col4 >= 128, col4 - 256, col4)
    if dims.value_bytes == 2:
        nc = len(_msg_value_cols(dims))
        lv_hi = r[:, off:off + n * L].reshape(x, n, L)
        off += n * L
        mv_hi = r[:, off:off + M * nc].reshape(x, M, nc)
        out[4] = (out[4] & 0xFF) + (lv_hi << 8)
        k = 0
        for run in _value_runs(dims):
            w = run.stop - run.start
            msg[:, :, run] = ((msg[:, :, run] & 0xFF)
                              + (mv_hi[:, :, k:k + w] << 8))
            k += w
    out[11] = msg
    return StateBatch(*out)
