"""State fingerprints: two independent 32-bit lanes ``(hi, lo)``.

The JAX package's ``ops/fingerprint.py`` hash, bit for bit:

- the ordered part (every server-indexed field) contributes
  ``sum(fmix32(x * C_pos + seed)) mod 2^32``;
- each occupied message slot is double-mixed into a per-slot hash and the
  bag contributes ``sum(slot_h * count)`` (order-invariant in slot order);
- ``fmix32(base + fmix32(msum + seed) * 0x9E3779B9)`` finalizes a lane.

Constants come from ``RandomState(0x7A57)`` in the same draw order.  The
all-ones pair is the seen-set's empty sentinel, so a fingerprint landing
on it has its ``lo`` lane remapped to ``0xFFFFFFFE``.

PyTorch has no general uint32 arithmetic, so lanes are int64 tensors that
hold values in ``[0, 2^32)``: every step masks with ``0xFFFFFFFF`` and
each 32x32 multiply is split so no intermediate passes 2^63.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.dims import RaftDims
from ..models.schema import StateBatch

MASK32 = 0xFFFFFFFF
SENTINEL = 0xFFFFFFFF


def mul32(a, b):
    """``a * b mod 2^32`` for int64 tensors (or ints) holding uint32 values."""
    lo16 = b & 0xFFFF
    hi16 = (b >> 16) & 0xFFFF
    return (a * lo16 + (((a * hi16) & 0xFFFF) << 16)) & MASK32


def u32(x):
    """Reinterpret signed int64 values as their uint32 bit pattern."""
    return x & MASK32


def fmix32(x):
    """murmur3 finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def constants_np(dims: RaftDims):
    """``{lane: (c_ord [D] uint32, c_msg [W] uint32, seed int)}`` — the
    fixed-seed draw shared with the JAX package (same seed, same order)."""
    n, L = dims.n_servers, dims.max_log
    d_ordered = n * (7 + 2 * L) + 2 * n * n
    rng = np.random.RandomState(0x7A57)
    out = {}
    for lane in (0, 1):
        c_ord = rng.randint(0, 1 << 32, d_ordered,
                            dtype=np.uint64).astype(np.uint32) | 1
        c_msg = rng.randint(0, 1 << 32, dims.msg_width,
                            dtype=np.uint64).astype(np.uint32) | 1
        seed = int(rng.randint(1, 1 << 32, dtype=np.uint64) | 1) & MASK32
        out[lane] = (c_ord, c_msg, seed)
    return out


def constants(dims: RaftDims, device):
    """The constants as int64 tensors on ``device``."""
    return {lane: (torch.as_tensor(c.astype(np.int64), device=device),
                   torch.as_tensor(m.astype(np.int64), device=device), s)
            for lane, (c, m, s) in constants_np(dims).items()}


def flat_ordered(st: StateBatch) -> torch.Tensor:
    """[X, D] uint32 view of the server-indexed fields, fingerprint order."""
    x = st.term.shape[0]
    parts = [st.term, st.role, st.voted_for, st.log_term, st.log_val,
             st.log_len, st.commit, st.votes_resp, st.votes_gran,
             st.next_idx, st.match_idx]
    return u32(torch.cat([p.reshape(x, -1) for p in parts], 1))


def slot_hash(msg: torch.Tensor, c_msg: torch.Tensor, seed: int):
    """Per-slot row hash ``[..., M]`` of message rows ``[..., M, W]``."""
    s = mul32(u32(msg), c_msg).sum(-1) & MASK32
    return fmix32((mul32(fmix32(s ^ seed), 0x85EBCA6B) + seed) & MASK32)


def finalize(base, msum, seed: int):
    return fmix32((base + mul32(fmix32((msum + seed) & MASK32),
                                0x9E3779B9)) & MASK32)


def remap_sentinel(hi, lo):
    return torch.where((hi == SENTINEL) & (lo == SENTINEL),
                       torch.full_like(lo, 0xFFFFFFFE), lo)


def build_fingerprint(dims: RaftDims, device):
    """``fp(StateBatch [X]) -> (hi [X], lo [X])`` int64 tensors."""
    consts = constants(dims, device)

    def lane_hash(st, flat, lane):
        c_ord, c_msg, seed = consts[lane]
        base = fmix32((mul32(flat, c_ord) + seed) & MASK32).sum(1) & MASK32
        sh = slot_hash(st.msg, c_msg, seed)
        msum = torch.where(st.msg_cnt > 0, mul32(sh, u32(st.msg_cnt)),
                           torch.zeros_like(sh)).sum(1) & MASK32
        return finalize(base, msum, seed)

    def fingerprint(st: StateBatch):
        flat = flat_ordered(st)
        hi = lane_hash(st, flat, 0)
        lo = lane_hash(st, flat, 1)
        return hi, remap_sentinel(hi, lo)

    return fingerprint
