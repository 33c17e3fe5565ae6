"""The seen-state set: an open-addressing table of 64-bit fingerprints.

The JAX package's ``ops/fpset.py`` keeps two uint32 arrays ``(hi, lo)``;
here the table is ONE int64 array of packed keys ``(hi << 32) | lo`` (the
bit pattern of the unsigned key), so the CUDA insert can claim a slot with
a single 64-bit ``atomicCAS``.  The all-ones key (-1 as int64) is the
empty slot, the JAX package's SENTINEL pair.  ``to_host_keys`` and
``from_host_keys`` convert to and from the JAX ``(hi, lo)`` form exactly.

Probe chains are the JAX package's bit for bit: ``_probe_base``'s double
hash, ``slot_r = (h1 + r * h2) & (C - 1)`` advancing only past slots held
by another key, at most ``PROBE_ROUNDS`` probes; a query unresolved after
that raises the insert's ``fail`` flag, and the engine stops rather than
drop a state.

The table is updated in place: the insert writes into ``FPSet.keys`` and
adds its new keys to ``FPSet.size`` (a [1] int64 tensor on the table's
device), so a table never exists twice on the card.  ``owner`` is the
CUDA insert's per-slot scratch (all ``NO_OWNER`` between calls; None on
the CPU, whose insert is the sequential plain version).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .compact import pow2
from .fingerprint import MASK32, fmix32

PROBE_ROUNDS = 32
EMPTY = -1                  # the all-ones key as int64
NO_OWNER = 0x7FFFFFFF


class FPSet(NamedTuple):
    keys: torch.Tensor               # [C] int64 packed keys, EMPTY = free
    size: torch.Tensor               # [1] int64 stored keys
    owner: Optional[torch.Tensor]    # [C] int32 CUDA scratch, or None

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def empty(capacity: int, device) -> FPSet:
    c = pow2(capacity)
    if c > 1 << 31:
        raise ValueError(f"seen capacity {c} exceeds 2^31 slots")
    device = torch.device(device)
    owner = (torch.full((c,), NO_OWNER, dtype=torch.int32, device=device)
             if device.type == "cuda" else None)
    return FPSet(keys=torch.full((c,), EMPTY, dtype=torch.int64,
                                 device=device),
                 size=torch.zeros(1, dtype=torch.int64, device=device),
                 owner=owner)


def clear(s: FPSet) -> None:
    """Empty ``s`` in place, as ``empty`` makes a table of its capacity:
    every slot free, the size 0, the owner scratch all ``NO_OWNER``."""
    s.keys.fill_(EMPTY)
    s.size.zero_()
    if s.owner is not None:
        s.owner.fill_(NO_OWNER)


def pack(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 tensors holding uint32 lanes -> int64 packed keys."""
    hs = torch.where(hi >= 1 << 31, hi - (1 << 32), hi)
    return hs * (1 << 32) + lo


def unpack(keys: torch.Tensor):
    return (keys >> 32) & MASK32, keys & MASK32


def probe_base(qhi, qlo, c: int):
    """``(h1, h2)`` of the double hash; h2 is odd, so a power-of-two
    table is walked in a full cycle."""
    h1 = fmix32(qhi ^ fmix32(qlo ^ 0x9E3779B9))
    h2 = fmix32(qlo ^ fmix32(qhi ^ 0x85EBCA6B)) | 1
    return h1 & (c - 1), h2


def to_host_keys(s: FPSet) -> Tuple[np.ndarray, np.ndarray]:
    """Stored keys as uint32 ``(hi, lo)`` numpy arrays, lex-sorted — the
    JAX package's ``to_host_keys`` layout."""
    keys = s.keys.cpu().numpy()
    keys = keys[keys != EMPTY].view(np.uint64)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(MASK32)).astype(np.uint32)
    order = np.lexsort((lo, hi))
    return hi[order], lo[order]


def _rebuild(keys: torch.Tensor, capacity: int, device,
             chunk: int) -> FPSet:
    from .fpset_cuda import insert
    s = empty(capacity, device)
    for base in range(0, keys.shape[0], chunk):
        q = keys[base:base + chunk]
        _new, fail = insert(
            s, q, torch.ones(q.shape, dtype=torch.bool, device=q.device))
        if bool(fail):
            raise RuntimeError(f"seen-set rebuild overflow: {keys.shape[0]} "
                               f"keys into capacity {capacity}")
    return s


def from_host_keys(keys_hi: np.ndarray, keys_lo: np.ndarray,
                   capacity: int, device, chunk: int = 1 << 20) -> FPSet:
    """A table on ``device`` holding the given distinct keys (the output
    of the JAX package's ``to_host_keys``), rebuilt through the insert."""
    hi = torch.as_tensor(np.asarray(keys_hi, np.uint32).astype(np.int64))
    lo = torch.as_tensor(np.asarray(keys_lo, np.uint32).astype(np.int64))
    return _rebuild(pack(hi, lo).to(device), capacity, device, chunk)


def grow(s: FPSet, capacity: int, chunk: int = 1 << 20) -> FPSet:
    """Rehash ``s`` into a new table of ``capacity`` slots on its device."""
    keys = s.keys[s.keys != EMPTY]
    return _rebuild(keys, capacity, s.keys.device, chunk)


def contains(s: FPSet, keys: torch.Tensor) -> torch.Tensor:
    """[K] bool: which packed ``keys`` the table holds, a read-only probe
    along the insert's probe chains; EMPTY (sentinel) keys report False.
    The JAX package's ``contains`` is an XLA lowering, not a kernel, so
    this plain probe is its port; it makes no host read."""
    c = s.capacity
    qhi, qlo = unpack(keys)
    h1, h2 = probe_base(qhi, qlo, c)
    found = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    open_ = keys != EMPTY
    for r in range(PROBE_ROUNDS):
        cur = s.keys.index_select(0, (h1 + r * h2) & (c - 1))
        found = found | (open_ & (cur == keys))
        open_ = open_ & (cur != EMPTY) & ~found
    return found
