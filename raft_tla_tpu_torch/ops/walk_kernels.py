"""Walk primitives of the swarm and the simulator: a counter hash and
per-walk fingerprint rings.

The JAX package's ``ops/walk_kernels.py``, bit for bit.  Every decision
of a swarm walk is a pure function of ``(seed, walk, step, stream)``:
three chained murmur3 ``fmix32`` avalanches (the fingerprint's finalizer,
``ops/fingerprint.py``).  No state threads through the walks, so slicing
W walks into batches of any size never changes a walk's trajectory, and a
latched violation replays exactly.

Each walk dedups against a ring of its last R accepted fingerprint pairs,
probed before every step; empty slots hold the seen-set's all-ones
``SENTINEL`` pair, which no real fingerprint takes.  The Bloom filters are
the hunt observatory's (it only observes; nothing here feeds them back
into a decision).

PyTorch has no general uint32 arithmetic: values are int64 tensors (or
Python ints) in ``[0, 2^32)``, and each multiply goes through ``mul32``.
A seed, walk id or step of any width wraps to its low 32 bits first, as
the JAX package's ``astype(uint32)`` does.  Plain PyTorch throughout: the
JAX package has no Pallas kernel here either.
"""

from __future__ import annotations

import torch

from .fingerprint import MASK32, SENTINEL, fmix32, mul32

#: Decision streams: one odd salt per independent draw of a step, so the
#: successor choice and the restart root of one (walk, step) never
#: correlate.
CHOICE_STREAM = 0x9E3779B1      # which enabled action instance to take
ROOT_STREAM = 0x85EBCA77        # which root to restart onto
INIT_STREAM = 0x27D4EB2F        # the walk's very first root
FAMILY_STREAM = 0x165667B1      # the trace's family-subset mask


def _u32(x):
    """A Python int or an integer tensor as its low 32 bits (int64)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return int(x) & MASK32


def walk_key(seed, walk_id, stream):
    """The first two avalanches of ``walk_bits``: a walk's key on one
    stream, fixed for a run; each decision then folds in its step."""
    h = fmix32(mul32(_u32(seed), 0x85EBCA6B) ^ (stream & MASK32))
    return fmix32(h ^ mul32(_u32(walk_id), 0xC2B2AE35))


def walk_bits_at(key, step):
    """``walk_bits`` from a ``walk_key``: the step's avalanche."""
    return fmix32(key ^ mul32(_u32(step), 0x9E3779B9))


def walk_bits(seed, walk_id, step, stream):
    """Counter-hash bits in ``[0, 2^32)`` for one decision.  ``walk_id``
    and ``step`` may be tensors (one draw a lane: the family stream keys
    ``step`` on each lane's trace epoch); ``seed`` may be a Python int or
    a 0-d tensor (a device scalar under a CUDA graph)."""
    return walk_bits_at(walk_key(seed, walk_id, stream), step)


def masked_choice(bits, enabled):
    """Uniform index over the True lanes of ``enabled [..., G]`` from
    ``bits [...]``: rank = bits mod popcount, then the rank-th enabled lane.
    A row with no enabled lane gives lane 0; the caller gates its step."""
    cnt = torch.cumsum(enabled.to(torch.int64), -1)
    total = cnt[..., -1]
    rank = bits % total.clamp(min=1)
    return (cnt > rank.unsqueeze(-1)).to(torch.int8).argmax(-1)


def family_subset(bits, fam):
    """Per-lane keep-mask over instance lanes: instance ``g`` is preferred
    iff bit ``fam[g] mod 32`` of the lane's word is set (families past 32
    share bits)."""
    return ((bits.unsqueeze(-1) >> (fam % 32)) & 1) != 0


def preferred_choice(bits, enabled, preferred):
    """``masked_choice`` over ``enabled & preferred`` where that is
    non-empty, else over all of ``enabled``: the bias never stalls a walk
    that still has successors."""
    pref = enabled & preferred
    use = torch.where(pref.any(-1, keepdim=True), pref, enabled)
    return masked_choice(bits, use)


def ring_init(lanes: int, capacity: int, device="cpu"):
    """Fresh rings ``(ring_hi, ring_lo, pos)``, every slot the sentinel."""
    full = torch.full((lanes, capacity), SENTINEL, dtype=torch.int64,
                      device=device)
    return full, full.clone(), torch.zeros(lanes, dtype=torch.int64,
                                           device=device)


def ring_probe(ring_hi, ring_lo, hi, lo):
    """Per lane: is (hi, lo) among the lane's last R accepted pairs?"""
    return ((ring_hi == hi.unsqueeze(1))
            & (ring_lo == lo.unsqueeze(1))).any(1)


def ring_push(ring_hi, ring_lo, pos, hi, lo, do):
    """Write (hi, lo) at each lane's cursor where ``do``; a cursor moves
    only on a push, so a stalled walk evicts nothing."""
    slot = pos % ring_hi.shape[1]
    at = ((torch.arange(ring_hi.shape[1], device=ring_hi.device)
           == slot.unsqueeze(1)) & do.unsqueeze(1))
    return (torch.where(at, hi.unsqueeze(1), ring_hi),
            torch.where(at, lo.unsqueeze(1), ring_lo),
            pos + do.to(pos.dtype))


def ring_reset(ring_hi, ring_lo, pos, mask):
    """The rings of lanes in ``mask`` back to the sentinel (a restart
    begins a fresh trace; dedup is per trace)."""
    m = mask.unsqueeze(1)
    return (torch.where(m, SENTINEL, ring_hi),
            torch.where(m, SENTINEL, ring_lo),
            torch.where(mask, 0, pos))


# -- the hunt observatory's Bloom filters ----------------------------------

def bloom_init(cells: int, device="cpu"):
    """One empty filter of ``cells`` uint8 slots, a power of two."""
    if cells & (cells - 1) or cells < 2:
        raise ValueError(f"bloom cells must be a power of two, "
                         f"got {cells}")
    return torch.zeros(cells, dtype=torch.uint8, device=device)


def bloom_probes(bloom, hi, lo):
    """The two probe indices of (hi, lo): the low bits of each lane."""
    m = bloom.shape[0] - 1
    return hi & m, lo & m


def bloom_probe(bloom, hi, lo):
    """True iff both probe cells are set."""
    i1, i2 = bloom_probes(bloom, hi, lo)
    return (bloom[i1] > 0) & (bloom[i2] > 0)


def bloom_push(bloom, hi, lo, do):
    """Insert the lanes where ``do`` (a scatter-max: duplicate indices in
    one call commute)."""
    i1, i2 = bloom_probes(bloom, hi, lo)
    m = do.to(torch.uint8)
    return (bloom.scatter_reduce(0, i1, m, "amax")
            .scatter_reduce(0, i2, m, "amax"))
