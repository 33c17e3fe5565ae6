"""Candidate-lane compaction sizes and the dead-slot spread vector.

The chunk's [B, G] enabled mask is compacted to K lanes before the
fingerprint insert, row construction, invariant/constraint evaluation and
enqueue (``ops/compact_cuda.py`` holds the kernel and its plain version).
Invariants, as in the JAX package's ``ops/compact.py``:

- ``K`` is a power of two and ``K >= G``, so one parent's worst-case
  fan-out always fits and a batch always makes progress (``P >= 1``);
- progress limiting: only the longest parent prefix whose fan-out fits K
  is taken, and the caller advances its queue offset by ``P``;
- dead compacted slots hold ``kspread``, the same vector the JAX lowerings
  use, so ``lane_id`` is equal to theirs slot for slot;
- shared P (the mesh, ``parallel/mesh.py``): every shard advances by the
  least P over the shards, the JAX compactor's ``reduce_p=pmin``.  The
  kernel runs unchanged on each shard and ``cap_prefix`` cuts its output
  to the first P parents' lanes: they are a prefix of it, because the
  lanes come in ascending flat order.

``build_compactor`` is the JAX package's entry point of the same name
and the chunk's compaction stage: the JAX lowerings "scatter" and
"searchsorted" give identical outputs there, and both are the plan's
compaction here (``ops/compact_cuda.py``: the kernel on the card, its
plain version on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch


def pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def choose_k(B: int, G: int, requested=None) -> int:
    """Compacted-lane count: the requested value or 16 lanes per parent,
    floored at ``max(G, B)``, rounded up to a power of two and capped at
    ``pow2(B * G)``."""
    k = requested
    if k is None:
        k = min(16 * B, B * G)
    return min(pow2(max(k, G, B)), pow2(B * G))


def inv_positions(mask: torch.Tensor, out_len: int) -> torch.Tensor:
    """Invert a boolean mask's compaction map: ``result[k]`` is the index
    of the (k+1)-th True lane for ``k < mask.sum()``, clipped into range
    past that (callers gate the dead slots).  [out_len] int64; the JAX
    package's ``ops/compact.py inv_positions``, used by the "window"
    enqueue lowering."""
    cum = mask.to(torch.int64).cumsum(0)
    q = torch.arange(1, out_len + 1, dtype=torch.int64, device=mask.device)
    return torch.searchsorted(cum, q).clamp_(0, mask.shape[0] - 1)


def kspread(B: int, G: int, K: int, device) -> torch.Tensor:
    """[K] int32 hash-spread addresses for dead compacted slots."""
    v = (np.arange(K, dtype=np.int64) * 2654435761) % (B * G)
    return torch.as_tensor(v.astype(np.int32), device=device)


def cap_prefix(P: torch.Tensor, G: int, lane_id: torch.Tensor,
               kvalid: torch.Tensor, kspread: torch.Tensor):
    """A compaction of P' >= P parents cut to the first ``P`` (a [1]
    int64 device tensor): ``(total [1] int64, lane_id, kvalid)`` equal to
    the compaction of those P parents alone.  Elementwise, with no host
    read."""
    kvalid = kvalid & (lane_id.to(torch.int64) < P * G)
    return (kvalid.sum().view(1), torch.where(kvalid, lane_id, kspread),
            kvalid)


#: The JAX package's compaction lowerings; both map to the plan's one.
COMPACT_METHODS = ("scatter", "searchsorted")


def build_compactor(B: int, G: int, K: int, reduce_p=None,
                    method: str = "scatter", device="cuda"):
    """``compact(en) -> (P, total, lane_id, kvalid)`` of a [B, G] enabled
    mask on ``device``, the JAX ``build_compactor``'s contract and the
    chunk's compaction stage (``engine/chunk.py``): P the parents taken,
    ``total`` the live lanes (0-d int32 tensors), ``lane_id`` [K] int32
    the flat lanes in ascending order (``kspread`` in the dead slots),
    ``kvalid`` [K] bool.  ``reduce_p`` (a function of the 0-d P) reduces
    P before it applies, as the JAX mesh's least P over the shards does;
    the lanes are then cut to it (``cap_prefix``).  Both ``method``
    values give the one compaction; another raises, as in the JAX
    package."""
    from .compact_cuda import compact
    if method not in COMPACT_METHODS:
        raise ValueError(f"unknown compactor method {method!r}")
    kspr = kspread(B, G, K, device)

    def compactor(en):
        pt, lane_id, kvalid = compact(en.contiguous(), K, kspr)
        P, total = pt[0], pt[1]
        if reduce_p is not None:
            P = reduce_p(P)
            total, lane_id, kvalid = cap_prefix(P, G, lane_id, kvalid, kspr)
            total = total[0]
        return P, total, lane_id, kvalid

    return compactor
