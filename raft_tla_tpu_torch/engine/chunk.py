"""The per-batch BFS pipeline body (v3 and v4 plans, one device).

One batch: B rows off the level queue -> guards-only masks over the B*G
lanes (``models/actions2.py``) -> compaction of the enabled lanes to K
slots (kernel) -> delta fingerprints and sparse successors on the K lanes
-> constraint, invariant id and packed rows -> the tail -> the counters
the host reads, packed into ONE int64 tensor so a batch costs one
device-to-host copy.  On the v4 plan everything before the tail is one
front call (``ops/chunk_front_cuda.py``).  With a POR table the masks are
reduced before compaction (one certified lane kept per state,
``ops/chunk_front.py por_keep``; inside the front kernel on v4).

The tail is either the fused insert + enqueue kernel
(``ops/fused_tail_cuda.py``) or split: the seen-set insert kernel
(``ops/fpset_cuda.py``), then ``enq = new & cons_ok`` through the enqueue
kernel (``ops/enqueue_cuda.py``) or one of the PyTorch lowerings of
``ops/enqueue.py``.  Both give the same ``new``, queue rows and count.

The same body as the JAX package's ``engine/chunk.py`` on its v2 and
fused-front branches with either tail, so every counter, the queue rows
and the trace links are equal to the JAX engines'.  Stats layout:
``STAT_*`` offsets, then per family the generated, the novel and the
POR-pruned counts.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.invariants import build_inv_id
from ..models.schema import flatten_state, gather_states, unflatten_state
from ..ops import compact as compact_mod
from ..ops.chunk_front import FrontOut, por_keep
from ..ops.compact_cuda import compact
from ..ops.enqueue import enqueue_scatter, enqueue_window
from ..ops.enqueue_cuda import enqueue
from ..ops.fpset import pack
from ..ops.fpset_cuda import insert
from ..ops.fused_tail_cuda import insert_enqueue
from ..ops.pipeline_v3 import ENQUEUE_METHODS

(STAT_P, STAT_TOTAL, STAT_NEW, STAT_COUNT, STAT_OVF, STAT_DEAD, STAT_VIOL,
 STAT_VINV, STAT_VPOS, STAT_DPOS, STAT_FAIL, STAT_EXPANDED,
 STAT_SEEN) = range(13)
N_SCALARS = 13


class BatchOut(NamedTuple):
    stats: torch.Tensor          # [13 + 3F] int64 (see STAT_*)
    new: torch.Tensor            # [K] bool novel lanes
    kh: torch.Tensor             # [K] fingerprint lanes
    kl: torch.Tensor
    krows: torch.Tensor          # [K, sw] successor rows
    parent_hi: Optional[torch.Tensor]   # [K], with trace recording only
    parent_lo: Optional[torch.Tensor]
    actions: torch.Tensor        # [K] int64 grid instance per lane


def build_chunk_body(*, dims, v2, inv_fns, constraint, B: int, K: int,
                     record_trace: bool, device, front=None,
                     enqueue_method: str = "fused", Q: int = 0,
                     por_mask=None, por_priority=None):
    """Returns ``body(rows, valid, seen, qnext, next_count) -> BatchOut``.

    ``rows`` [B, sw] uint8 parents, ``valid`` [B] bool; the tail writes
    the enqueued successors into ``qnext`` from row ``next_count`` on and
    grows ``seen`` in place.  ``front`` (the v4 plan's
    ``ops/chunk_front_cuda.py`` ``Front``, built for the same predicates
    and POR arrays) replaces the masks, compaction and lane stages with
    one front call.  ``enqueue_method`` picks the tail ("fused", or split
    with "kernel", "scatter", "window"); "scatter" needs ``Q``, the first
    of its K trash rows.  ``por_mask`` [G] bool and ``por_priority`` [G]
    int32 tensors on ``device`` (both or neither) turn the reduction on."""
    if enqueue_method not in ENQUEUE_METHODS:
        raise ValueError(f"enqueue_method must be one of {ENQUEUE_METHODS}, "
                         f"got {enqueue_method!r}")
    if (por_mask is None) != (por_priority is None):
        raise ValueError("por_mask and por_priority must be given together")
    G = dims.n_instances
    if por_mask is not None:
        if por_mask.shape != (G,) or por_priority.shape != (G,):
            raise ValueError(
                f"POR mask/priority must be [{G}] (the action-instance "
                f"grid), got {tuple(por_mask.shape)} / "
                f"{tuple(por_priority.shape)}")
        if por_mask.dtype != torch.bool or por_priority.dtype != torch.int32:
            raise ValueError(f"POR mask/priority must be bool/int32, got "
                             f"{por_mask.dtype} / {por_priority.dtype}")
    kspr = compact_mod.kspread(B, G, K, device)
    inv_id = build_inv_id(inv_fns) if inv_fns else None
    fam_np = np.zeros(G, np.int64)
    for f, (off, sz) in enumerate(zip(dims.family_offsets,
                                      dims.family_sizes)):
        fam_np[off:off + sz] = f
    fam_of_g = torch.as_tensor(fam_np, device=device)
    F = len(dims.family_sizes)
    arange_b = torch.arange(B, device=device)
    no_pruned = torch.zeros(F, dtype=torch.int64, device=device)

    def split_front(rows, valid):
        states = unflatten_state(rows, dims)
        en, ovf = v2.masks(states)
        en = en & valid[:, None]
        ovf = ovf & valid[:, None]
        pruned = None
        if por_mask is not None:
            # One certified enabled lane kept per state, its siblings
            # masked before compaction; a state with none is untouched.
            keep = por_keep(en, por_mask, por_priority)
            pruned = en & ~keep
            en = en & keep
            ovf = ovf & keep

        # Progress limiting + compaction: the longest parent prefix whose
        # fan-out fits K, its enabled lanes in ascending flat order.
        pt, lane_id, kvalid = compact(en.contiguous(), K, kspr)
        ptaken = arange_b < pt[0]
        en = en & ptaken[:, None]
        ovf = ovf & ptaken[:, None]

        # Successors for the K compacted lanes only: parents' hash sums
        # plus per-lane deltas (models/actions2.py).
        lane = lane_id.to(torch.int64)
        pidx = lane // G
        ph = v2.parent_hash(states)
        kparents = gather_states(states, pidx)
        kph = type(ph)(*(f.index_select(0, pidx) for f in ph))
        kh, kl, kstates = v2.lane_out(kparents, kph, lane % G)
        if constraint is not None:
            cons_ok = constraint(kstates)
        else:
            cons_ok = torch.ones(K, dtype=torch.bool, device=device)
        krows = flatten_state(kstates)
        if inv_id is not None:
            inv = inv_id(kstates)
        else:
            inv = torch.full((K,), -1, dtype=torch.int64, device=device)
        parent_hi = parent_lo = None
        if record_trace:
            php, plp = v2.parent_fp(ph)
            parent_hi, parent_lo = php[pidx], plp[pidx]
        return FrontOut(en=en, ovf=ovf, pruned=pruned, P=pt[0], total=pt[1],
                        lane_id=lane_id, kvalid=kvalid, kh=kh, kl=kl,
                        krows=krows, cons_ok=cons_ok, inv=inv,
                        parent_hi=parent_hi, parent_lo=parent_lo)

    run_front = front or split_front

    def body(rows, valid, seen, qnext, next_count: int) -> BatchOut:
        # en/ovf arrive progress-limited; P and total stay on the device.
        # pruned is the front's before the progress limit.
        (en, ovf, pruned, P, total, lane_id, kvalid, kh, kl, krows,
         cons_ok, inv, parent_hi, parent_lo) = run_front(rows, valid)
        P = P.to(torch.int64)
        ptaken = arange_b < P
        act = lane_id.to(torch.int64) % G
        if not record_trace:
            parent_hi = parent_lo = None

        dead_b = valid & ptaken & ~en.any(1) & ~ovf.any(1)
        keys = pack(kh, kl)
        if enqueue_method == "fused":
            new, fail, count = insert_enqueue(seen, keys, kvalid, krows,
                                              cons_ok, qnext, next_count)
        else:
            # The constraint and the rows depend only on the candidates,
            # so every value below equals the fused branch's.
            new, fail = insert(seen, keys, kvalid)
            enq = new & cons_ok
            if enqueue_method == "kernel":
                count = enqueue(qnext, next_count, krows, enq)
            elif enqueue_method == "scatter":
                count = enqueue_scatter(qnext, next_count, krows, enq, Q)
            else:
                count = enqueue_window(qnext, next_count, krows, enq)
        viol = new & (inv >= 0)
        vpos = viol.to(torch.int32).argmax()
        # Indexing with a 0-dim device tensor reads it on the host; a
        # one-element index keeps the dispatch free of device waits.
        vinv = inv.index_select(0, vpos.view(1))[0]

        fam_counts = torch.zeros(F, dtype=torch.int64, device=device)
        fam_counts.index_add_(0, fam_of_g, en.sum(0))
        fam_new = torch.zeros(F, dtype=torch.int64, device=device)
        fam_new.index_add_(0, fam_of_g[act], new.to(torch.int64))
        fam_pruned = no_pruned
        if por_mask is not None:
            # Counted for the parents this batch advanced past only.
            fam_pruned = torch.zeros(F, dtype=torch.int64, device=device)
            fam_pruned.index_add_(0, fam_of_g,
                                  (pruned & ptaken[:, None]).sum(0))
        scalars = torch.stack([
            P, total.to(torch.int64), new.sum(), count.to(torch.int64),
            ovf.sum(), dead_b.any().to(torch.int64),
            viol.any().to(torch.int64), vinv, vpos,
            dead_b.to(torch.int32).argmax(), fail.to(torch.int64),
            (valid & ptaken).sum(), seen.size[0]])
        stats = torch.cat([scalars, fam_counts, fam_new, fam_pruned])
        return BatchOut(stats=stats, new=new, kh=kh, kl=kl, krows=krows,
                        parent_hi=parent_hi, parent_lo=parent_lo,
                        actions=act)

    return body
