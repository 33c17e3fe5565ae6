"""The BFS chunk (v3 and v4 plans, one device): one batch, and the step
that runs it on device-resident counters.

One batch: B rows off the level queue -> guards-only masks over the B*G
lanes (``models/actions2.py``) -> compaction of the enabled lanes to K
slots (kernel) -> delta fingerprints and sparse successors on the K lanes
-> constraint, invariant id and packed rows -> the tail -> the batch's
counters.  On the v4 plan everything before the tail is one front call
(``ops/chunk_front_cuda.py``).  With a POR table the masks are reduced
before compaction (one certified lane kept per state,
``ops/chunk_front.py por_keep``; inside the front kernel on v4).

The tail is either the fused insert + enqueue kernel
(``ops/fused_tail_cuda.py``) or split: the seen-set insert kernel
(``ops/fpset_cuda.py``), then ``enq = new & cons_ok`` through the enqueue
kernel (``ops/enqueue_cuda.py``) or one of the PyTorch lowerings of
``ops/enqueue.py``.  Both give the same ``new``, queue rows and count.

``ChunkStep`` runs one batch on a ``ChunkState``, a few device tensors
that hold what the JAX package's device ``while_loop`` carries
(``engine/bfs.py`` ``chunk``): the queue offset, the step and queue
counts, the trace count and the chunk's accumulated counters, in the
JAX package's packed-stats layout (``ST_*``, then per family the
generated, the novel and the POR-pruned counts), followed by control
words: two the host writes before a chunk, the level's row count and the
step limit, and the cond after the chunk's last step.  The step first evaluates the loop's ``cond`` on the card; a
batch whose cond is false is still dispatched but changes nothing.  So
the host can queue up to ``sync_every`` steps (``engine/bfs.py``
captures one as a CUDA graph and replays it) and read the state once.
The batch's rows are gathered from the level queue at the device offset
by one ``index_select`` launch rather than read by the front at that
offset: the gather serves the v3 plan's PyTorch front and the v4 front
kernel alike and leaves the kernel's [B, sw] input as it was, for B rows
(7.8 MB at TPUraft's batch, a few microseconds of a ~1.5 ms batch).  The
tails take the queue count by device pointer.  The trace records of the
batch's new states (child and parent fingerprint halves, action: five
int32, a 20-byte row) are appended in lane order to a device trace
buffer through the enqueue kernel, which already appends rows of any
width exactly (a scatter would need K trash rows and a scan of its
own); the host drains the buffer once a chunk.

The same body as the JAX package's ``engine/chunk.py`` on its v2 and
fused-front branches with either tail, so every counter, the queue rows
and the trace links are equal to the JAX engines'.  The body is built of
stage functions (``ChunkStages``): ``build_chunk_body`` composes them
into one call, and the mesh (``parallel/mesh.py``) interleaves them
across its shards around the shared P and the routed insert, as the JAX
mesh passes its ``compactor`` and ``insert_fn`` to the same body.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

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

# The chunk state's int32 words: the JAX package's packed chunk stats
# (engine/bfs.py ``chunk``), then 3F family counts, then three control
# words: the level's rows and the step limit, which the host writes, and
# the cond after the chunk's last step (``ChunkStep.CUR`` + 0, 1, 2).
(ST_OFFSET, ST_STEPS, ST_COUNT, ST_SEEN, ST_TCOUNT, ST_GEN, ST_NEW, ST_OVF,
 ST_DEAD, ST_VIOL, ST_VINV, ST_FAIL, ST_EXPANDED) = range(13)
N_SCALARS = 13

#: Bytes of one trace record: child hi, lo, parent hi, lo, action (int32).
TRACE_ROW = 20


def state_words(n_families: int) -> int:
    """Length of ``ChunkState.st``."""
    return N_SCALARS + 3 * n_families + 3


class BatchOut(NamedTuple):
    delta: torch.Tensor          # [13 + 3F] int64, the ST_* increments
    new: torch.Tensor            # [K] bool novel lanes
    kh: torch.Tensor             # [K] fingerprint lanes
    kl: torch.Tensor
    krows: torch.Tensor          # [K, sw] successor rows
    parent_hi: Optional[torch.Tensor]   # [K], with trace recording only
    parent_lo: Optional[torch.Tensor]
    actions: torch.Tensor        # [K] int64 grid instance per lane
    count: torch.Tensor          # [] int32 queue count after the tail
    inv: torch.Tensor            # [K] int64 violated invariant or -1
    viol: torch.Tensor           # [K] bool new & violating
    dead: torch.Tensor           # [B] bool deadlocked parents


class ChunkStages(NamedTuple):
    """The batch's stages, which ``build_chunk_body`` composes into one
    call and the mesh (``parallel/mesh.py``) interleaves across shards:

    - ``masks(rows, valid) -> (states, en, ovf, pruned)``: the guards-only
      masks of the valid rows, POR-reduced with a table (``pruned`` the
      lanes it dropped, else None);
    - ``compact(en) -> (pt, lane_id, kvalid)``: the compaction kernel;
    - ``lanes(states, lane_id) -> (kh, kl, krows, cons_ok, inv,
      parent_hi, parent_lo)``: fingerprints, rows, constraint, invariant
      id and (with trace recording) parent fingerprints of the K lanes;
    - ``front(rows, valid) -> FrontOut``: the three above with the
      progress limit, or the v4 front's one call;
    - ``enqueue(qnext, next_count, krows, enq, max_count) -> count``: the
      split tail's append;
    - ``tail(seen, keys, kvalid, krows, cons_ok, qnext, next_count,
      max_count) -> (new, fail, count)``: the fused or the split tail;
    - ``finish(valid, front_out, new, fail, count) -> BatchOut``: the
      batch's counters."""

    masks: Callable
    compact: Callable
    lanes: Callable
    front: Callable
    enqueue: Callable
    tail: Callable
    finish: Callable


def build_chunk_stages(*, dims, v2, inv_fns, constraint, B: int, K: int,
                       record_trace: bool, device, front=None,
                       enqueue_method: str = "fused", Q: int = 0,
                       por_mask=None, por_priority=None) -> ChunkStages:
    """The ``ChunkStages`` of one plan (see ``build_chunk_body``)."""
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
    zero = torch.zeros(1, dtype=torch.int64, device=device)
    one = torch.ones(1, dtype=torch.int64, device=device)

    def masks(rows, valid):
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
        return states, en, ovf, pruned

    def compact_en(en):
        return compact(en.contiguous(), K, kspr)

    def lanes(states, lane_id):
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
        krows = flatten_state(kstates, dims)
        if inv_id is not None:
            inv = inv_id(kstates)
        else:
            inv = torch.full((K,), -1, dtype=torch.int64, device=device)
        parent_hi = parent_lo = None
        if record_trace:
            php, plp = v2.parent_fp(ph)
            parent_hi, parent_lo = php[pidx], plp[pidx]
        return kh, kl, krows, cons_ok, inv, parent_hi, parent_lo

    def split_front(rows, valid):
        states, en, ovf, pruned = masks(rows, valid)
        # Progress limiting + compaction: the longest parent prefix whose
        # fan-out fits K, its enabled lanes in ascending flat order.
        pt, lane_id, kvalid = compact_en(en)
        ptaken = arange_b < pt[0]
        en = en & ptaken[:, None]
        ovf = ovf & ptaken[:, None]
        kh, kl, krows, cons_ok, inv, parent_hi, parent_lo = lanes(states,
                                                                  lane_id)
        return FrontOut(en=en, ovf=ovf, pruned=pruned, P=pt[0], total=pt[1],
                        lane_id=lane_id, kvalid=kvalid, kh=kh, kl=kl,
                        krows=krows, cons_ok=cons_ok, inv=inv,
                        parent_hi=parent_hi, parent_lo=parent_lo)

    def enqueue_split(qnext, next_count, krows, enq, max_count):
        if enqueue_method == "scatter":
            return enqueue_scatter(qnext, next_count, krows, enq, Q)
        if enqueue_method == "window":
            return enqueue_window(qnext, next_count, krows, enq)
        return enqueue(qnext, next_count, krows, enq, max_count)

    def tail(seen, keys, kvalid, krows, cons_ok, qnext, next_count,
             max_count):
        if enqueue_method == "fused":
            return insert_enqueue(seen, keys, kvalid, krows, cons_ok, qnext,
                                  next_count, max_count)
        # The constraint and the rows depend only on the candidates, so
        # every value below equals the fused branch's.
        new, fail = insert(seen, keys, kvalid)
        return new, fail, enqueue_split(qnext, next_count, krows,
                                        new & cons_ok, max_count)

    def finish(valid, fo: FrontOut, new, fail, count) -> BatchOut:
        # en/ovf arrive progress-limited; P and total stay on the device.
        # pruned is the front's before the progress limit.
        P = fo.P.to(torch.int64)
        ptaken = arange_b < P
        act = fo.lane_id.to(torch.int64) % G
        en, ovf = fo.en, fo.ovf
        dead_b = valid & ptaken & ~en.any(1) & ~ovf.any(1)
        viol = new & (fo.inv >= 0)
        fam_counts = torch.zeros(F, dtype=torch.int64, device=device)
        fam_counts.index_add_(0, fam_of_g, en.sum(0))
        fam_new = torch.zeros(F, dtype=torch.int64, device=device)
        fam_new.index_add_(0, fam_of_g[act], new.to(torch.int64))
        fam_pruned = no_pruned
        if por_mask is not None:
            # Counted for the parents this batch advanced past only.
            fam_pruned = torch.zeros(F, dtype=torch.int64, device=device)
            fam_pruned.index_add_(0, fam_of_g,
                                  (fo.pruned & ptaken[:, None]).sum(0))
        # The ST_* increments: ST_COUNT, ST_SEEN, ST_TCOUNT and ST_VINV
        # are set, not added, by the step.
        delta = torch.cat([
            P.view(1), one, zero, zero, zero,
            fo.total.to(torch.int64).view(1), new.sum().view(1),
            ovf.sum().view(1), dead_b.any().to(torch.int64).view(1),
            viol.any().to(torch.int64).view(1), zero,
            fail.to(torch.int64).view(1),
            (valid & ptaken).sum().view(1), fam_counts, fam_new,
            fam_pruned])
        parent_hi, parent_lo = ((fo.parent_hi, fo.parent_lo)
                                if record_trace else (None, None))
        return BatchOut(delta=delta, new=new, kh=fo.kh, kl=fo.kl,
                        krows=fo.krows, parent_hi=parent_hi,
                        parent_lo=parent_lo, actions=act, count=count,
                        inv=fo.inv, viol=viol, dead=dead_b)

    return ChunkStages(masks=masks, compact=compact_en, lanes=lanes,
                       front=front or split_front, enqueue=enqueue_split,
                       tail=tail, finish=finish)


def build_chunk_body(*, dims, v2, inv_fns, constraint, B: int, K: int,
                     record_trace: bool, device, front=None,
                     enqueue_method: str = "fused", Q: int = 0,
                     por_mask=None, por_priority=None):
    """Returns ``body(rows, valid, seen, qnext, next_count, max_count) ->
    BatchOut``.

    ``rows`` [B, sw] uint8 parents, ``valid`` [B] bool; the tail writes
    the enqueued successors into ``qnext`` from row ``next_count`` on (a
    host int, or an int32 device tensor holding at most ``max_count``) and
    grows ``seen`` in place.  ``front`` (the v4 plan's
    ``ops/chunk_front_cuda.py`` ``Front``, built for the same predicates
    and POR arrays) replaces the masks, compaction and lane stages with
    one front call.  ``enqueue_method`` picks the tail ("fused", or split
    with "kernel", "scatter", "window"); "scatter" needs ``Q``, the first
    of its K trash rows.  ``por_mask`` [G] bool and ``por_priority`` [G]
    int32 tensors on ``device`` (both or neither) turn the reduction on.
    The body's stages are ``body.stages`` (``ChunkStages``)."""
    stages = build_chunk_stages(
        dims=dims, v2=v2, inv_fns=inv_fns, constraint=constraint, B=B, K=K,
        record_trace=record_trace, device=device, front=front,
        enqueue_method=enqueue_method, Q=Q, por_mask=por_mask,
        por_priority=por_priority)

    def body(rows, valid, seen, qnext, next_count, max_count=None) \
            -> BatchOut:
        fo = stages.front(rows, valid)
        new, fail, count = stages.tail(seen, pack(fo.kh, fo.kl), fo.kvalid,
                                       fo.krows, fo.cons_ok, qnext,
                                       next_count, max_count)
        return stages.finish(valid, fo, new, fail, count)

    body.stages = stages
    return body


class ChunkState(NamedTuple):
    """The device state a chunk of steps runs on (see the module doc)."""

    st: torch.Tensor             # [state_words(F)] int32
    vrow: torch.Tensor           # [sw] uint8 first violating row
    vfp: torch.Tensor            # [2] int64 its fingerprint (hi, lo)
    drow: torch.Tensor           # [sw] uint8 first deadlocked parent


def chunk_state(n_families: int, sw: int, device) -> ChunkState:
    def z(n, dtype):
        return torch.zeros(n, dtype=dtype, device=device)
    return ChunkState(st=z(state_words(n_families), torch.int32),
                      vrow=z(sw, torch.uint8), vfp=z(2, torch.int64),
                      drow=z(sw, torch.uint8))


class ChunkStep:
    """One batch on a ``ChunkState``: ``step(qcur, seen, qnext, tbuf, cs)``.

    ``qcur`` holds the level's rows (``ST_CUR`` of them, the batch starts
    at ``ST_OFFSET``), ``qnext`` the next level's (``ST_COUNT``), ``tbuf``
    [TQ + K, 20] uint8 the trace records (``ST_TCOUNT``; a stub without
    trace recording).  The step runs only while ``cond`` holds, the JAX
    loop's: parents and steps left (``ST_MAX``), the queue at most ``QTH``
    rows, the seen set at most half full, no violation, overflow, probe
    failure or (when checked) deadlock yet, and room in the trace buffer
    for a batch.  Otherwise it leaves every tensor as it was.  The step
    makes no host wait.  ``body`` is the per-batch function of
    ``build_chunk_body``; the step looks it up on each call.  Its parts,
    ``cond``, ``window`` and ``update``, are what the mesh runs around
    the body's stages on each shard; there ``count_word`` names the word
    holding the shard's own row count, the level's largest in ``CUR``."""

    def __init__(self, *, dims, B: int, K: int, Q: int, QTH: int, TQ: int,
                 record_trace: bool, check_deadlock: bool, device,
                 count_word: Optional[int] = None, **body):
        self.body = build_chunk_body(dims=dims, B=B, K=K, Q=Q,
                                     record_trace=record_trace,
                                     device=device, **body)
        self.Q, self.TQ = Q, TQ
        self.record_trace = record_trace
        F = len(dims.family_sizes)
        self.N = N_SCALARS + 3 * F
        self.CUR = self.N
        self.count_word = self.CUR if count_word is None else count_word
        # cond as lhs <= rhs over these words (the first two against the
        # control words less one).
        idx = [ST_OFFSET, ST_STEPS, ST_COUNT, ST_VIOL, ST_OVF, ST_FAIL]
        lim = [QTH, 0, 0, 0]
        if check_deadlock:
            idx.append(ST_DEAD)
            lim.append(0)
        if record_trace:
            idx.append(ST_TCOUNT)
            lim.append(TQ - K)
        self._idx = torch.tensor(idx, dtype=torch.int64, device=device)
        self._lim = torch.tensor(lim, dtype=torch.int32, device=device)
        self._arange_b = torch.arange(B, device=device)

    def cond(self, seen, cs: ChunkState) -> torch.Tensor:
        """[1] bool: whether the next step runs a batch."""
        st = cs.st
        lhs = st.index_select(0, self._idx)
        rhs = torch.cat([st.narrow(0, self.CUR, 2) - 1, self._lim])
        return ((lhs <= rhs).all()
                & (seen.size <= seen.capacity // 2)[0]).view(1)

    def window(self, qcur, cs: ChunkState, a):
        """``(rows [B, sw], valid [B])``: the batch at the device offset,
        valid while ``a`` and within the level's rows."""
        st = cs.st
        off = st.narrow(0, ST_OFFSET, 1).to(torch.int64)
        at = off + self._arange_b
        rows = qcur.index_select(0, at.clamp(max=qcur.shape[0] - 1))
        valid = a & (at < st.narrow(0, self.count_word, 1))
        return rows, valid

    def update(self, out: BatchOut, rows, a, seen, tbuf, cs: ChunkState):
        """The batch's results into the state (nothing when ``a`` is
        false): the first violation and deadlock, the trace records, the
        counters."""
        st = cs.st
        N = self.N
        # First violation and first deadlock of the chunk win.
        vpos = out.viol.to(torch.int32).argmax().view(1)
        take_v = a & (st.narrow(0, ST_VIOL, 1) == 0) & out.viol.any()
        dpos = out.dead.to(torch.int32).argmax().view(1)
        take_d = a & (st.narrow(0, ST_DEAD, 1) == 0) & out.dead.any()
        st_vinv = st.narrow(0, ST_VINV, 1)
        st_vinv.copy_(torch.where(take_v, out.inv.index_select(0, vpos),
                                  st_vinv))
        cs.vrow.copy_(torch.where(take_v, out.krows.index_select(0, vpos)[0],
                                  cs.vrow))
        vfp = torch.cat([out.kh.index_select(0, vpos),
                         out.kl.index_select(0, vpos)])
        cs.vfp.copy_(torch.where(take_v, vfp, cs.vfp))
        cs.drow.copy_(torch.where(take_d, rows.index_select(0, dpos)[0],
                                  cs.drow))
        if self.record_trace:
            trows = torch.stack([out.kh, out.kl, out.parent_hi,
                                 out.parent_lo, out.actions], 1)
            trows = trows.to(torch.int32).view(torch.uint8)
            tc = enqueue(tbuf, st.narrow(0, ST_TCOUNT, 1), trows, out.new,
                         self.TQ)
            st.narrow(0, ST_TCOUNT, 1).copy_(tc.view(1))
        head = st.narrow(0, 0, N)
        head.add_((out.delta * a).to(torch.int32))
        st.narrow(0, ST_COUNT, 1).copy_(out.count.view(1))
        st.narrow(0, ST_SEEN, 1).copy_(seen.size)

    def __call__(self, qcur, seen, qnext, tbuf, cs: ChunkState) -> None:
        a = self.cond(seen, cs)
        rows, valid = self.window(qcur, cs, a)
        out = self.body(rows, valid, seen, qnext,
                        cs.st.narrow(0, ST_COUNT, 1), self.Q)
        self.update(out, rows, a, seen, tbuf, cs)
