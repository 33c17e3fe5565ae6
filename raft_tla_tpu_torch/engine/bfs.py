"""Single-device exhaustive BFS checker (the v3 and v4 plans).

The JAX package's ``engine/bfs.py`` ``BFSEngine`` trimmed to its level
loop: roots are invariant-checked on their unpacked encoding, ingested
through the seen-set insert, and each level is expanded batch by batch
through ``engine/chunk.py``.  What it keeps of the JAX engine:

- capacity rules: K compacted lanes (``ops/compact.py choose_k``), a
  seen table floored at 8·K keys, a next-level queue of Q >= K rows
  (rounded to a multiple of B) plus PAD = max(B, K) rows so the batch
  slice never runs off the end;
- the spill watermark: when more than Q - K rows wait in the next-level
  queue and the level has more to expand, the rows move to host memory
  (TLC's disk queue) and the queue restarts empty, so a batch entering at
  or below the watermark can never overflow;
- seen-set growth: past half full the table doubles by rehashing on its
  device (off the duration clock, recorded in ``growth_stalls``);
- ``replay``: walk the trace back to a root and re-run the successor
  function forward, matching each recorded child by fingerprint.

The JAX loop runs up to ``sync_every`` batches per host round trip in a
device ``while_loop``; this loop reads one packed stats tensor per batch.
``EngineResult.phases`` splits the wall time into the host's dispatch of
each batch, its wait for the device (``sync``) and its own bookkeeping.
``EngineConfig.pipeline`` picks the chunk's plan: "v3" (the default; the
masks and lane stages in PyTorch around the compaction kernel) or "v4"
(one front kernel, ``ops/chunk_front_cuda.py``).  ``enqueue_method`` picks
the tail: the fused insert + enqueue kernel (the default) or the split
tail, the insert kernel followed by the enqueue kernel or a PyTorch
lowering.  Every combination gives equal results.

Also the JAX engine's, in the same terms: level-boundary checkpoints in
its ``.npz`` format and ``run(resume=...)`` (``engine/checkpoint.py``; a
snapshot of either package resumes in the other), the TLCGet exit
budgets over distinct / generated / queue (checked after each batch,
where the JAX loop checks after each ``sync_every`` chunk), and the
partial-order reduction fed by a certified table (``analysis/por.py``;
``por=True`` would certify in process through the jaxpr analyzer, which
is not ported).  Progress lines, observability, OOM degradation, the
asynchronous and disk-backed spill and the native trace store are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..models.actions2 import ParentHash, build_v2
from ..models.dims import RaftDims
from ..models.invariants import build_inv_id
from ..models.pystate import PyState
from ..models.schema import (ROW_DTYPE, StateBatch, check_packable,
                             decode_state, encode_state, flatten_state,
                             gather_states, stack_states, state_width,
                             unflatten_state)
from ..analysis import por as por_mod
from ..ops import compact as compact_mod
from ..ops import fpset, pipeline_v3, pipeline_v4
from ..ops.chunk_front_cuda import Front
from ..ops.fingerprint import build_fingerprint
from ..ops.fpset import pack
from ..ops.fpset_cuda import insert
from ..utils.device import resolve_device
from . import checkpoint as ckpt_mod
from . import chunk as chunk_mod
from .trace import PyTraceStore

PLANS = {"v3": pipeline_v3, "v4": pipeline_v4}


def host_rows(rows: torch.Tensor) -> np.ndarray:
    """A host copy of queue rows (on the CPU, ``.numpy()`` alone would be
    a view of a buffer the loop is about to overwrite)."""
    return rows.to("cpu", copy=True).numpy()


@dataclasses.dataclass
class EngineConfig:
    batch: int = 256                 # parents expanded per batch
    queue_capacity: int = 1 << 16    # device rows of the next-level queue
    seen_capacity: int = 1 << 18     # initial seen-set slots (grows)
    check_deadlock: Optional[bool] = None  # None = TLC's default (on)
    record_trace: bool = True
    max_seconds: Optional[float] = None    # StopAfter duration budget
    max_diameter: Optional[int] = None     # StopAfter diameter budget
    pipeline: str = "v3"                   # chunk plan: "v3" or "v4"
    # The chunk's tail.  "fused": one insert + enqueue kernel (the JAX
    # plans' fused tail).  Split, the insert kernel and then: "kernel",
    # the enqueue kernel (JAX: enqueue_method="pallas" with
    # insert_method="pallas", or v3_force_stages={"insert": "xla"} on the
    # fused plans); "scatter" / "window", the PyTorch lowerings of the
    # JAX enqueue methods of those names.  One field where the JAX
    # package has three: the port has one insert.
    enqueue_method: str = "fused"
    # Further TLCGet budgets as (counter, threshold) pairs over "distinct"
    # / "generated" / "queue", checked after every batch; stop_reason
    # "<counter>_budget".  Duration and diameter ride the fields above.
    exit_conditions: tuple = ()
    # Level-boundary snapshots (engine/checkpoint.py): every
    # checkpoint_every levels, at most once per
    # checkpoint_interval_seconds, keeping the newest keep_checkpoints
    # (None or 0 = all).
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1
    checkpoint_interval_seconds: float = 0.0
    keep_checkpoints: Optional[int] = None
    # Partial-order reduction: a certified analysis/por.py PorTable or
    # the path of its artifact, admission-checked at engine build.
    # por=True (certify in process) needs the analyzer, not ported.
    por: bool = False
    por_table: Optional[object] = None


@dataclasses.dataclass
class Violation:
    invariant: str
    state: PyState
    fingerprint: int


@dataclasses.dataclass
class EngineResult:
    distinct: int = 0
    generated: int = 0
    diameter: int = 0
    levels: List[int] = dataclasses.field(default_factory=list)
    action_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    # Enabled lanes the POR mask dropped, per action family (all zero
    # with POR off), and the certified instances the run's table carried.
    action_pruned: Dict[str, int] = dataclasses.field(default_factory=dict)
    por_instances: int = 0
    violation: Optional[Violation] = None
    deadlock: Optional[PyState] = None
    stop_reason: str = "exhausted"
    wall_seconds: float = 0.0
    growth_stalls: List = dataclasses.field(default_factory=list)
    spills: int = 0
    batches: int = 0
    pipeline: str = "v3"
    fused_stages: Dict[str, str] = dataclasses.field(default_factory=dict)
    device: str = ""
    # Host wall seconds: "dispatch" (issuing a batch's work), "sync"
    # (waiting for the device at the per-batch stats read), "host" (the
    # loop's own bookkeeping: trace, spill, growth, uploads),
    # "checkpoint" (snapshot writes).
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def states_per_second(self) -> float:
        return self.distinct / self.wall_seconds if self.wall_seconds else 0.0


@dataclasses.dataclass
class ResumePoint:
    """A level boundary to continue from: the frontier rows of level
    ``diameter``, the seen set and the counters so far
    (``BFSEngine.resume_point`` builds one from a ``Checkpoint``,
    ``interop.py`` the pieces from a JAX engine's host arrays)."""

    frontier: torch.Tensor           # [n, sw] uint8
    seen: fpset.FPSet
    distinct: int
    generated: int
    diameter: int
    levels: Tuple[int, ...]
    action_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    wall_seconds: float = 0.0        # checking time already spent
    # (fps, parents, actions) numpy columns and the roots, or None/{}.
    trace: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    roots: Dict[int, PyState] = dataclasses.field(default_factory=dict)


def exit_condition_hit(conds, res, queue_rows) -> Optional[str]:
    """The first tripped TLCGet budget as its stop_reason, or None."""
    live = {"distinct": res.distinct, "generated": res.generated,
            "queue": queue_rows}
    for counter, threshold in conds:
        if live[counter] > threshold:
            return f"{counter}_budget"
    return None


def resolve_por(cfg: EngineConfig, dims, invariants, constraint):
    """``EngineConfig.por`` / ``por_table`` -> an admitted ``PorTable`` or
    None (POR off).  A path loads the artifact (its fingerprint is
    checked there); ``check_table`` then holds the table to this run's
    model, invariants and constraint."""
    if cfg.por and cfg.por_table is None:
        raise NotImplementedError(
            "por=True certifies in process through the jaxpr analyzer, "
            "which is not ported (ROADMAP A8); pass por_table, the "
            "artifact of the JAX package's `analyze --passes por "
            "--por-artifact FILE`")
    table = cfg.por_table
    if table is None:
        return None
    if isinstance(table, str):
        table = por_mod.load_table(table)
    por_mod.check_table(table, dims, invariant_names=list(invariants),
                        has_constraint=constraint is not None)
    return table


def por_device_arrays(table, device):
    """``(mask [G] bool, priority [G] int32)`` tensors of an admitted
    table, or ``(None, None)`` when there is nothing to mask: a table
    with no certified instance builds the exact body of a run without
    POR."""
    if table is None or not table.certified:
        return None, None
    return (torch.as_tensor(table.ample_mask, device=device),
            torch.as_tensor(table.priority, device=device))


class BFSEngine:
    """Exhaustive checker for one (dims, invariants, constraint)."""

    def __init__(self, dims: RaftDims,
                 invariants: Optional[Dict[str, Callable]] = None,
                 constraint: Optional[Callable] = None,
                 config: Optional[EngineConfig] = None,
                 device="cuda"):
        self.dims = dims
        self.config = cfg = config or EngineConfig()
        self.device = dev = resolve_device(device)
        self.inv_names = list((invariants or {}).keys())
        self._inv_fns = list((invariants or {}).values())
        self._inv_id = (build_inv_id(self._inv_fns) if self._inv_fns
                        else None)
        self._constraint = constraint
        if cfg.pipeline not in PLANS:
            raise ValueError(
                f"pipeline must be 'v3' or 'v4', got {cfg.pipeline!r}: the "
                "JAX package's 'auto', 'v1' and 'v2' plans are not ported "
                "(ROADMAP.md A2)")
        self._v2 = build_v2(dims, dev)
        self._fingerprint = build_fingerprint(dims, dev)
        self._plan = PLANS[cfg.pipeline].resolve_plan(dev, cfg.enqueue_method)
        if cfg.checkpoint_dir is not None:
            ckpt_mod.check_dims_checkpointable(dims)
        self._por_table = resolve_por(cfg, dims, invariants or {},
                                      constraint)
        por_mask, por_priority = por_device_arrays(self._por_table, dev)
        self._check_deadlock = (True if cfg.check_deadlock is None
                                else cfg.check_deadlock)
        sw = state_width(dims)
        B, G = cfg.batch, dims.n_instances
        K = compact_mod.choose_k(B, G)
        self._seen_cap = max(cfg.seen_capacity, 8 * K)
        Q = max(-(-cfg.queue_capacity // B) * B, K)
        self._sw, self._B, self._G, self._Q = sw, B, G, Q
        self._PAD = max(B, K)
        self._QTH = Q - K
        front = None
        if cfg.pipeline == "v4":
            front = Front(dims=dims, v2=self._v2, inv_fns=self._inv_fns,
                          constraint=constraint, B=B, K=K, device=dev,
                          por_mask=por_mask, por_priority=por_priority)
        self._body = chunk_mod.build_chunk_body(
            dims=dims, v2=self._v2, inv_fns=self._inv_fns,
            constraint=constraint, B=B, K=K,
            record_trace=cfg.record_trace, device=dev, front=front,
            enqueue_method=cfg.enqueue_method, Q=Q,
            por_mask=por_mask, por_priority=por_priority)
        self.trace = PyTraceStore()

    # ------------------------------------------------------------------
    def _absorb(self, rows, valid, seen, qnext, next_count: int):
        """Root ingest: fingerprint full rows, insert, enqueue the novel
        constraint-passing ones.  Returns (n_new, count, fail, new, fph,
        fpl, inv)."""
        cands = unflatten_state(rows, self.dims)
        fph, fpl = self._fingerprint(cands)
        new, fail = insert(seen, pack(fph, fpl), valid)
        if self._inv_id is not None:
            inv = self._inv_id(cands)
        else:
            inv = torch.full(new.shape, -1, dtype=torch.int64,
                             device=self.device)
        if self._constraint is not None:
            enq = new & self._constraint(cands)
        else:
            enq = new
        idx = enq.nonzero().squeeze(1)
        qnext[next_count:next_count + idx.shape[0]] = rows[idx]
        return (int(new.sum()), next_count + idx.shape[0], bool(fail), new,
                fph, fpl, inv)

    def _record(self, new, kh, kl, phi, plo, actions):
        if not self.config.record_trace:
            return
        idx = new.nonzero().squeeze(1)
        if idx.numel() == 0:
            return
        cols = [x[idx].cpu().numpy() for x in (kh, kl, phi, plo, actions)]
        fps = (cols[0].astype(np.uint64) << np.uint64(32)) \
            | cols[1].astype(np.uint64)
        parents = (cols[2].astype(np.uint64) << np.uint64(32)) \
            | cols[3].astype(np.uint64)
        self.trace.add_batch(fps, parents, cols[4].astype(np.int32))

    def _decode_row(self, row: torch.Tensor) -> PyState:
        st = unflatten_state(row.reshape(1, -1).cpu(), self.dims)
        return decode_state(StateBatch(*(f[0] for f in st)), self.dims)

    def _maybe_grow(self, seen, res, t0):
        if int(seen.size[0]) <= seen.capacity // 2:
            return seen, t0
        t = time.time()
        seen = fpset.grow(seen, 2 * seen.capacity)
        stall = time.time() - t
        res.growth_stalls.append((seen.capacity, round(stall, 3)))
        return seen, t0 + stall

    def resume_point(self, ck: ckpt_mod.Checkpoint) -> ResumePoint:
        """A ``Checkpoint`` as this engine's ``ResumePoint``: the seen set
        rebuilt on the device from the saved keys, through the insert, in
        a table large enough to stay at most half full."""
        if ck.dims != self.dims:
            raise ValueError(
                f"checkpoint dims {ck.dims} != engine dims {self.dims}")
        cap = self._seen_cap
        while ck.seen_hi.shape[0] > compact_mod.pow2(cap) // 2:
            cap *= 2
        fr = np.ascontiguousarray(ck.frontier).astype(np.uint8,
                                                       casting="safe")
        return ResumePoint(
            frontier=torch.as_tensor(fr),
            seen=fpset.from_host_keys(ck.seen_hi, ck.seen_lo, cap,
                                      self.device),
            distinct=ck.distinct, generated=ck.generated,
            diameter=ck.diameter, levels=tuple(ck.levels),
            action_counts=dict(ck.action_counts),
            wall_seconds=ck.wall_seconds,
            trace=(ck.trace_fps, ck.trace_parents, ck.trace_actions),
            roots=dict(ck.roots))

    def _write_checkpoint(self, qcur, cur_count, pending, seen, res, trace,
                          wall):
        """Snapshot the level boundary: this level's frontier (device rows,
        then the host segments), the seen keys, counters and trace."""
        cfg = self.config
        if cfg.record_trace:
            tf, tp, ta = trace.export()
            roots = dict(trace.roots)
        else:
            tf = tp = np.empty(0, np.uint64)
            ta = np.empty(0, np.int32)
            roots = {}
        seen_hi, seen_lo = fpset.to_host_keys(seen)
        ck = ckpt_mod.Checkpoint(
            dims=self.dims,
            frontier=np.concatenate([host_rows(qcur[:cur_count]), *pending]),
            seen_hi=seen_hi, seen_lo=seen_lo,
            distinct=res.distinct, generated=res.generated,
            diameter=res.diameter, levels=tuple(res.levels),
            action_counts=dict(res.action_counts), wall_seconds=wall,
            trace_fps=tf, trace_parents=tp, trace_actions=ta, roots=roots)
        ckpt_mod.save(os.path.join(cfg.checkpoint_dir,
                                   f"level_{res.diameter:05d}.npz"), ck)
        # Retention after the write: the newest snapshot lands first.
        ckpt_mod.gc(cfg.checkpoint_dir, cfg.keep_checkpoints)

    # ------------------------------------------------------------------
    def run(self, init_states: Optional[List[PyState]] = None,
            resume: Union[None, str, ckpt_mod.Checkpoint,
                          ResumePoint] = None) -> EngineResult:
        """Check from ``init_states``, or continue from ``resume``: a
        snapshot's path, a loaded ``Checkpoint`` or a ``ResumePoint``."""
        dims, cfg, dev = self.dims, self.config, self.device
        sw, B, Q = self._sw, self._B, self._Q
        if (init_states is None) == (resume is None):
            raise ValueError("need exactly one of init_states or resume")
        if isinstance(resume, str):
            resume = ckpt_mod.load(resume)
        if isinstance(resume, ckpt_mod.Checkpoint):
            ck = resume
            if cfg.record_trace and ck.distinct > 0 \
                    and ck.trace_fps.size == 0:
                raise ValueError(
                    "checkpoint was written with trace recording "
                    "disabled; counterexample replay could never reach "
                    "a root — resume with record_trace=False "
                    "(--no-trace) or restart from scratch")
            if not cfg.record_trace and ck.trace_fps.size > 0 \
                    and cfg.checkpoint_dir is not None:
                raise ValueError(
                    "resuming a trace-carrying checkpoint with trace "
                    "recording disabled would write trace-less snapshots "
                    "into the same directory, shadowing the intact ones "
                    "for any later trace-on resume; use a different "
                    "checkpoint_dir or keep tracing enabled")
            resume = self.resume_point(ck)
        res = EngineResult(pipeline=cfg.pipeline,
                           fused_stages=dict(self._plan), device=str(dev),
                           por_instances=(self._por_table.certified
                                          if self._por_table else 0))
        phases = res.phases
        for k in ("dispatch", "sync", "host", "checkpoint"):
            phases[k] = 0.0
        trace = self.trace = PyTraceStore()
        t_enter = time.time()
        QA = Q + self._PAD
        qcur = torch.zeros((QA, sw), dtype=ROW_DTYPE, device=dev)
        qnext = torch.zeros((QA, sw), dtype=ROW_DTYPE, device=dev)
        pending: List[np.ndarray] = []      # host segments of this level
        spill_next: List[np.ndarray] = []   # host segments of the next

        def spilled(segs):
            return sum(len(s) for s in segs)

        t0 = time.time()
        if resume is not None:
            seen = resume.seen
            while int(seen.size[0]) > seen.capacity // 2:
                seen = fpset.grow(seen, 2 * seen.capacity)
            fr = resume.frontier
            for i in range(Q, fr.shape[0], Q):
                pending.append(fr[i:i + Q].cpu().numpy())
            fr = fr[:Q]
            qcur[:fr.shape[0]] = fr.to(dev)
            cur_count = fr.shape[0]
            res.distinct, res.generated = resume.distinct, resume.generated
            res.diameter, res.levels = resume.diameter, list(resume.levels)
            res.action_counts = dict(resume.action_counts)
            # Duration accumulates across restarts: wall_seconds, the rate
            # and the max_seconds budget all measure total checking time.
            t0 -= resume.wall_seconds
            if cfg.record_trace and resume.trace is not None:
                trace.add_batch(*resume.trace)
                trace.roots.update(resume.roots)
        else:
            encoded = [encode_state(s, dims) for s in init_states]
            roots = stack_states(encoded, dev)
            if self._inv_id is not None:
                inv = self._inv_id(roots).cpu()
                if (inv >= 0).any():
                    i = int((inv >= 0).to(torch.int32).argmax())
                    hi, lo = self._fingerprint(roots)
                    fp = (int(hi[i]) << 32) | int(lo[i])
                    if cfg.record_trace:
                        trace.roots.setdefault(fp, init_states[i])
                    res.violation = Violation(self.inv_names[int(inv[i])],
                                              init_states[i], fp)
                    res.stop_reason = "violation"
                    res.levels.append(0)
                    res.wall_seconds = time.time() - t_enter
                    return res
            for e in encoded:
                check_packable(e, dims)
            rows_all = flatten_state(roots)
            if cfg.record_trace:
                rhi, rlo = self._fingerprint(unflatten_state(rows_all, dims))
                for i, (h, l) in enumerate(zip(rhi.tolist(), rlo.tolist())):
                    trace.roots.setdefault((h << 32) | l, init_states[i])
            seen = fpset.empty(self._seen_cap, dev)
            t0 = time.time()
            next_count = 0
            for base in range(0, rows_all.shape[0], B):
                if base and cfg.max_seconds is not None \
                        and time.time() - t0 > cfg.max_seconds:
                    res.stop_reason = "duration_budget"
                    break
                if base and cfg.exit_conditions:
                    # "queue" during ingest: enqueued rows, spilled rows
                    # and the roots not yet ingested.
                    hit = exit_condition_hit(
                        cfg.exit_conditions, res,
                        next_count + spilled(spill_next)
                        + rows_all.shape[0] - base)
                    if hit:
                        res.stop_reason = hit
                        break
                rows = torch.zeros((B, sw), dtype=ROW_DTYPE, device=dev)
                part = rows_all[base:base + B]
                rows[:part.shape[0]] = part
                valid = torch.arange(B, device=dev) < part.shape[0]
                n_new, next_count, fail, new, fph, fpl, inv = self._absorb(
                    rows, valid, seen, qnext, next_count)
                res.distinct += n_new
                zeros = torch.zeros_like(fph)
                self._record(new, fph, fpl, zeros, zeros,
                             torch.full_like(fph, -1))
                if fail:
                    raise RuntimeError("seen-set probe failure during "
                                       "ingest; raise seen_capacity")
                seen, t0 = self._maybe_grow(seen, res, t0)
                if next_count > self._QTH:
                    spill_next.append(host_rows(qnext[:next_count]))
                    res.spills += 1
                    next_count = 0
                viol = new & (inv >= 0)
                if bool(viol.any()):
                    v = int(viol.to(torch.int32).argmax())
                    res.violation = Violation(
                        self.inv_names[int(inv[v])],
                        self._decode_row(rows[v]),
                        (int(fph[v]) << 32) | int(fpl[v]))
                    res.stop_reason = "violation"
                    break
            res.levels.append(next_count + spilled(spill_next))
            qcur, qnext = qnext, qcur
            cur_count = next_count
            pending, spill_next = spill_next, []

        arange_b = torch.arange(B, device=dev)
        F = len(dims.family_sizes)
        S = chunk_mod.N_SCALARS
        # A resumed run does not rewrite the snapshot it loaded (without
        # trace it would replace a trace-carrying file by an empty one),
        # and its interval clock starts at the restart.
        skip_ckpt_level = resume.diameter if resume is not None else -1
        last_ckpt = time.time() if resume is not None else float("-inf")
        while (cur_count > 0 or pending) and res.violation is None \
                and res.stop_reason == "exhausted":
            if cfg.checkpoint_dir is not None \
                    and res.diameter % max(1, cfg.checkpoint_every) == 0 \
                    and res.diameter != skip_ckpt_level \
                    and (time.time() - last_ckpt
                         >= cfg.checkpoint_interval_seconds):
                t_h = time.time()
                self._write_checkpoint(qcur, cur_count, pending, seen, res,
                                       trace, wall=t_h - t0)
                last_ckpt = time.time()
                phases["checkpoint"] += last_ckpt - t_h
            if cfg.max_diameter is not None \
                    and res.diameter >= cfg.max_diameter:
                res.stop_reason = "diameter_budget"
                break
            next_count = 0
            while True:
                offset = 0
                while offset < cur_count:
                    if cfg.max_seconds is not None \
                            and time.time() - t0 > cfg.max_seconds:
                        res.stop_reason = "duration_budget"
                        break
                    t_d = time.time()
                    rows = qcur[offset:offset + B]
                    valid = (offset + arange_b) < cur_count
                    out = self._body(rows, valid, seen, qnext, next_count)
                    t_s = time.time()
                    st = out.stats.tolist()          # the one device sync
                    t_h = time.time()
                    phases["dispatch"] += t_s - t_d
                    phases["sync"] += t_h - t_s
                    res.batches += 1
                    offset += st[chunk_mod.STAT_P]
                    next_count = st[chunk_mod.STAT_COUNT]
                    res.distinct += st[chunk_mod.STAT_NEW]
                    res.generated += st[chunk_mod.STAT_TOTAL]
                    for name, c, p in zip(dims.family_names, st[S:S + F],
                                          st[S + 2 * F:S + 3 * F]):
                        res.action_counts[name] = \
                            res.action_counts.get(name, 0) + c
                        res.action_pruned[name] = \
                            res.action_pruned.get(name, 0) + p
                    if st[chunk_mod.STAT_NEW]:
                        self._record(out.new, out.kh, out.kl, out.parent_hi,
                                     out.parent_lo, out.actions)
                    if st[chunk_mod.STAT_OVF]:
                        raise RuntimeError(
                            f"{st[chunk_mod.STAT_OVF]} successors exceeded "
                            f"fixed-width capacity (max_log={dims.max_log}, "
                            f"n_msg_slots={dims.n_msg_slots}) or wrapped "
                            "the uint8 row; rerun with larger capacities")
                    if st[chunk_mod.STAT_FAIL]:
                        raise RuntimeError(
                            "seen-set probe failure (load spiked past the "
                            "growth threshold within one batch); raise "
                            "seen_capacity")
                    seen, t0 = self._maybe_grow(seen, res, t0)
                    if next_count > self._QTH \
                            and (offset < cur_count or pending):
                        spill_next.append(host_rows(qnext[:next_count]))
                        res.spills += 1
                        next_count = 0
                    if st[chunk_mod.STAT_VIOL]:
                        v = st[chunk_mod.STAT_VPOS]
                        res.violation = Violation(
                            self.inv_names[st[chunk_mod.STAT_VINV]],
                            self._decode_row(out.krows[v]),
                            (int(out.kh[v]) << 32) | int(out.kl[v]))
                        res.stop_reason = "violation"
                    elif st[chunk_mod.STAT_DEAD] and self._check_deadlock:
                        res.deadlock = self._decode_row(
                            rows[st[chunk_mod.STAT_DPOS]])
                        res.stop_reason = "deadlock"
                    elif cfg.exit_conditions:
                        # TLC's "queue" is the whole unexplored queue: the
                        # rest of this level and everything enqueued for
                        # the next.  A violation or deadlock in the same
                        # batch outranks a budget stop.
                        hit = exit_condition_hit(
                            cfg.exit_conditions, res,
                            max(0, cur_count - offset) + spilled(pending)
                            + next_count + spilled(spill_next))
                        if hit:
                            res.stop_reason = hit
                    phases["host"] += time.time() - t_h
                    if res.stop_reason != "exhausted":
                        break
                if res.stop_reason != "exhausted" or not pending:
                    break
                t_h = time.time()
                seg = pending.pop(0)
                qcur[:len(seg)] = torch.as_tensor(seg).to(dev)
                cur_count = len(seg)
                phases["host"] += time.time() - t_h
            if res.stop_reason != "exhausted":
                break
            res.diameter += 1
            res.levels.append(next_count + spilled(spill_next))
            qcur, qnext = qnext, qcur
            cur_count = next_count
            pending, spill_next = spill_next, []
        res.wall_seconds = time.time() - t0
        return res

    # ------------------------------------------------------------------
    def successors(self, state: PyState):
        """All G candidate successors of one state: ``(enabled [G] bool,
        fps [G] uint64 numpy, StateBatch [G])`` — the v2 masks and lane
        outputs on every lane of the grid."""
        G, dev = self._G, self.device
        st = stack_states([encode_state(state, self.dims)], dev)
        en, _ovf = self._v2.masks(st)
        ph = self._v2.parent_hash(st)
        zero = torch.zeros(G, dtype=torch.int64, device=dev)
        kph = ParentHash(*(f.index_select(0, zero) for f in ph))
        kh, kl, succ = self._v2.lane_out(gather_states(st, zero), kph,
                                         torch.arange(G, device=dev))
        fps = (kh.cpu().numpy().astype(np.uint64) << np.uint64(32)) \
            | kl.cpu().numpy().astype(np.uint64)
        return en[0].cpu().numpy(), fps, succ

    def replay(self, fp: int) -> List[Tuple[int, PyState]]:
        """Counterexample: ``[(action id, state)]`` root first (root action
        -1).  Children are matched by fingerprint, because queue rows keep
        the kernel's message-slot layout while replay re-encodes each state
        canonically; the recorded action wins when it still matches."""
        chain = self.trace.chain(fp)
        if not chain:
            if fp in self.trace.roots:
                return [(-1, self.trace.roots[fp])]
            raise KeyError(f"fingerprint {fp:#x} not in trace")
        root_fp, g0 = chain[0]
        if g0 >= 0:
            raise KeyError("trace chain does not reach a root")
        state = self.trace.roots[root_fp]
        out = [(-1, state)]
        for child_fp, g_rec in chain[1:]:
            en, fps, succ = self.successors(state)
            ok = en & (fps == np.uint64(child_fp))
            if not ok.any():
                raise RuntimeError(
                    f"replay divergence: no enabled candidate matches fp "
                    f"{child_fp:#018x} (recorded action {g_rec})")
            g = g_rec if 0 <= g_rec < ok.shape[0] and ok[g_rec] \
                else int(np.argmax(ok))
            state = decode_state(StateBatch(*(f[g] for f in succ)),
                                 self.dims)
            out.append((g, state))
        return out
