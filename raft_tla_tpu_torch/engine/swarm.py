"""Swarm mode: W deterministic randomized walks in lockstep.

The JAX package's ``engine/swarm.py`` (``check --mode swarm``), the
second checking tier: where the exhaustive engine proves, the swarm
hunts.  Every walk advances one action a step through the v2 delta
pipeline (``models/actions2.py``: guards-only masks, then ``lane_out``
for the one chosen instance) or, with ``pipeline="v1"``, through the
classical expansion (``models/actions.py``: every instance's successor
row, the chosen one taken), with the JAX engine's rules:

- no global seen set: each walk dedups against a ring of its own last R
  accepted fingerprints (``ops/walk_kernels.py``);
- a counter PRNG: each decision is a hash of ``(seed, walk, step)``, and
  the successor draw is family-diversified (a per-trace subset of the
  action families, keyed on the walk's restart count), so a run's
  visited-fingerprint multiset and verdict do not depend on how the walks
  are sliced into batches or steps into chunks;
- walks restart onto a hashed root on a dead end, an overflow, a
  constraint stop, a ring revisit or the depth bound;
- every chunk latches its first violation (first step with a bad lane,
  lowest lane there); the host picks the least ``(step, walk)`` across
  slices and replays the latched ``(root, actions)`` from the root's
  encoded row, threading ``lane_out``'s successor (re-encoding a state
  reassigns message slots, and the recorded action ids are slot indices);
- steps at or past ``k_limit`` are frozen: they change no tensor, so a
  ``num_steps`` budget is exact in chunk-sized dispatches.

As in the JAX swarm, the one successor a walk takes is hashed in full
(``ops/fingerprint.py``); ``lane_out`` builds it without its delta hash,
which at one lane a row costs more device operations than the full hash.

On the card each slice's chunk (``chunk`` steps) is one CUDA graph, one
for each distinct lane count; ``k0``, the seed and ``k_limit`` live in a
device tensor written before each chunk, the latch and the chunk's
counters are made fresh inside the captured region, and the host reads
one small tensor a chunk.  A capture that fails raises.  On the CPU the
chunk runs eagerly.

The run's events (``events_out``: ``run_start``, ``swarm_progress``,
``statespace``, ``run_end``, the JAX swarm's names and fields) and, on a
violation, ``counterexample.{txt,json}`` in ``counterexample_dir``
(``engine/explain.py``), as the JAX swarm writes them.  Also the JAX
swarm's observability: the hunt observatory (``hunt=True``,
``obs/hunt.py``: each accepted visit classified on the device against
two Bloom filters shared by every slice and chunk, the restart census,
the depth histogram and the family tallies counted in the chunk, its
``hunt`` event and report), the flight recorder armed for the run, the
walk-stage profiler (``profile_chunks_every``), the perf block
(``perf``), the device-profiler capture (``xla_profile_chunks``) and,
with ``trace_out``, a ``run`` span and ``swarm_chunk`` / ``swarm_fetch``
spans.  The hunt's tallies feed nothing back into a walk, so a run's
walks and verdict are the same with it on or off.  The hunt is on by
default, as in the JAX engine; ``hunt=False`` builds the bare chunk.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.actions import build_expand
from ..models.actions2 import build_v2
from ..models.dims import RaftDims
from ..models.invariants import build_inv_id
from ..models.pystate import PyState
from ..models.schema import (StateBatch, check_packable, decode_state,
                             encode_state, flatten_state, stack_states,
                             unflatten_state)
from ..obs.events import RunEventLog, device_memory_stats, events_path
from ..obs.flight import RECORDER as _FLIGHT
from ..obs.metrics import PHASE_PREFIX, MetricsRegistry
from ..obs.tracing import SpanTracer
from ..ops.fingerprint import build_fingerprint
from ..ops.walk_kernels import (CHOICE_STREAM, FAMILY_STREAM, INIT_STREAM,
                                ROOT_STREAM, bloom_init, bloom_probe,
                                bloom_push, family_subset, preferred_choice,
                                ring_init, ring_probe, ring_push, ring_reset,
                                walk_bits, walk_bits_at, walk_key)
from ..utils.device import capture_graph, resolve_device
from .bfs import Violation

#: ``k_limit`` of a run with no step budget (the JAX engine's int32 max).
NO_LIMIT = np.iinfo(np.int32).max

# The chunk's output vector: its counters, then the latch.
OUT_RESTARTS, OUT_VISITED, OUT_DEPTH, OUT_VF = 0, 1, 2, 3
OUT_VINV, OUT_VROOT, OUT_VLEN, OUT_VCHOICE = 4, 5, 6, 7
OUT_VWALK, OUT_VSTEP, OUT_VHI, OUT_VLO = 8, 9, 10, 11
OUT_VACTS = 12

# The hunt's tallies of a slice's chunk (``HuntState.out``): these seven
# counts, then the final-depth histogram [D + 1] and per family the
# chosen, accepted and fresh counts.
(H_FRESH, H_PROMOTE, H_REVISIT, H_DEAD, H_OVF, H_CONS, H_DBOUND) = range(7)
H_SCALARS = 7


class HuntState:
    """The hunt's tensors a chunk reads and writes: the two filters (the
    engine's, shared by every slice), the slice's tallies and its
    per-step (fresh, accepted) counts [chunk, 2]."""

    def __init__(self, blooms, out, steps):
        self.blooms, self.out, self.steps = blooms, out, steps


def same_fp_prior(hi, lo, accept):
    """For each lane, the accepted lanes before it with its fingerprint
    (the JAX hunt's in-step prior count): a stable sort by fingerprint,
    then an exclusive count within each run of equal keys."""
    n = hi.shape[0]
    key = (hi << 32) | lo
    order = torch.argsort(key, stable=True)
    ks = key.index_select(0, order)
    acc = accept.index_select(0, order).to(torch.int64)
    idx = torch.arange(n, device=hi.device)
    first = torch.ones(n, dtype=torch.bool, device=hi.device)
    first[1:] = ks[1:] != ks[:-1]
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    cex = torch.cumsum(acc, 0) - acc
    prior = torch.empty_like(cex)
    prior.index_copy_(0, order, cex - cex.index_select(0, start))
    return prior


def resolve_walk_pipeline(pipeline: str) -> str:
    """The walk tiers' expansion: "v1" the classical one (every instance
    built, the chosen one taken), else the v2 delta kernels; "v3"/"v4"
    are plans of the exhaustive chunk and take v2's semantics here, as in
    the JAX package."""
    if pipeline == "v1":
        return "v1"
    if pipeline not in ("auto", "v2", "v3", "v4"):
        raise ValueError(
            f"pipeline must be auto/v1/v2/v3/v4, got {pipeline!r}")
    return "v2"


def build_walk_expand(dims: RaftDims, pipeline: str, device):
    """``step(st, choose) -> (en, ovf, choice, nxt)`` of one walk step on
    the resolved pipeline (``resolve_walk_pipeline``): the enabled and
    overflow masks ``[B, G]`` (the pack guard folded in), ``choose(en)``'s
    instance a row and that instance's successor.  v2 builds only the
    chosen successor (``lane_out``); v1 builds every instance's row and
    takes the chosen one, as the JAX walks' v1 branch does."""
    if pipeline == "v1":
        expand = build_expand(dims, device)
        G = dims.n_instances

        def step(st, choose):
            cands, en, ovf = expand(st)
            ovf = ovf | (en & ~cands.pack_ok)
            choice = choose(en)
            lane = (torch.arange(en.shape[0], device=en.device) * G
                    + choice)
            nxt = unflatten_state(cands.rows.index_select(0, lane), dims)
            return en, ovf, choice, nxt

        return step
    v2 = build_v2(dims, device)

    def step(st, choose):
        en, ovf = v2.masks(st)
        choice = choose(en)
        _h, _l, nxt = v2.lane_out(st, None, choice, hashes=False)
        return en, ovf, choice, nxt

    return step


@dataclasses.dataclass
class SwarmResult:
    """A swarm run.  ``phases`` splits the host's time: graph ``capture`` (off
    ``wall_seconds``), ``dispatch`` of the chunks, ``sync`` (the one read
    a chunk) and ``replay``."""
    walks: int = 0
    steps: int = 0              # lockstep walk-steps executed (W x steps)
    visited: int = 0            # accepted state visits (ring-deduped)
    traces: int = 0             # walks started (W + restarts)
    diameter: int = 0           # deepest trace depth any walk reached
    chunks: int = 0
    stop_reason: str = "steps"
    wall_seconds: float = 0.0
    pipeline: str = ""
    device: str = ""
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    violation: Optional[Violation] = None
    violation_trace: Optional[List[Tuple[int, PyState]]] = None
    #: Seconds into the run when the violation latched (capture excluded).
    violation_at_seconds: Optional[float] = None
    #: The latched violation's global step and walk.
    violation_step: Optional[int] = None
    violation_walk: Optional[int] = None
    #: The visited-fingerprint multiset, [N, 2] uint32 (hi, lo), only with
    #: ``collect_fingerprints=True``.
    visited_fingerprints: Optional[np.ndarray] = None
    #: The JAX swarm's run report (``mode``, ``swarm`` block, verdict).
    report: Dict = dataclasses.field(default_factory=dict)
    #: {"txt", "json", "depth"} of the written counterexample, else {}.
    counterexample: Dict = dataclasses.field(default_factory=dict)
    #: {stage: mean seconds} of the walk-stage profiler, else {}.
    chunk_stages: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: The perf block (obs/perf.py) with perf on, else {}.
    perf: Dict = dataclasses.field(default_factory=dict)

    # The exhaustive result's names, in the swarm's dialect (what the run
    # events and the history ledger read): accepted visits and steps.
    @property
    def distinct(self) -> int:
        return self.visited

    @property
    def generated(self) -> int:
        return self.steps

    @property
    def fused_stages(self) -> Dict[str, str]:
        return {}

    @property
    def steps_per_second(self) -> float:
        return self.steps / self.wall_seconds if self.wall_seconds else 0.0

    @property
    def walks_per_second(self) -> float:
        return self.traces / self.wall_seconds if self.wall_seconds else 0.0

    @property
    def states_per_second(self) -> float:
        return (self.visited / self.wall_seconds
                if self.wall_seconds else 0.0)


class Carry:
    """One slice's walk state, the tensors a chunk reads and updates in
    place: packed rows, trace depth, root, action buffer, ring, epoch."""
    FIELDS = ("rows", "tstep", "cur_root", "abuf", "ring_hi", "ring_lo",
              "ring_pos", "epoch")

    def __init__(self, **tensors):
        for f in self.FIELDS:
            setattr(self, f, tensors[f])

    @classmethod
    def fresh(cls, rows, depth: int, ring: int, cur_root):
        lanes, dev = rows.shape[0], rows.device
        z = torch.zeros(lanes, dtype=torch.int64, device=dev)
        rh, rl, rp = ring_init(lanes, ring, dev)
        return cls(rows=rows, tstep=z, cur_root=cur_root,
                   abuf=torch.zeros((lanes, depth), dtype=torch.int64,
                                    device=dev),
                   ring_hi=rh, ring_lo=rl, ring_pos=rp, epoch=z.clone())

    def tensors(self):
        return [getattr(self, f) for f in self.FIELDS]

    def copy_(self, other: "Carry"):
        for a, b in zip(self.tensors(), other.tensors()):
            a.copy_(b)


def latch_update(latch, vf, bad, vals, abuf):
    """The chunk's latch: where this step has a bad lane and none latched
    yet, the lowest bad lane's ``vals`` column and action buffer row.  All
    on the device (no host read)."""
    w = bad.to(torch.int8).argmax().view(1)
    new = torch.cat([vals.index_select(1, w).squeeze(1),
                     abuf.index_select(0, w).squeeze(0)])
    take = bad.any() & ~vf
    return torch.where(take, new, latch), vf | bad.any()


def build_swarm_chunk(dims: RaftDims, inv_fns, constraint, D: int,
                      chunk: int, device, pipeline: str = "v2"):
    """``chunk_fn(carry, walk_ids, roots, ctl, out, ys, hunt)``:
    ``chunk`` lockstep steps from global step ``ctl[0]`` under seed
    ``ctl[1]``, steps at or past ``ctl[2]`` frozen.  Updates ``carry`` in
    place and writes the counters and latch to ``out`` (``OUT_*``), where
    ``ys`` is given each step's ``(fp_hi, fp_lo, accept)`` to ``ys [chunk,
    3, lanes]``, and where ``hunt`` (a ``HuntState``) is given the hunt's
    filters and tallies (the JAX chunk's, derived from the walk's
    decisions and feeding none of them).  The lane count is the carry's,
    so one builder serves every slice; ``pipeline`` is the resolved walk
    expansion (``resolve_walk_pipeline``)."""
    walk_step = build_walk_expand(dims, pipeline, device)
    fingerprint = build_fingerprint(dims, device)
    inv_id = build_inv_id(inv_fns)
    fam = torch.as_tensor(np.repeat(
        np.arange(len(dims.family_sizes)), dims.family_sizes),
        device=device)
    lanes_d = torch.arange(D, device=device)
    # vinv, vroot, vlen, vchoice, vwalk, vstep, vhi, vlo, vacts [D]
    latch0 = torch.tensor([-1, 0, 0, -1, -1, -1, 0, 0] + [0] * D,
                          dtype=torch.int64, device=device)

    n_fam = len(dims.family_sizes)

    def chunk_fn(c: Carry, walk_ids, roots, ctl, out, ys=None, hunt=None):
        B = c.rows.shape[0]
        seed, k_limit = ctl[1], ctl[2]
        rows, tstep, cur_root, abuf = c.rows, c.tstep, c.cur_root, c.abuf
        rh, rl, rp, epoch = c.ring_hi, c.ring_lo, c.ring_pos, c.epoch
        # Each stream's walk keys, once a chunk: a step folds in its step.
        key_choice, key_family, key_root = (
            walk_key(seed, walk_ids, stream)
            for stream in (CHOICE_STREAM, FAMILY_STREAM, ROOT_STREAM))
        # Fresh latch and counters inside the chunk (under a graph: inside
        # the captured region, so every replay starts from them).
        latch = latch0.clone()
        vf = torch.zeros((), dtype=torch.bool, device=device)
        restarts = torch.zeros((), dtype=torch.int64, device=device)
        visited = torch.zeros_like(restarts)
        depth_max = torch.zeros_like(restarts)
        if hunt is not None:
            b1, b2 = hunt.blooms
            tally = torch.zeros(H_SCALARS, dtype=torch.int64, device=device)
            dhist = torch.zeros(D + 1, dtype=torch.int64, device=device)
            fams = torch.zeros((3, n_fam), dtype=torch.int64, device=device)
        for i in range(chunk):
            k = ctl[0] + i
            act = k < k_limit
            st = unflatten_state(rows, dims)
            bits = walk_bits_at(key_choice, k)
            mbits = walk_bits_at(key_family, epoch)
            en, ovf, choice, nxt = walk_step(st, lambda en: preferred_choice(
                bits, en, family_subset(mbits, fam)))
            can_step = en.any(1) & act
            nrows = flatten_state(nxt, dims)
            fp_hi, fp_lo = fingerprint(nxt)
            if inv_fns:
                inv = inv_id(nxt)
            else:
                inv = torch.full((B,), -1, dtype=torch.int64, device=device)
            bad = can_step & (inv >= 0)
            vals = torch.stack([inv, cur_root, tstep, choice, walk_ids,
                                k.expand(B), fp_hi, fp_lo])
            latch, vf = latch_update(latch, vf, bad, vals, abuf)
            if constraint is not None:
                cons_ok = constraint(nxt)
            else:
                cons_ok = torch.ones(B, dtype=torch.bool, device=device)
            seen = ring_probe(rh, rl, fp_hi, fp_lo)
            accept = can_step & ~ovf.any(1) & cons_ok & ~seen
            # The action taken since the last restart, recorded before the
            # restart decision; a frozen step writes nothing.
            at = ((lanes_d == tstep.clamp(0, D - 1).unsqueeze(1))
                  & act)
            abuf = torch.where(at, torch.where(can_step, choice, -1)
                               .unsqueeze(1), abuf)
            rh, rl, rp = ring_push(rh, rl, rp, fp_hi, fp_lo, accept)
            restart = (~accept | (tstep + 1 >= D)) & act
            if hunt is not None:
                # Species accounting: the filters give each accepted
                # visit's earlier observations (capped at two), exact in
                # the step through the prior count over earlier lanes.
                nobs = (bloom_probe(b1, fp_hi, fp_lo).to(torch.int64)
                        + bloom_probe(b2, fp_hi, fp_lo).to(torch.int64)
                        + same_fp_prior(fp_hi, fp_lo, accept))
                fresh = accept & (nobs == 0)
                promote = accept & (nobs == 1)
                b1 = bloom_push(b1, fp_hi, fp_lo, accept)
                b2 = bloom_push(b2, fp_hi, fp_lo, accept & (nobs >= 1))
                # The restart census in the engine's decision order.
                anyovf = ovf.any(1)
                tally += torch.stack([
                    fresh.sum(), promote.sum(),
                    (can_step & ~anyovf & cons_ok & seen).sum(),
                    (~can_step & act).sum(), (can_step & anyovf).sum(),
                    (can_step & ~anyovf & ~cons_ok).sum(),
                    (accept & (tstep + 1 >= D)).sum()])
                dfin = torch.where(accept, tstep + 1, tstep).clamp(0, D)
                dhist.index_add_(0, dfin, restart.to(torch.int64))
                fidx = fam.index_select(0, choice)
                for r, m in enumerate((can_step, accept, fresh)):
                    fams[r].index_add_(0, fidx, m.to(torch.int64))
                hunt.steps[i].copy_(torch.stack([fresh.sum(),
                                                 accept.sum()]))
            root_idx = walk_bits_at(key_root, k) % roots.shape[0]
            rows = torch.where(restart.unsqueeze(1),
                               roots.index_select(0, root_idx),
                               torch.where(accept.unsqueeze(1), nrows, rows))
            cur_root = torch.where(restart, root_idx, cur_root)
            rh, rl, rp = ring_reset(rh, rl, rp, restart)
            depth_max = torch.maximum(
                depth_max, torch.where(accept, tstep + 1, 0).max())
            tstep = torch.where(restart, 0,
                                torch.where(accept, tstep + 1, tstep))
            epoch = epoch + restart.to(torch.int64)
            restarts = restarts + restart.sum()
            visited = visited + accept.sum()
            if ys is not None:
                ys[i].copy_(torch.stack([fp_hi, fp_lo,
                                         accept.to(torch.int64)]))
        c.copy_(Carry(rows=rows, tstep=tstep, cur_root=cur_root, abuf=abuf,
                      ring_hi=rh, ring_lo=rl, ring_pos=rp, epoch=epoch))
        if hunt is not None:
            hunt.blooms[0].copy_(b1)
            hunt.blooms[1].copy_(b2)
            hunt.out.copy_(torch.cat([tally, dhist, fams.reshape(-1)]))
        out.copy_(torch.cat([torch.stack([restarts, visited, depth_max,
                                          vf.to(torch.int64)]), latch]))

    return chunk_fn


def check_roots(dims: RaftDims, roots: List[PyState], inv_id, inv_fns,
                device):
    """TLC checks invariants on initial states too, on the unpacked
    encoding (packing would wrap an out-of-range value and hide a TypeOK
    violation).  Returns ``(index of the first violating root or None,
    its invariant id, the encoded roots)``."""
    encoded = [encode_state(s, dims) for s in roots]
    if inv_fns:
        rinv = inv_id(stack_states(encoded, device)).cpu().numpy()
        bad = np.flatnonzero(rinv >= 0)
        if bad.size:
            return int(bad[0]), int(rinv[bad[0]]), encoded
    return None, -1, encoded


def root_rows(dims: RaftDims, encoded, device):
    """The roots' packed rows [n, state_width] on ``device`` (each checked
    to survive the uint8 row)."""
    for e in encoded:
        check_packable(e, dims)
    return flatten_state(stack_states(encoded, device), dims)


def replay_actions(v2, dims: RaftDims, root: PyState, actions, device):
    """``[(action id, PyState)]`` from ``root`` through ``actions``: the
    root's encoded row is threaded through ``lane_out``, never re-encoded
    (a re-encoded state's message slots differ, and the recorded ids are
    slot indices).  Stops at the first action that is not enabled."""
    st = stack_states([encode_state(root, dims)], device)
    trace = [(-1, root)]
    for g in actions:
        g = int(g)
        en, _ovf = v2.masks(st)
        if g < 0 or not bool(en[0, g]):
            break
        _h, _l, st = v2.lane_out(
            st, None, torch.tensor([g], dtype=torch.int64, device=device),
            hashes=False)
        trace.append((g, decode_state(StateBatch(*(f[0] for f in st)),
                                      dims)))
    return trace


@dataclasses.dataclass
class _Slice:
    """A slice of the walks: its ids, its carry, its row of the chunk's
    outputs and, with the hunt on, its last chunk's hunt tallies."""
    walk_ids: torch.Tensor
    carry: Carry
    index: int
    hunt: Optional[HuntState] = None


class SwarmEngine:
    """W lockstep randomized walks; see the module docstring.

    ``batch`` caps the lanes of a dispatch (walks are sliced across
    dispatches without changing any walk), ``ring`` is the per-walk dedup
    capacity R, ``chunk`` the steps a dispatch.  The constructor takes the
    JAX engine's arguments (``progress_seconds`` is the
    ``swarm_progress`` cadence; ``hunt`` is on by default), ``trace_out``,
    ``metrics`` (a shared registry), ``run_context_extra`` (caller tags
    on the flight recorder's run_context) and ``device`` (the card unless
    ``"cpu"``)."""

    def __init__(self, dims: RaftDims,
                 invariants: Optional[Dict[str, Callable]] = None,
                 constraint: Optional[Callable] = None, *,
                 walks: int = 1024, max_depth: int = 128,
                 batch: Optional[int] = None, chunk: int = 32,
                 ring: int = 16, pipeline: str = "auto",
                 collect_fingerprints: bool = False, hunt: bool = True,
                 hunt_cells: int = 1 << 20,
                 events_out: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None,
                 postmortem_dir: Optional[str] = None,
                 counterexample_dir: Optional[str] = None,
                 progress_seconds: float = 5.0, perf: bool = False,
                 profile_chunks_every: Optional[int] = None,
                 xla_profile_chunks: Optional[int] = None,
                 xla_profile_dir: Optional[str] = None,
                 trace_out: Optional[str] = None, metrics=None,
                 run_context_extra: Optional[dict] = None, device="cuda"):
        if walks < 1:
            raise ValueError(f"walks must be >= 1, got {walks}")
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        if chunk < 1 or ring < 1:
            raise ValueError(f"chunk and ring must be >= 1, got {chunk}, "
                             f"{ring}")
        self.dims = dims
        self.device = resolve_device(device)
        self.inv_names = list((invariants or {}).keys())
        self._inv_fns = list((invariants or {}).values())
        self._inv_id = build_inv_id(self._inv_fns)
        self.walks, self.max_depth, self.ring = walks, max_depth, ring
        self.batch = min(batch or walks, walks)
        self.chunk = chunk
        self.collect_fingerprints = collect_fingerprints
        self.events_out = events_out
        self.checkpoint_dir = checkpoint_dir
        self.counterexample_dir = counterexample_dir
        self.progress_seconds = progress_seconds
        self.postmortem_dir = postmortem_dir
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.run_context_extra = run_context_extra
        self.tracer = SpanTracer(trace_out)
        self.metrics.tracer = self.tracer
        self.hunt, self.hunt_cells = hunt, int(hunt_cells)
        self._blooms = ([bloom_init(self.hunt_cells, self.device)
                         for _ in range(2)] if hunt else None)
        self._hunt_acc = None
        self.pipeline_name = resolve_walk_pipeline(pipeline)
        self._v2 = build_v2(dims, self.device)
        self._fp = build_fingerprint(dims, self.device)
        self._chunk = build_swarm_chunk(
            dims, self._inv_fns, constraint, max_depth, chunk, self.device,
            pipeline=self.pipeline_name)
        self._ctl = torch.zeros(3, dtype=torch.int64, device=self.device)
        self._pool = None
        self._graphs: Dict[int, tuple] = {}
        self._roots = None
        self._last_trace: Optional[List[Tuple[int, PyState]]] = None
        every = (profile_chunks_every if profile_chunks_every is not None
                 else (16 if perf else None))
        self._profiler = None
        if every:
            from ..obs.profile import ChunkProfiler
            self._profiler = ChunkProfiler(
                dims, batch=self.batch, lanes=dims.n_instances,
                seen_capacity=1 << 10, pipeline="swarm", every=every,
                metrics=self.metrics, device=self.device, ring=ring,
                swarm_pipeline=self.pipeline_name)
        self._perf = None
        if perf:
            from ..obs import perf as perf_mod
            from ..obs import roofline
            self._perf = perf_mod.PerfAccounting(
                pipeline="swarm",
                stage_traffic=roofline.walked_floors(
                    "SwarmEngine", dims, self.batch, dims.n_instances,
                    pipeline="swarm", ring=ring,
                    swarm_pipeline=self.pipeline_name),
                device=self.device, metrics=self.metrics)
        self._xla_chunks, self._xla_dir = xla_profile_chunks, xla_profile_dir
        self._xla_capture = None

    # -- the explainer's surface -----------------------------------------
    def replay(self, fp: int) -> List[Tuple[int, PyState]]:
        """The latched violation's ``[(action id, PyState)]`` root first;
        only the latched fingerprint is replayable."""
        if self._last_trace is None:
            raise KeyError(f"no traced violation to replay ({fp:#x})")
        return list(self._last_trace)

    # -- the chunk on the card -------------------------------------------
    def _ys(self, lanes):
        if not self.collect_fingerprints:
            return None
        return torch.zeros((self.chunk, 3, lanes), dtype=torch.int64,
                           device=self.device)

    def _graph(self, lanes: int, res: SwarmResult):
        """The chunk's graph for ``lanes`` walks and its static buffers
        (carry, walk ids, output, ys), captured at first use."""
        if lanes in self._graphs:
            return self._graphs[lanes]
        t = time.time()
        dev = self.device
        static = Carry.fresh(self._roots[:1].expand(lanes, -1).clone(),
                             self.max_depth, self.ring,
                             torch.zeros(lanes, dtype=torch.int64,
                                         device=dev))
        walk_ids = torch.zeros(lanes, dtype=torch.int64, device=dev)
        out = torch.zeros(OUT_VACTS + self.max_depth, dtype=torch.int64,
                          device=dev)
        ys = self._ys(lanes)
        hs = self._hunt_state()

        def body():
            self._chunk(static, walk_ids, self._roots, self._ctl, out, ys,
                        hs)

        # Warm-up: one eager chunk whose steps are all frozen (it loads
        # every kernel and changes no walk), the capture, and one frozen
        # replay (a graph's first launch uploads it), waited for: a frozen
        # step runs every op, so a replay left queued would put a whole
        # chunk of device time on the run's clock.
        saved = self._ctl.clone()
        self._ctl.copy_(torch.tensor([0, 0, 0]))
        body()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        g = capture_graph(body, dev, self._pool)
        g.replay()
        torch.cuda.synchronize(dev)
        self._ctl.copy_(saved)
        self._graphs[lanes] = (g, static, walk_ids, out, ys, hs)
        res.phases["capture"] += time.time() - t
        return self._graphs[lanes]

    def _hunt_state(self) -> Optional[HuntState]:
        """A slice's hunt buffers on the engine's filters (None with the
        hunt off)."""
        if not self.hunt:
            return None
        n = H_SCALARS + self.max_depth + 1 + 3 * len(self.dims.family_sizes)
        return HuntState(self._blooms,
                         torch.zeros(n, dtype=torch.int64,
                                     device=self.device),
                         torch.zeros((self.chunk, 2), dtype=torch.int64,
                                     device=self.device))

    def release(self) -> None:
        """Give back the captured graphs (their pool with them) and the
        staged roots: the checker service calls it on an evicted engine."""
        self._graphs.clear()
        self._pool = None
        self._roots = None

    def _stage_roots(self, rows):
        """The roots where the graphs read them; graphs captured on roots
        of another count are dropped."""
        if self._roots is None or self._roots.shape != rows.shape:
            self._graphs.clear()
            self._pool = None
            self._roots = rows.clone()
        else:
            self._roots.copy_(rows)

    # -- run ---------------------------------------------------------------
    def run(self, roots: List[PyState], *, seed: int = 0,
            num_steps: Optional[int] = None,
            max_seconds: Optional[float] = None) -> SwarmResult:
        """Every walk advances in lockstep until the first latched
        violation, the ``max_seconds`` budget, or ``num_steps`` steps a
        walk (default ``max_depth`` when no time budget is given)."""
        res = SwarmResult(walks=self.walks, pipeline=self.pipeline_name,
                          device=str(self.device),
                          phases={"capture": 0.0, "dispatch": 0.0,
                                  "sync": 0.0, "replay": 0.0})
        if num_steps is None and max_seconds is None:
            num_steps = self.max_depth
        for obs in (self._profiler, self._perf):
            if obs is not None:
                obs.reset()
        if self.tracer.enabled:
            self.tracer.reset()
        self._hunt_acc = None
        if self.hunt:
            from ..obs import hunt as hunt_mod
            self._hunt_acc = hunt_mod.HuntAccumulator(
                self.dims.family_names, self.max_depth,
                bloom_cells=self.hunt_cells)
            for b in self._blooms:
                b.zero_()
        self._xla_capture = None
        if self._xla_chunks:
            from ..obs.profile import ProfileCapture
            self._xla_capture = ProfileCapture(
                self._xla_dir or os.path.join(self.checkpoint_dir or ".",
                                              "xla_profile"),
                self._xla_chunks, self.device)
            self._xla_capture.start()
        evlog = self._evlog = RunEventLog(events_path(self.events_out,
                                                      self.checkpoint_dir))
        _FLIGHT.arm(self._postmortem_path(), metrics=self.metrics,
                    context={"engine": type(self).__name__, "mode": "swarm",
                             "dims": repr(self.dims), "walks": self.walks,
                             "max_depth": self.max_depth,
                             "batch": self.batch, "ring": self.ring,
                             "pipeline": self.pipeline_name,
                             **dict(self.run_context_extra or {})})
        _FLIGHT.set_live_evlog(evlog)
        self._run_t0 = time.perf_counter()
        evlog.emit("run_start", engine=type(self).__name__, mode="swarm",
                   dims=repr(self.dims), walks=self.walks,
                   max_depth=self.max_depth, batch=self.batch,
                   ring=self.ring, seed=seed, num_steps=num_steps,
                   memory=device_memory_stats(self.device))
        t0 = time.time()
        err = None
        try:
            self._run_impl(roots, res, seed, num_steps, max_seconds, t0)
        except BaseException as e:
            err = e
            raise
        finally:
            res.wall_seconds = time.time() - t0 - res.phases["capture"]
            self._finish(res, err)
        return res

    def _postmortem_path(self) -> Optional[str]:
        d = self.postmortem_dir or self.checkpoint_dir
        return os.path.join(d, "postmortem.json") if d else None

    def _swarm_block(self, res: SwarmResult) -> dict:
        """The ``swarm`` object of ``swarm_progress``, ``run_end`` and the
        report (the JAX swarm's; with the hunt on, its live snapshot)."""
        out = {"walks": res.walks, "steps": res.steps,
               "visited": res.visited, "traces": res.traces,
               "max_depth": self.max_depth, "ring": self.ring,
               "steps_per_sec": round(res.steps_per_second, 1),
               "walks_per_sec": round(res.walks_per_second, 1),
               "visited_per_sec": round(res.states_per_second, 1),
               "violation_at_seconds": res.violation_at_seconds}
        if self._hunt_acc is not None:
            out["hunt"] = self._hunt_acc.snapshot()
        return out

    def _finish(self, res: SwarmResult, err):
        """The JAX swarm's run end: the counterexample files, the walk
        profile, the perf block, the capture's event, the hunt report, the
        statespace report and ``run_end`` (with the postmortem dump's path
        after an error); the run's counters and phase seconds into
        ``metrics``; the flight recorder disarmed, the trace written."""
        evlog, mt = self._evlog, self.metrics
        mt.counter("swarm/walks", res.traces)
        mt.counter("swarm/visited", res.visited)
        mt.counter("swarm/steps", res.steps)
        for name, seconds in res.phases.items():
            mt.observe(PHASE_PREFIX + name, seconds)
        ce_path = None
        if err is None and res.violation is not None \
                and (self.counterexample_dir or self.checkpoint_dir):
            try:
                from .explain import write_counterexample
                res.counterexample = write_counterexample(
                    self, res, self.counterexample_dir or self.checkpoint_dir)
                ce_path = res.counterexample["txt"]
            except Exception as e:
                print(f"counterexample render failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)
        if self._profiler is not None:
            res.chunk_stages = self._profiler.stage_means()
            self._profiler.finish(evlog)
        if self._perf is not None and err is None:
            try:
                res.perf = self._perf.finish(evlog,
                                             chunk_stages=res.chunk_stages)
            except Exception as e:
                print(f"perf: block assembly failed "
                      f"({type(e).__name__}: {e})", file=sys.stderr)
        if self._xla_capture is not None:
            self._xla_capture.finish(evlog)
        hunt_report = None
        if self._hunt_acc is not None and err is None:
            from ..obs import hunt as hunt_mod
            hunt_report = hunt_mod.build_report(
                self._hunt_acc,
                violation_at_seconds=res.violation_at_seconds,
                wall_seconds=res.wall_seconds)
            evlog.emit("hunt", hunt=hunt_report)
            hunt_mod.feed_metrics(hunt_report, mt)
            _FLIGHT.record("hunt", **self._hunt_acc.snapshot())
        swarm_block = self._swarm_block(res)
        if err is None:
            res.report = {
                "collision": {"calculated": 0.0},
                "diameter": res.diameter,
                "verdict": ("violation" if res.violation is not None
                            else "ok"),
                "levels": [], "mode": "swarm", "swarm": swarm_block}
            if hunt_report is not None:
                res.report["hunt"] = hunt_report
            evlog.emit("statespace", report=res.report)
        pm_path = None
        if err is not None:
            pm_path = _FLIGHT.dump(
                f"swarm run error: {type(err).__name__}: {err}")
        evlog.emit(
            "run_end",
            stop_reason=(res.stop_reason if err is None else "error"),
            error=(f"{type(err).__name__}: {err}" if err is not None
                   else None),
            postmortem_path=pm_path, counterexample_path=ce_path,
            distinct=res.visited, generated=res.steps,
            diameter=res.diameter, levels=[],
            wall_seconds=res.wall_seconds, phase_seconds=dict(res.phases),
            swarm=swarm_block, memory=device_memory_stats(self.device))
        _FLIGHT.set_live_evlog(None)
        _FLIGHT.disarm()
        evlog.close()
        if self.tracer.enabled:
            self.tracer.complete("run", self._run_t0,
                                 engine=type(self).__name__,
                                 stop_reason=res.stop_reason)
            self.tracer.write()

    def _slices(self, seed32: int, n_roots: int):
        """Global walk ids 0..W-1 in ``batch``-lane slices, each walk on
        its hashed first root."""
        W, B, dev = self.walks, self.batch, self.device
        slices = []
        for i, off in enumerate(range(0, W, B)):
            ids = torch.arange(off, min(off + B, W), dtype=torch.int64,
                               device=dev)
            root0 = walk_bits(seed32, ids, 0, INIT_STREAM) % n_roots
            carry = Carry.fresh(self._roots.index_select(0, root0),
                                self.max_depth, self.ring, root0)
            slices.append(_Slice(ids, carry, i))
        return slices

    def _runner(self, s: _Slice, outs, res):
        """One chunk of slice ``s``: a graph replay on the card (the
        slice's walks staged in and out of the graph's buffers), the chunk
        itself on the CPU."""
        if self.device.type != "cuda":
            ys = self._ys(len(s.walk_ids))
            s.hunt = self._hunt_state()
            self._chunk(s.carry, s.walk_ids, self._roots, self._ctl,
                        outs[s.index], ys, s.hunt)
            return ys
        g, static, walk_ids, out, ys, hs = self._graph(len(s.walk_ids), res)
        static.copy_(s.carry)
        walk_ids.copy_(s.walk_ids)
        g.replay()
        s.carry.copy_(static)
        outs[s.index].copy_(out)
        if hs is not None:
            s.hunt = HuntState(None, hs.out.clone(), hs.steps.clone())
        return None if ys is None else ys.clone()

    def _run_impl(self, roots, res, seed, num_steps, max_seconds, t0):
        W, dev = self.walks, self.device
        bad, inv, encoded = check_roots(self.dims, roots, self._inv_id,
                                        self._inv_fns, dev)
        if bad is not None:
            hi, lo = self._fp(stack_states([encoded[bad]], dev))
            res.violation = Violation(
                invariant=self.inv_names[inv], state=roots[bad],
                fingerprint=(int(hi[0]) << 32) | int(lo[0]))
            res.violation_trace = [(-1, roots[bad])]
            self._last_trace = res.violation_trace
            res.stop_reason = "violation"
            res.violation_at_seconds = 0.0
            return
        self._stage_roots(root_rows(self.dims, encoded, dev))
        seed32 = seed & 0xFFFFFFFF
        k_limit = num_steps if num_steps is not None else NO_LIMIT
        slices = self._slices(seed32, len(roots))
        outs = torch.zeros((len(slices), OUT_VACTS + self.max_depth),
                           dtype=torch.int64, device=dev)
        res.traces = W
        fps_acc: List[np.ndarray] = []
        phases = res.phases
        k0 = 0
        last_progress = time.time()
        prof, pf, hacc = self._profiler, self._perf, self._hunt_acc
        tracer = self.tracer
        while True:
            if pf is not None and pf.wants_model(self._xla_capture):
                self._measure_launches(slices[0], outs, phases)
            if prof is not None and prof.want():
                t = time.time()
                with tracer.span("profile"):
                    prof.sample(slices[0].carry.rows,
                                torch.ones(len(slices[0].walk_ids),
                                           dtype=torch.bool, device=dev))
                phases["profile"] = (phases.get("profile", 0.0)
                                     + time.time() - t)
            t = time.time()
            t_span = time.perf_counter()
            self._ctl.copy_(torch.tensor([k0, seed32, k_limit]))
            cap0 = phases["capture"]
            cap = self._xla_capture
            with (cap.step() if cap is not None
                  else contextlib.nullcontext()):
                ys_all = [self._runner(s, outs, res) for s in slices]
            t_s = time.time()
            if tracer.enabled:
                tracer.complete("swarm_chunk", t_span)
            with tracer.span("swarm_fetch"):
                got = outs.tolist()                 # the chunk's one sync
                hunt_got = ([(s.hunt.out.tolist(),
                              s.hunt.steps.cpu().numpy()) for s in slices]
                            if hacc is not None else None)
            phases["dispatch"] += t_s - t - (phases["capture"] - cap0)
            phases["sync"] += time.time() - t_s
            if pf is not None:
                pf.add_chunk(len(slices), time.time() - t
                             - (phases["capture"] - cap0))
            stepped = (min(self.chunk, max(0, k_limit - k0))
                       if num_steps else self.chunk)
            k_start = k0
            k0 += self.chunk
            res.chunks += 1
            res.steps += W * stepped
            fired = []
            for row in got:
                res.traces += row[OUT_RESTARTS]
                res.visited += row[OUT_VISITED]
                res.diameter = max(res.diameter, row[OUT_DEPTH])
                if row[OUT_VF]:
                    fired.append(row)
            if self.collect_fingerprints:
                for ys in ys_all:
                    y = ys.cpu().numpy()
                    m = y[:, 2].reshape(-1).astype(bool)
                    fps_acc.append(np.stack(
                        [y[:, 0].reshape(-1)[m], y[:, 1].reshape(-1)[m]],
                        axis=1).astype(np.uint32))
            if hacc is not None:
                self._hunt_chunk(hacc, hunt_got, k_start, stepped)
            elapsed = time.time() - t0 - phases["capture"]
            now = time.time()
            if k0 == self.chunk \
                    or now - last_progress >= self.progress_seconds:
                last_progress = now
                res.wall_seconds = elapsed
                self._evlog.emit("swarm_progress", depth=k0,
                                 swarm=self._swarm_block(res))
                extra = {}
                if hacc is not None:
                    snap = hacc.snapshot()
                    mt = self.metrics
                    mt.gauge("hunt/saturation", snap["saturation"])
                    mt.gauge("hunt/unseen_mass", snap["unseen_mass"])
                    mt.gauge("hunt/distinct_observed",
                             snap["distinct_observed"])
                    mt.gauge("hunt/novel_rate", snap["novel_rate_recent"])
                    mt.gauge("hunt/revisit_rate", snap["revisit_rate"])
                    _FLIGHT.record("hunt", steps=res.steps, **snap)
                    extra["saturation"] = snap["saturation"]
                _FLIGHT.progress(mode="swarm", steps=res.steps,
                                 visited=res.visited, traces=res.traces,
                                 **extra)
            if fired:
                # The globally first violation in (step, walk) order: the
                # pick that does not depend on the slicing.
                latch = min(fired, key=lambda r: (r[OUT_VSTEP],
                                                  r[OUT_VWALK]))
                t = time.time()
                self._reconstruct(res, roots, latch)
                phases["replay"] += time.time() - t
                res.stop_reason = "violation"
                res.violation_at_seconds = round(elapsed, 6)
                break
            if max_seconds is not None and elapsed > max_seconds:
                res.stop_reason = "max_seconds"
                break
            if num_steps is not None and k0 >= num_steps:
                res.stop_reason = "steps"
                break
        if hacc is not None:
            b1 = self._blooms[0]
            hacc.bloom_load = float(torch.count_nonzero(b1)) / b1.numel()
        if self.collect_fingerprints:
            res.visited_fingerprints = (
                np.concatenate(fps_acc, axis=0) if fps_acc
                else np.zeros((0, 2), np.uint32))

    def _hunt_chunk(self, hacc, got, k_start: int, stepped: int) -> None:
        """One chunk's hunt tallies (every slice's) into the
        accumulator, in the JAX swarm's order."""
        D, F = self.max_depth, len(self.dims.family_sizes)
        series = None
        for out, steps in got:
            fams = out[H_SCALARS + D + 1:]
            hacc.add_slice(
                fresh=out[H_FRESH], promote=out[H_PROMOTE],
                reasons=(out[H_DEAD], out[H_OVF], out[H_CONS],
                         out[H_REVISIT], out[H_DBOUND]),
                depth_hist=out[H_SCALARS:H_SCALARS + D + 1],
                fam_chosen=fams[:F], fam_accept=fams[F:2 * F],
                fam_fresh=fams[2 * F:])
            series = steps if series is None else series + steps
        if stepped:
            hacc.add_steps(k_start + stepped, self.walks * stepped,
                           series[:stepped, 0].tolist(),
                           series[:stepped, 1].tolist())

    def _measure_launches(self, s: _Slice, outs, phases) -> None:
        """perf's launch model: one eager chunk of the first slice with
        every step frozen (it changes no walk)."""
        t = time.time()
        saved = self._ctl.clone()

        def frozen():
            self._ctl.zero_()
            self._chunk(s.carry, s.walk_ids, self._roots, self._ctl,
                        outs[s.index], self._ys(len(s.walk_ids)),
                        self._hunt_state())

        self._perf.measure(frozen)
        self._ctl.copy_(saved)
        phases["profile"] = phases.get("profile", 0.0) + time.time() - t

    def _reconstruct(self, res: SwarmResult, roots, latch):
        """Replay the latched (root, actions, choice) into the trace."""
        vinv, vlen = latch[OUT_VINV], latch[OUT_VLEN]
        acts = latch[OUT_VACTS:OUT_VACTS + vlen] + [latch[OUT_VCHOICE]]
        trace = replay_actions(self._v2, self.dims, roots[latch[OUT_VROOT]],
                               acts, self.device)
        res.violation = Violation(
            invariant=(self.inv_names[vinv]
                       if 0 <= vinv < len(self.inv_names) else "?"),
            state=trace[-1][1],
            fingerprint=(latch[OUT_VHI] << 32) | latch[OUT_VLO])
        res.violation_trace = trace
        res.violation_step = latch[OUT_VSTEP]
        res.violation_walk = latch[OUT_VWALK]
        self._last_trace = trace
