"""Mesh-sharded exhaustive BFS: the level loop over n shards.

The JAX package's ``parallel/mesh.py`` ``MeshBFSEngine``.  The JAX mesh
is one program over a list of devices (``shard_map``); so is this one:
one process drives a list of torch devices, and the collectives become
fixed-shape tensor exchanges between the shards.  A list that repeats a
device runs that many logical shards on it (the counterpart of the JAX
tests' virtual CPU devices), so one card runs every routing, insert and
enqueue path through the real kernels.  What a step does on each shard,
as in the JAX mesh:

- the shard expands its own batch: masks, and the compaction kernel;
- **shared P**: every shard advances by the least P over the shards (the
  JAX compactor's ``reduce_p=pmin``); each shard's lanes are cut to that
  prefix (``ops/compact.py cap_prefix``);
- **owner-routed insert** (``route_insert``): each valid fingerprint goes
  to its owner shard, ``hi mod n``, in [n, K] blocks padded with the
  empty key (a stable counting sort of the lanes by owner); block (s, d)
  goes to shard d, which runs the insert kernel on its n·K arrivals,
  source-major; the novelty bits go back the same way.  So ``is_new``
  lands on the lowest (source shard, lane) of each globally new key, and
  the shard that generated that copy enqueues its row (only keys cross
  between shards, never rows);
- the split tail's enqueue kernel appends the shard's new rows to its
  own next-level queue and its trace records to its own trace buffer.

The step's cond is reduced over the shards, so all take the same number
of steps: parents left and steps left, then for every shard its queue
at most ``QL - K`` rows, its seen set at most half full, its trace
buffer with room for a batch, and no violation, overflow, probe failure
or (when checked) deadlock on any shard.  The shapes are fixed and the
step makes no host read.  The step's four crossings between shards (the
cond's AND, the shared P's minimum, the owner blocks out, the novelty
bits back) go through an exchange object: ``ListExchange``, ``Tensor.to``
copies, within one process.  When every shard sits on one card the
whole n-shard step is one CUDA graph, replayed ``sync_every`` times as
``BFSEngine`` does (captured again after a growth); across distinct
cards it runs eagerly with the same device-side cond (no run across
cards has been measured).  The host reads one packed stats tensor a
chunk; sums and maxima over the shards are taken there.  The violation
and the deadlock come from the lowest-indexed flagged shard.

The level loop is ``BFSEngine``'s (whose run wrapper, degradation,
events, report, counterexample files and ``replay`` it inherits), with
the JAX mesh's rules: roots ingested round-robin across the shards in
B-sized waves; per-shard capacities ``QL = max(ceil(ceil(qreq/n)/B)·B,
K)`` and ``CL = pow2(max(ceil(sreq/n), 8K))`` (automatic sizes divide
each card's budget among the shards on it); a spill when any shard
passes its watermark drains every shard into one host pool, whose
segments are uploaded again balanced across the shards; a growth when
any shard passes half load rebuilds every shard at double capacity
(owners do not change); snapshots in the single engine's format (the
frontier rows and the flat key set), so n may change across a resume and
either engine resumes the other's; the skew telemetry of each level
(``_sample_skew``).

Across processes (``parallel/multihost.py``: the JAX package's
multi-controller mesh): m processes of L shards each run one mesh of
n = m·L global shards, process r owning shards r·L … r·L+L−1.  The
exchange is ``multihost.GroupExchange`` (``all_reduce`` and
``all_to_all_single``), and the step runs eagerly: gloo collectives
cannot sit in a CUDA graph.  The stats words are all-gathered, so every
controller reads every shard's; the violation and the deadlock come
from ``multihost.lowest_flagged``.  Each process uploads its own
shards' share of the roots, drains its own shards into its own pool and
uploads segments balanced over its own shards (a resumed frontier is
sliced ``fr[i::m]``); automatic capacities count the shards of every
process on a card (the cards' UUIDs all-gathered at start).  Every
decision from a host clock or a local pool goes through an agreement
before it steers a collective: the duration budget and chunk size
(``build_budget_agree``), the checkpoint interval, the ingest's budget
and whether any pool holds rows (``build_any``), a queue budget's pool
rows (``build_sum``), the resumed level (``build_min``).  Each
controller writes its piece of a snapshot (``checkpoint.piece_path``),
its own event log and ``counterexample.p{i}of{m}.*``; a traced run needs
``trace_dir`` (or ``checkpoint_dir``), where each controller writes its
trace records as ``trace_run_<id>.p{i}of{m}.npz`` at every run exit (the
id the least of the controllers' millisecond clocks) and ``replay``
merges the siblings' pieces once.  While no spill has re-placed a
frontier, the placements equal the one-process mesh's at the same n, so
the violation and its trace do too.  An out-of-memory error is raised,
not degraded, under a group.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..engine import checkpoint as ckpt_mod
from ..engine import chunk as chunk_mod
from ..engine.bfs import (PHASES, PLAN_NAMES, PLANS, BFSEngine,
                          EngineConfig, EngineResult, ResumePoint, Violation,
                          auto_capacities, check_resume_trace, device_memory,
                          exit_condition_hit, host_rows, por_device_arrays,
                          resolve_por)
from ..engine.chunk import (ST_COUNT, ST_DEAD, ST_OFFSET, ST_SEEN, ST_STEPS,
                            ST_TCOUNT, ST_VINV, ST_VIOL)
from ..engine.spillpool import SpillPool
from ..engine.trace import PyTraceStore
from ..models.actions2 import build_v2
from ..models.dims import RaftDims
from ..models.invariants import build_inv_id
from ..models.schema import ROW_DTYPE, state_width, unflatten_state
from ..obs import report as report_mod
from ..obs.coverage import ActionCoverage
from ..obs.events import RunEventLog, device_memory_stats, events_path
from ..obs.metrics import MetricsRegistry
from ..ops import compact as compact_mod
from ..ops import fpset
from ..ops.chunk_front import FrontOut
from ..ops.fingerprint import MASK32, build_fingerprint
from ..ops.fpset import EMPTY, pack
from ..ops.fpset_cuda import insert
from ..utils.device import resolve_device
from . import multihost as mh


def resolve_devices(devices=None) -> List[torch.device]:
    """The shards' devices: ``None`` is every visible card (raises with
    none); a list may repeat a device (logical shards) but not mix the
    CPU and cards."""
    if devices is None:
        if not torch.cuda.is_available() or not torch.cuda.device_count():
            raise RuntimeError(
                "devices=None takes every visible card, but "
                "torch.cuda.is_available() is False; pass devices=['cpu'] "
                "* n for CPU shards")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ValueError("the mesh needs at least one device")
    if len({d.type for d in out}) > 1:
        raise ValueError(f"mesh shards are all cards or all CPU, got {out}")
    return out


class ListExchange:
    """The crossings of a mesh step between the shards of one process
    (``devices``, shard order): ``Tensor.to`` copies, ordered with both
    devices' streams, so one card's whole step is one CUDA graph.  Under
    a process group ``multihost.GroupExchange`` does the same four
    operations as collectives."""

    def __init__(self, devices: List[torch.device]):
        self.devices = list(devices)
        self.n = len(self.devices)
        self.d0 = self.devices[0]

    def all(self, flags: List[torch.Tensor]) -> List[torch.Tensor]:
        """[1] bool a shard -> the AND over every shard, on each."""
        ok = torch.cat([f.to(self.d0) for f in flags]).all().view(1)
        return [ok.to(d) for d in self.devices]

    def min(self, vals: List[torch.Tensor]) -> List[torch.Tensor]:
        """The first word of each shard's tensor -> the least over every
        shard, [1] int64 on each."""
        P = torch.cat([v.narrow(0, 0, 1).to(self.d0)
                       for v in vals]).min().view(1).to(torch.int64)
        return [P.to(d) for d in self.devices]

    def to_owners(self, blocks: List[torch.Tensor]) -> List[torch.Tensor]:
        """``blocks[s]`` [n, k]: source s's block for each owner -> for
        each owner d its n·k arrivals, source-major."""
        return [torch.cat([blocks[s][d].to(dev) for s in range(self.n)])
                for d, dev in enumerate(self.devices)]

    def to_sources(self, nov: List[torch.Tensor]) -> List[torch.Tensor]:
        """``nov[d]`` [n, k]: owner d's novelty bits of each source's
        block -> for each source s its [n, k] bits, row d from owner d."""
        return [torch.stack([nov[d][s].to(dev) for d in range(self.n)])
                for s, dev in enumerate(self.devices)]


def route_insert(seens: List[fpset.FPSet], keys: List[torch.Tensor],
                 valid: List[torch.Tensor], exchange=None):
    """The JAX mesh's ``route_insert`` over n shards: ``keys[s]`` [k]
    packed keys of shard s with ``valid[s]``, each on its shard's device.
    Returns ``(new, fail)``: ``new[s]`` [k] bool on shard s's device,
    True on the lowest (source shard, lane) of each key in no shard's
    table before the call; ``fail[d]`` the insert's flag on owner d.
    Fixed shapes, no host read: the insert kernel runs once on each owner
    over n·k arrivals.  ``exchange`` carries the blocks between the
    shards (``ListExchange`` over the tables' devices by default); under
    a process group (``multihost.GroupExchange``) the lists hold this
    process's shards and n counts every process's."""
    ex = exchange or ListExchange([t.keys.device for t in seens])
    n = ex.n
    k = keys[0].shape[0]
    blocks, places = [], []
    for s in range(len(keys)):
        q = torch.where(valid[s], keys[s], EMPTY)
        owner = ((q >> 32) & MASK32) % n
        # Stable counting sort by owner: a lane's rank among the earlier
        # lanes of its owner is its place in that owner's block.
        onehot = owner.unsqueeze(0) == torch.arange(n, device=q.device
                                                    ).unsqueeze(1)
        rank = onehot.cumsum(1).gather(0, owner.view(1, -1)).view(-1) - 1
        place = owner * k + rank
        blocks.append(torch.full((n * k,), EMPTY, dtype=torch.int64,
                                 device=q.device).scatter_(0, place, q)
                      .view(n, k))
        places.append(place)
    nov, fail = [], []
    for d, arr in enumerate(ex.to_owners(blocks)):
        is_new, f = insert(seens[d], arr, arr != EMPTY)
        nov.append(is_new.view(n, k))
        fail.append(f)
    new = [back.view(-1).gather(0, place)
           for back, place in zip(ex.to_sources(nov), places)]
    return new, fail


class MeshStep:
    """One batch on every shard: ``step(qcur, seens, qnext, tbufs, css)``
    over lists indexed by (this process's) shard.  ``steps[s]`` is the
    ``ChunkStep`` of shard s's device (its cond, window, update and body
    stages); its ``count_word`` holds the shard's own row count and
    ``CUR`` the level's largest, so a shard's cond is the JAX cond's
    share.  ``exchange`` makes the step's crossings between shards."""

    def __init__(self, steps, devices, G: int, kspread, exchange):
        self.steps, self.devices = steps, devices
        self.n, self.G = len(devices), G
        self._kspr = kspread
        self.exchange = exchange

    def cond(self, seens, css) -> List[torch.Tensor]:
        """[1] bool a shard: whether the next step runs a batch."""
        return self.exchange.all([self.steps[s].cond(seens[s], css[s])
                                  for s in range(self.n)])

    def __call__(self, qcur, seens, qnext, tbufs, css) -> None:
        n, G = self.n, self.G
        a = self.cond(seens, css)
        wins, masked, comp = [], [], []
        for s in range(n):
            step = self.steps[s]
            rows, valid = step.window(qcur[s], css[s], a[s])
            m = step.body.stages.masks(rows, valid)
            wins.append((rows, valid))
            masked.append(m)
            comp.append(step.body.stages.compact(m[1]))
        P = self.exchange.min([pt for pt, _l, _k in comp])
        fronts = []
        for s in range(n):
            step = self.steps[s]
            Ps = P[s]
            states, en, ovf, pruned = masked[s]
            _pt, lane_id, kvalid = comp[s]
            total, lane_id, kvalid = compact_mod.cap_prefix(
                Ps, G, lane_id, kvalid, self._kspr[s])
            ptaken = step._arange_b < Ps
            kh, kl, krows, cons_ok, inv, php, plp = \
                step.body.stages.lanes(states, lane_id)
            fronts.append(FrontOut(
                en=en & ptaken[:, None], ovf=ovf & ptaken[:, None],
                pruned=pruned, P=Ps, total=total, lane_id=lane_id,
                kvalid=kvalid, kh=kh, kl=kl, krows=krows, cons_ok=cons_ok,
                inv=inv, parent_hi=php, parent_lo=plp))
        new, fail = route_insert(seens, [pack(f.kh, f.kl) for f in fronts],
                                 [f.kvalid for f in fronts], self.exchange)
        for s in range(n):
            step, fo, cs = self.steps[s], fronts[s], css[s]
            rows, valid = wins[s]
            count = step.body.stages.enqueue(
                qnext[s], cs.st.narrow(0, ST_COUNT, 1), fo.krows,
                new[s] & fo.cons_ok, step.Q)
            out = step.body.stages.finish(valid, fo, new[s], fail[s], count)
            step.update(out, rows, a[s], seens[s], tbufs[s], cs)


class MeshBFSEngine(BFSEngine):
    """Exhaustive checker sharded over ``devices`` (see the module doc);
    the same ``EngineResult``, ``run``, ``replay`` and ``successors`` as
    ``BFSEngine``.  Under a process group (``parallel/multihost.py``)
    ``devices`` are this process's L shards (None: the cards it sees),
    the mesh's n counts every process's shards, rank-major, and every
    process reads the same results."""

    def __init__(self, dims: RaftDims,
                 invariants: Optional[Dict[str, Callable]] = None,
                 constraint: Optional[Callable] = None,
                 config: Optional[EngineConfig] = None, devices=None):
        self.dims = dims
        self.config = cfg = config or EngineConfig()
        self.devices = devs = resolve_devices(devices)
        L = len(devs)
        self._mp = mp = mh.is_multiprocess()
        if mp:
            per_rank = mh.all_gather_objects(L)
            if len(set(per_rank)) > 1:
                raise ValueError(
                    "every process of the group must drive as many shards; "
                    f"the processes' shard counts are {per_rank}")
            self._pc, self._pi = len(per_rank), mh.process_index()
        else:
            self._pc, self._pi = 1, 0
        self._L, self._r0 = L, self._pi * L
        self.n_dev = n = self._pc * L
        self.device = dev0 = devs[0]
        if not hasattr(self, "metrics"):
            self.metrics = MetricsRegistry()
            self._evlog = RunEventLog(None)
        self.inv_names = list((invariants or {}).keys())
        self._inv_fns = list((invariants or {}).values())
        self._inv_id = (build_inv_id(self._inv_fns) if self._inv_fns
                        else None)
        self._constraint = constraint
        if cfg.pipeline not in PLAN_NAMES:
            raise ValueError(
                f"pipeline must be 'v3', 'v4', 'auto' or 'v2', got "
                f"{cfg.pipeline!r}: the JAX package's 'v1' plan is not "
                "ported (ROADMAP.md A7)")
        self._plan_name = PLAN_NAMES[cfg.pipeline]
        self._plan, self._plan_reasons, method = \
            PLANS[self._plan_name].resolve_mesh_plan(dev0,
                                                     cfg.enqueue_method)
        self._v2 = build_v2(dims, dev0)
        if cfg.checkpoint_dir is not None:
            ckpt_mod.check_dims_checkpointable(dims)
        self._por_table = resolve_por(cfg, dims, invariants or {},
                                      constraint)
        self._check_deadlock = (True if cfg.check_deadlock is None
                                else cfg.check_deadlock)
        if mp:
            # Host facts that steer a collective are agreed first
            # (multihost.py rule 4); a queue budget totals the pools.
            self._any = mh.build_any()
            self._agree_min = mh.build_min()
            self._budget = mh.build_budget_agree()
            self._pool_sum = (mh.build_sum() if any(
                c == "queue" for c, _t in cfg.exit_conditions) else None)
            self._exchange = mh.GroupExchange(devs, n)
        else:
            self._any = bool
            self._pool_sum = None
            self._exchange = ListExchange(devs)
        sw = state_width(dims)
        B, G = cfg.batch, dims.n_instances
        K = compact_mod.choose_k(B, G, cfg.compact_lanes)
        qreq, sreq = cfg.queue_capacity, cfg.seen_capacity
        if qreq is None or sreq is None:
            # Each card's budget divided among the shards on it, those of
            # every process on that card.
            cards = (sum(mh.all_gather_objects(
                [mh.card_key(d) for d in devs]), []) if mp else None)
            per = []
            for d in dict.fromkeys(devs):
                m = cards.count(mh.card_key(d)) if mp else devs.count(d)
                limit = device_memory(d)
                q, s = auto_capacities(sw, B, cfg.record_trace,
                                       None if limit is None else limit // m)
                if limit is None:
                    q, s = -(-q // m), -(-s // m)
                per.append((q, s))
            q, s = min(q for q, _s in per), min(s for _q, s in per)
            if mp:
                q, s = self._agree_min(q), self._agree_min(s)
            qreq = q * n if qreq is None else qreq
            sreq = s * n if sreq is None else sreq
        QL = max(-(-(-(-qreq // n)) // B) * B, K)
        self._CL = compact_mod.pow2(max(-(-sreq // n), 8 * K))
        self._sw, self._B, self._G, self._Q, self._K = sw, B, G, QL, K
        self._PAD = max(B, K)
        self._QTH = QL - K
        self._TQ = QL + K if cfg.record_trace else 0
        self._TA = self._TQ + K if cfg.record_trace else 1
        self._CH = max(1, cfg.sync_every)
        F = len(dims.family_sizes)
        self._CUR = chunk_mod.N_SCALARS + 3 * F
        self._W = chunk_mod.state_words(F) + 1
        by_dev, self._fps, kspr = {}, {}, {}
        for d in dict.fromkeys(devs):
            por_mask, por_priority = por_device_arrays(self._por_table, d)
            by_dev[d] = chunk_mod.ChunkStep(
                dims=dims, B=B, K=K, Q=QL, QTH=self._QTH, TQ=self._TQ,
                record_trace=cfg.record_trace,
                check_deadlock=self._check_deadlock, device=d,
                count_word=self._CUR + 3, v2=build_v2(dims, d),
                inv_fns=self._inv_fns, constraint=constraint, front=None,
                enqueue_method=method, por_mask=por_mask,
                por_priority=por_priority)
            self._fps[d] = build_fingerprint(dims, d)
            kspr[d] = compact_mod.kspread(B, G, K, d)
        self._fingerprint = self._fps[dev0]
        self._steps = [by_dev[d] for d in devs]
        self._mstep = MeshStep(self._steps, devs, G,
                               [kspr[d] for d in devs], self._exchange)
        # One CUDA graph for the whole step when every shard is on one
        # card and in this process; eager steps across cards, across
        # processes and on the CPU.
        self._graphable = (dev0.type == "cuda" and len(set(devs)) == 1
                           and not mp)
        self._graphs: Dict[tuple, tuple] = {}
        self._pool = None
        self._warm = False
        self._last_skew = None
        self.trace = PyTraceStore()

    def _rebuild_at_batch(self, new_batch: int) -> None:
        """The mesh again at a smaller batch (OOM degradation)."""
        self._drop_graphs()
        for name in ("_css", "_tbufs", "_ctl", "_st_groups"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        MeshBFSEngine.__init__(
            self, self.dims,
            invariants=dict(zip(self.inv_names, self._inv_fns)),
            constraint=self._constraint,
            config=dataclasses.replace(self.config, batch=new_batch),
            devices=self.devices)

    def _run_degradable(self, init_states, resume) -> EngineResult:
        """Under a process group an out-of-memory error is raised, not
        degraded: a retry on one controller would leave the others
        waiting in a collective."""
        if not self._mp:
            return BFSEngine._run_degradable(self, init_states, resume)
        return self._run_impl(init_states, resume)

    # -- the controllers -------------------------------------------------
    def _mine(self, xs: list) -> list:
        """This process's entries of a list over the global shards."""
        return xs[self._r0:self._r0 + self._L]

    def _gather(self, local: List[list]) -> List[list]:
        """Rows of ints, one a local shard -> one a global shard, the same
        on every process."""
        if not self._mp:
            return local
        return mh.gather_rows(torch.tensor(local, dtype=torch.int64)
                              ).tolist()

    def _lowest(self, flags, *values):
        """``(g, items of g)`` for the lowest global shard whose flag is
        set (``multihost.lowest_flagged``), from this process's flags and
        items (an item is needed only where its flag is set)."""
        if self._mp:
            return mh.lowest_flagged(flags, *values)
        g = next((s for s, f in enumerate(flags) if f), None)
        return (g,) + tuple(None if g is None else v[g] for v in values)

    def _pool_rows(self, local: int) -> int:
        """Rows in the host pools: this process's, totalled over the group
        when a queue budget reads them."""
        return self._pool_sum(local) if self._pool_sum is not None \
            else local

    def _events_path(self):
        """One event log a controller under a process group."""
        return events_path(self.config.events_out, self.config.checkpoint_dir,
                           self._pi, self._pc)

    def _run_start_fields(self) -> dict:
        if not self._mp:
            return {}
        return {"process_index": self._pi, "process_count": self._pc,
                "shards": self.n_dev, "transport": self._exchange.transport}

    def _counterexample_base(self) -> str:
        """One counterexample file a controller under a process group:
        each has merged its siblings' trace pieces, so the contents
        agree, but two controllers must not race one file."""
        if not self._mp:
            return "counterexample"
        return f"counterexample.p{self._pi}of{self._pc}"

    # -- device state --------------------------------------------------
    def _alloc_state(self, sw: int):
        """Each shard's ``ChunkState``; the state words of the shards on
        one device are rows of one tensor, so a chunk's control words go
        out in one copy a device and its stats come back in one read."""
        L, F = self._L, len(self.dims.family_sizes)
        groups: Dict[torch.device, List[int]] = {}
        for s, d in enumerate(self.devices):
            groups.setdefault(d, []).append(s)
        self._st_groups = []
        css = [None] * L
        for d, shards in groups.items():
            st = torch.zeros((len(shards), self._W), dtype=torch.int32,
                             device=d)
            self._st_groups.append((st, shards))
            for r, s in enumerate(shards):
                cs = chunk_mod.chunk_state(F, sw, d)
                css[s] = cs._replace(st=st[r])
        self._css = css
        self._ctl = torch.zeros((L, self._W), dtype=torch.int32,
                                pin_memory=self.device.type == "cuda")

    def _write_ctl(self, offset: int, next_counts, cur_counts,
                   max_steps: int):
        """A chunk's start on every shard: every counter zero but these
        (``next_counts``, ``cur_counts``: every global shard's)."""
        h, CUR = self._ctl, self._CUR
        h.zero_()
        h[:, ST_OFFSET] = offset
        h[:, ST_COUNT] = torch.tensor(self._mine(next_counts),
                                      dtype=torch.int32)
        h[:, CUR] = max(cur_counts)
        h[:, CUR + 1] = max_steps
        h[:, CUR + 3] = torch.tensor(self._mine(cur_counts),
                                     dtype=torch.int32)
        for st, shards in self._st_groups:
            src = h if len(shards) == self._L else h[shards]
            st.copy_(src, non_blocking=True)

    def _read_stats(self) -> List[list]:
        """Every global shard's state words: one read a device, and under
        a process group one all-gather."""
        if len(self._st_groups) == 1:
            rows = self._st_groups[0][0].tolist()
        else:
            rows = [None] * self._L
            for st, shards in self._st_groups:
                for s, r in zip(shards, st.tolist()):
                    rows[s] = r
        return self._gather(rows)

    # -- the chunk -----------------------------------------------------
    def _write_idle_ctl(self):
        self._write_ctl(0, [0] * self.n_dev, [0] * self.n_dev, 0)

    def _runner(self, qcur, qnext, seens, res):
        step, tbufs, css = self._mstep, self._tbufs, self._css

        def eager():
            step(qcur, seens, qnext, tbufs, css)

        if not self._graphable:
            return eager
        return self._graph_replay(
            tuple(t.data_ptr() for t in qcur + qnext)
            + tuple(s.keys.data_ptr() for s in seens), eager, res)

    def _dispatch(self, run, n: int, seens):
        """Queue n steps and the cond after them (no host wait)."""
        for _ in range(n):
            run()
        more = self._mstep.cond(seens, self._css)
        for cs, m in zip(self._css, more):
            cs.st.narrow(0, self._CUR + 2, 1).copy_(m)

    def _run_mesh_chunk(self, qcur, qnext, seens, cur_counts, offset: int,
                        next_counts, allowed: int, res):
        """``BFSEngine._run_chunk`` on the mesh: the shards' state words
        read once at the end, and the capture seconds."""
        t = time.time()
        run = self._runner(qcur, qnext, seens, res)
        captured = time.time() - t
        self._phase("capture", captured)
        self._write_ctl(offset, next_counts, cur_counts, allowed)
        if self.device.type != "cuda":
            t = time.time()
            while bool(self._mstep.cond(seens, self._css)[0]):
                run()
                res.steps += 1
            self._phase("dispatch", time.time() - t)
            return self._read_stats(), captured
        top = max(cur_counts)
        done, at = 0, offset
        while True:
            k = min(allowed - done, -(-(top - at) // self._B))
            t = time.time()
            self._dispatch(run, k, seens)
            res.steps += k
            t_s = time.time()
            st = self._read_stats()            # the chunk's device sync
            self._phase("dispatch", t_s - t)
            self._phase("sync", time.time() - t_s)
            if not st[0][self._CUR + 2]:
                return st, captured
            done, at = st[0][ST_STEPS], st[0][ST_OFFSET]

    # -- host side -----------------------------------------------------
    def _drain(self, qs, counts) -> np.ndarray:
        """This process's queued rows (``counts``: its shards') as one
        host array, in shard order."""
        segs = [host_rows(q[:c]) for q, c in zip(qs, counts) if c]
        return (np.concatenate(segs) if segs
                else np.zeros((0, self._sw), np.uint8))

    def _grow_shards(self, seens, sizes, res, t0):
        """Past half load on any shard, every shard at double capacity
        (off the duration clock; the graphs go with the old tables)."""
        if max(sizes) <= self._CL // 2:
            return seens, t0
        t = time.time()
        self._CL *= 2
        seens = [fpset.grow(s, self._CL) for s in seens]
        self._drop_graphs()
        stall = time.time() - t
        cap = self.n_dev * self._CL
        res.growth_stalls.append((cap, round(stall, 3)))
        self.metrics.counter("engine/fpset_resizes")
        self._evlog.emit("fpset_resize", capacity=cap,
                         stall_seconds=round(stall, 3),
                         memory=device_memory_stats(self.device))
        return seens, t0 + stall

    def _sample_skew(self, res, next_counts, sizes) -> None:
        """The JAX mesh's per-level balance telemetry: the shards'
        next-level rows on the device and seen-set sizes -> the
        ``mesh/*`` gauges, the skew fields of the level's row and event
        (``_last_skew``), and a ``skew`` event when the largest shard
        frontier reaches ``skew_warn_ratio`` times the mean.  Values the
        loop already read (every global shard's, under a process group
        too); rows drained to the host pool are not counted."""
        vals, sizes = [int(v) for v in next_counts], [int(v) for v in sizes]

        def ratio(xs):
            mean = sum(xs) / len(xs) if xs else 0.0
            return round(max(xs) / mean, 4) if mean > 0 else None

        fsk, ssk = ratio(vals), ratio(sizes)
        mt = self.metrics
        mt.gauge("mesh/shard_frontier_max", max(vals))
        mt.gauge("mesh/shard_frontier_min", min(vals))
        if fsk is not None:
            mt.gauge("mesh/frontier_skew", fsk)
        mt.gauge("mesh/shard_seen_max", max(sizes))
        if ssk is not None:
            mt.gauge("mesh/seen_skew", ssk)
        self._last_skew = {"frontier_skew": fsk, "seen_skew": ssk,
                           "shard_frontier": vals, "shard_seen": sizes}
        thr = self.config.skew_warn_ratio
        if fsk is not None and thr and fsk >= thr:
            mt.counter("mesh/skew_warnings")
            self._evlog.emit("skew", balance={
                "level": res.diameter, "frontier_skew": fsk,
                "seen_skew": ssk, "shard_frontier": vals,
                "threshold": thr})

    def _write_mesh_checkpoint(self, qcur, cur_counts, pending, seens, res,
                               trace, wall):
        """The single engine's snapshot: this level's frontier (device
        rows of every shard, then the host segments) and the union of
        the shards' keys.  Under a process group each controller writes
        its piece (``checkpoint.piece_path``): its shards, its pool, its
        trace records; ``checkpoint.load`` merges the group."""
        keys = np.concatenate([s.keys.cpu().numpy() for s in seens])
        keys = keys[keys != EMPTY].view(np.uint64)
        hi = (keys >> np.uint64(32)).astype(np.uint32)
        lo = (keys & np.uint64(MASK32)).astype(np.uint32)
        order = np.lexsort((lo, hi))
        path = (ckpt_mod.piece_path(self.config.checkpoint_dir, res.diameter,
                                    self._pi, self._pc)
                if self._mp else None)
        self._save_checkpoint(
            np.concatenate([self._drain(qcur, self._mine(cur_counts)),
                            *pending.segments()]),
            hi[order], lo[order], res, trace, wall, path=path)

    def _shards_from_keys(self, hi: np.ndarray, lo: np.ndarray):
        """This process's seen shards from a flat key set (owner ``hi mod
        n``), at a capacity that holds every shard at most half full."""
        hi = np.asarray(hi, np.uint32)
        lo = np.asarray(lo, np.uint32)
        owner = hi.astype(np.int64) % self.n_dev
        most = int(np.bincount(owner, minlength=self.n_dev).max()) \
            if len(hi) else 0
        while most > self._CL // 2:
            self._CL *= 2
        return [fpset.from_host_keys(hi[owner == d], lo[owner == d],
                                     self._CL, dev)
                for d, dev in enumerate(self.devices, self._r0)]

    def _ingest(self, rows_all, seens, qnext, spill_next, res, t0):
        """The roots, round-robin across the global shards in B-sized
        waves (each process uploads its own shards' share):
        fingerprinted, inserted through the routed insert, the novel
        constraint-passing ones enqueued on their shard.  Returns every
        shard's next-level count, the seen sizes, the tables, the rows
        drained to the host pool and t0."""
        cfg, n, B, sw = self.config, self.n_dev, self._B, self._sw
        mt, evlog = self.metrics, self._evlog
        per = [rows_all[i::n] for i in range(n)]
        waves = max(-(-p.shape[0] // B) for p in per)
        counts, sizes, spilled = [0] * n, [0] * n, 0
        for c in range(waves):
            left = sum(max(0, p.shape[0] - c * B) for p in per)
            if c and cfg.max_seconds is not None \
                    and self._any(time.time() - t0 > cfg.max_seconds):
                res.stop_reason = "duration_budget"
                break
            if c and cfg.exit_conditions:
                hit = exit_condition_hit(
                    cfg.exit_conditions, res,
                    sum(counts) + self._pool_rows(spill_next.total_rows())
                    + left)
                if hit:
                    res.stop_reason = hit
                    break
            t_h = time.time()
            wave = []
            for s, dev in enumerate(self.devices):
                part = per[self._r0 + s][c * B:(c + 1) * B].to(dev)
                rows = torch.zeros((B, sw), dtype=ROW_DTYPE, device=dev)
                rows[:part.shape[0]] = part
                valid = torch.arange(B, device=dev) < part.shape[0]
                cands = unflatten_state(rows, self.dims)
                fph, fpl = self._fps[dev](cands)
                wave.append((rows, valid, cands, fph, fpl))
            new, fail = route_insert(
                seens, [pack(w[3], w[4]) for w in wave],
                [w[1] for w in wave], self._exchange)
            local, flags, found = [], [], []
            for s, (rows, _v, cands, fph, fpl) in enumerate(wave):
                enq = new[s]
                if self._constraint is not None:
                    enq = enq & self._constraint(cands)
                idx = enq.nonzero().squeeze(1)
                at = counts[self._r0 + s]
                qnext[s][at:at + idx.shape[0]] = rows[idx]
                local.append([int(new[s].sum()), idx.shape[0],
                              int(seens[s].size[0]), int(bool(fail[s]))])
                self._record(new[s], fph, fpl)
                hit = None
                if self._inv_id is not None and (self._mp
                                                 or not any(flags)):
                    ids = self._inv_id(cands)
                    bad = new[s] & (ids >= 0)
                    if bool(bad.any()):
                        v = int(bad.to(torch.int32).argmax())
                        hit = (int(ids[v]), rows[v],
                               (int(fph[v]) << 32) | int(fpl[v]))
                flags.append(hit is not None)
                found.append(hit)
            glob = self._gather(local)
            n_new = sum(r[0] for r in glob)
            res.distinct += n_new
            mt.counter("engine/distinct", n_new)
            counts = [k + r[1] for k, r in zip(counts, glob)]
            if any(r[3] for r in glob):
                raise RuntimeError("seen-set probe failure during "
                                   "ingest; raise seen_capacity")
            sizes = [r[2] for r in glob]
            seens, t0 = self._grow_shards(seens, sizes, res, t0)
            if max(counts) > self._QTH:
                spill_next.append(self._drain(qnext, self._mine(counts)))
                spilled += sum(counts)
                res.spills += 1
                evlog.emit("spill", rows=sum(counts), level=0,
                           where="ingest")
                counts = [0] * n
            self._phase("host", time.time() - t_h)
            # (invariants, rows, fingerprints): an item a local shard.
            g, inv, row, fp = self._lowest(
                flags, *zip(*(h or (None,) * 3 for h in found)))
            if g is not None:
                viol = Violation(self.inv_names[int(inv)],
                                 self._decode_row(torch.as_tensor(row)),
                                 int(fp))
                res.violation = viol
                res.stop_reason = "violation"
                evlog.emit("violation", invariant=viol.invariant,
                           fingerprint=hex(viol.fingerprint), level=0)
                break
        return counts, sizes, seens, spilled, t0

    # -- the trace across controllers -----------------------------------
    def _trace_piece_path(self, i: int) -> str:
        """Controller i's trace piece of this run: the agreed run id keeps
        a reused directory's older pieces out of the merge."""
        d = self.config.trace_dir or self.config.checkpoint_dir
        return os.path.join(
            d, f"trace_run_{self._trace_run_id:08x}.p{i}of{self._pc}.npz")

    def _write_trace_piece(self, trace) -> None:
        """This controller's trace records, at every run exit (every
        controller takes the same exit), written atomically."""
        fps, parents, actions = trace.export()
        path = self._trace_piece_path(self._pi)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, fps=fps, parents=parents, actions=actions)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._trace_merged = False

    def _merge_trace_pieces(self) -> None:
        """Every sibling's piece of this run folded into the store, each
        polled for until ``trace_merge_timeout_seconds`` (None: 30 s plus
        the local piece's bytes at 8 MB/s, as a sibling of a large piece
        may still be writing its own)."""
        try:
            mine = os.path.getsize(self._trace_piece_path(self._pi))
        except OSError:
            mine = 0
        timeout = self.config.trace_merge_timeout_seconds
        if timeout is None:
            timeout = 30.0 + mine / (8 << 20)
        deadline = time.time() + timeout
        for i in range(self._pc):
            if i == self._pi:
                continue
            path = self._trace_piece_path(i)
            while not os.path.exists(path):
                if time.time() > deadline:
                    raise FileNotFoundError(
                        f"trace piece {path} not written within "
                        f"{timeout:.0f}s: controller {i} may still be "
                        f"writing it (this controller's was {mine} bytes) "
                        "or left the run abnormally; if it is just slow, "
                        "raise EngineConfig.trace_merge_timeout_seconds")
                time.sleep(0.05)
            with np.load(path) as z:
                self.trace.add_batch(z["fps"], z["parents"], z["actions"])

    def replay(self, fp: int):
        """``BFSEngine.replay``; under a process group the chain crosses
        controllers, so the siblings' trace pieces are merged first,
        once."""
        if self._mp and self.config.record_trace \
                and not getattr(self, "_trace_merged", True):
            self._merge_trace_pieces()
            self._trace_merged = True
        return BFSEngine.replay(self, fp)

    # ------------------------------------------------------------------
    def _resume_checkpoint(self, resume):
        """A snapshot's path or a ``Checkpoint`` -> the ``Checkpoint``.
        Under a process group the controllers resume the same level: the
        least any of them found (a directory listing can lag on a shared
        filesystem), as a piece group of any writer count or one file."""
        if not isinstance(resume, str):
            return resume
        ck = ckpt_mod.load(resume)
        if not self._mp:
            return ck
        agreed = self._agree_min(ck.diameter)
        if agreed == ck.diameter:
            return ck
        d = os.path.dirname(os.path.abspath(resume))
        group = sorted(glob.glob(os.path.join(
            d, f"level_{agreed:05d}.p0of*.npz")))
        return ckpt_mod.load(group[0] if group else os.path.join(
            d, f"level_{agreed:05d}.npz"))

    def _run_impl(self, init_states, resume) -> EngineResult:
        dims, cfg = self.dims, self.config
        n, L, sw, QL, devs = self.n_dev, self._L, self._sw, self._Q, \
            self.devices
        mp = self._mp
        label = (f"mesh of {n} over {self._pc} processes "
                 f"({self._exchange.transport}), process {self._pi}"
                 if mp else f"mesh of {n}")
        res = self._result = EngineResult(
            pipeline=self._plan_name, fused_stages=dict(self._plan),
            fused_reasons=dict(self._plan_reasons),
            device=label + ": " + ", ".join(str(d) for d in devs),
            por_instances=(self._por_table.certified
                           if self._por_table else 0),
            family_groups=report_mod.family_groups(dims))
        mt, evlog = self.metrics, self._evlog
        coverage = self.coverage = ActionCoverage(dims.family_names,
                                                  dims.family_sizes)
        if isinstance(resume, ResumePoint):
            raise TypeError("the mesh resumes from a snapshot's path or a "
                            "Checkpoint, not a single engine's ResumePoint")
        if resume is not None:
            ck = resume = self._resume_checkpoint(resume)
            if ck.dims != dims:
                raise ValueError(
                    f"checkpoint dims {ck.dims} != engine dims {dims}")
            check_resume_trace(cfg, ck)
        if mp and cfg.record_trace:
            if not (cfg.trace_dir or cfg.checkpoint_dir):
                raise NotImplementedError(
                    "multi-host trace recording needs trace_dir (or "
                    "checkpoint_dir) — a shared filesystem path, as for "
                    "multi-host checkpoints: controllers exchange their "
                    "trace stores as piece files there.  Alternatively "
                    "run with record_trace=False and pass the "
                    "violation's .state to engine.check.path_to_state "
                    "on one host — BFS order makes the result a "
                    "minimal-depth trace")
            self._trace_run_id = self._agree_min(
                int(time.time() * 1000) & 0x7FFFFFFF)
        res.phases.update(dict.fromkeys(PHASES, 0.0))
        trace = self.trace = PyTraceStore()
        t_enter = time.time()
        QLA = QL + self._PAD

        def queues():
            return [torch.zeros((QLA, sw), dtype=ROW_DTYPE, device=d)
                    for d in devs]

        qcur, qnext = queues(), queues()
        self._tbufs = [torch.zeros((self._TA, chunk_mod.TRACE_ROW),
                                   dtype=torch.uint8, device=d)
                       for d in devs]
        self._alloc_state(sw)
        pending = SpillPool(cfg.spill_dir)      # host segments of this level
        spill_next = SpillPool(cfg.spill_dir)   # host segments of the next

        t0 = time.time()
        if resume is not None:
            seens = self._shards_from_keys(resume.seen_hi, resume.seen_lo)
            fr = np.ascontiguousarray(resume.frontier).astype(
                np.uint8, casting="safe")
            # Each controller takes its slice; segments of what one
            # upload takes.
            fr = fr[self._pi::self._pc]
            for i in range(0, fr.shape[0], L * QL):
                pending.append(fr[i:i + L * QL])
            cur_counts = [0] * n
            sizes = self._gather([[int(s.size[0])] for s in seens])
            sizes = [r[0] for r in sizes]
            res.distinct, res.generated = resume.distinct, resume.generated
            res.diameter, res.levels = resume.diameter, list(resume.levels)
            res.action_counts = dict(resume.action_counts)
            coverage.seed_generated(resume.action_counts)
            t0 -= resume.wall_seconds
            if cfg.record_trace and resume.trace_fps.size:
                trace.add_batch(resume.trace_fps, resume.trace_parents,
                                resume.trace_actions)
                trace.roots.update(resume.roots)
        else:
            rows_all = self._root_rows(init_states, res, trace, t_enter)
            if rows_all is None:
                if mp and cfg.record_trace:
                    self._write_trace_piece(trace)
                return res
            seens = [fpset.empty(self._CL, d) for d in devs]
            t0 = time.time()
            counts, sizes, seens, spilled, t0 = self._ingest(
                rows_all, seens, qnext, spill_next, res, t0)
            res.levels.append(sum(counts) + spilled)
            mt.gauge("engine/seen_capacity", self._CL)
            mt.gauge("engine/seen_size", max(sizes))
            self._sample_skew(res, counts, sizes)
            self._emit_level_event(res, res.levels[-1])
            qcur, qnext = qnext, qcur
            cur_counts = counts
            pending, spill_next = spill_next, pending

        mt.gauge("engine/seen_capacity", self._CL)
        mt.gauge("engine/seen_size", max(sizes))
        self._batch_ema = 0.0
        last_progress = time.time()
        skip_ckpt_level = resume.diameter if resume is not None else -1
        last_ckpt = time.time() if resume is not None else float("-inf")
        carry = None           # the rest of a segment too large to upload
        while (max(cur_counts) > 0 or self._any(bool(pending))) \
                and res.violation is None \
                and res.stop_reason == "exhausted":
            if cfg.checkpoint_dir is not None \
                    and res.diameter % max(1, cfg.checkpoint_every) == 0 \
                    and res.diameter != skip_ckpt_level \
                    and self._any(time.time() - last_ckpt
                                  >= cfg.checkpoint_interval_seconds):
                t_h = time.time()
                self._write_mesh_checkpoint(qcur, cur_counts, pending, seens,
                                            res, trace, wall=t_h - t0)
                last_ckpt = time.time()
                self._phase("checkpoint", last_ckpt - t_h)
                evlog.emit("checkpoint", level=res.diameter,
                           distinct=res.distinct)
            if cfg.max_diameter is not None \
                    and res.diameter >= cfg.max_diameter:
                res.stop_reason = "diameter_budget"
                break
            next_counts = [0] * n
            spilled = 0
            calls_in_level = 0
            while True:
                offset = 0
                top = max(cur_counts)
                while offset < top:
                    allowed = self._CH
                    if cfg.max_seconds is not None:
                        remaining = cfg.max_seconds - (time.time() - t0)
                        over = remaining <= 0
                        allowed = (max(1, min(
                            self._CH, int(remaining / (2 * self._batch_ema)),
                            2 << min(calls_in_level, 9)))
                            if self._batch_ema else 1)
                        if mp:
                            # An input of the collective steps: one round
                            # trip agrees the stop and the least budget.
                            over, allowed = self._budget(over, allowed)
                            allowed = max(1, allowed)
                        if over:
                            res.stop_reason = "duration_budget"
                            break
                    calls_in_level += 1
                    t_call = time.time()
                    st, captured = self._run_mesh_chunk(
                        qcur, qnext, seens, cur_counts, offset, next_counts,
                        allowed, res)
                    t0 += captured
                    t_h = time.time()
                    res.chunks += 1
                    r0 = st[0]
                    steps = r0[ST_STEPS]
                    if steps:
                        per = (t_h - t_call - captured) / steps
                        self._batch_ema = (per if not self._batch_ema else
                                           max(per, 0.5 * self._batch_ema
                                               + 0.5 * per))
                    res.batches += steps
                    offset = r0[ST_OFFSET]
                    next_counts = [r[ST_COUNT] for r in st]
                    sizes = [r[ST_SEEN] for r in st]
                    total = [sum(col) for col in zip(*st)]
                    self._account_chunk(res, total, max(sizes), self._CL,
                                        sum(next_counts))
                    inner = 0.0
                    if cfg.record_trace and total[ST_TCOUNT]:
                        t_t = time.time()
                        for tbuf, r in zip(self._tbufs, self._mine(st)):
                            if r[ST_TCOUNT]:
                                self._flush_trace(tbuf, r[ST_TCOUNT])
                        inner = time.time() - t_t
                        self._phase("trace", inner)
                    self._check_faults(total)
                    seens, t0 = self._grow_shards(seens, sizes, res, t0)
                    if max(next_counts) > self._QTH \
                            and (offset < top or self._any(
                                bool(pending) or carry is not None)):
                        t_s = time.time()
                        spill_next.append(self._drain(
                            qnext, self._mine(next_counts)))
                        spilled += sum(next_counts)
                        res.spills += 1
                        evlog.emit("spill", rows=sum(next_counts),
                                   level=res.diameter, where="chunk_loop")
                        next_counts = [0] * n
                        self._phase("spill", time.time() - t_s)
                        inner += time.time() - t_s
                    # The lowest-indexed flagged shard's violation or
                    # deadlock.
                    viol = dead = None
                    if any(r[ST_VIOL] for r in st):
                        g, vrow, vfp = self._lowest(
                            [r[ST_VIOL] for r in self._mine(st)],
                            [cs.vrow for cs in self._css],
                            [cs.vfp for cs in self._css])
                        viol = (st[g][ST_VINV], chunk_mod.ChunkState(
                            None, torch.as_tensor(vrow),
                            torch.as_tensor(vfp), None))
                    if self._check_deadlock and any(r[ST_DEAD] for r in st):
                        _g, drow = self._lowest(
                            [r[ST_DEAD] for r in self._mine(st)],
                            [cs.drow for cs in self._css])
                        dead = chunk_mod.ChunkState(None, None, None,
                                                    torch.as_tensor(drow))
                    last_progress = self._verdict(
                        res, viol, dead,
                        lambda: (sum(max(0, c - offset) for c in cur_counts)
                                 + self._pool_rows(
                                     pending.total_rows()
                                     + (len(carry) if carry is not None
                                        else 0)
                                     + spill_next.total_rows())
                                 + sum(next_counts)),
                        sum(cur_counts), max(sizes) / self._CL, t0,
                        last_progress)
                    self._phase("host", time.time() - t_h - inner)
                    if res.stop_reason != "exhausted":
                        break
                if res.stop_reason != "exhausted" \
                        or not self._any(carry is not None or bool(pending)):
                    break
                # The next host segment, balanced across this process's
                # shards (each controller uploads from its own pool).
                t_s = time.time()
                if carry is None and pending:
                    carry = np.require(pending.pop(0),
                                       requirements=["C", "W"])
                piece = (carry if carry is not None
                         else np.zeros((0, sw), np.uint8))
                cap = L * QL
                piece, carry = piece[:cap], (piece[cap:] if len(piece) > cap
                                             else None)
                share = -(-len(piece) // L)
                local = []
                for s, dev in enumerate(devs):
                    part = piece[s * share:(s + 1) * share]
                    qcur[s][:len(part)] = torch.from_numpy(
                        np.ascontiguousarray(part)).to(dev)
                    local.append([len(part)])
                cur_counts = [r[0] for r in self._gather(local)]
                self._phase("spill", time.time() - t_s)
            if res.stop_reason != "exhausted":
                break
            res.diameter += 1
            res.levels.append(sum(next_counts) + spilled)
            self._sample_skew(res, next_counts, sizes)
            self._emit_level_event(res, res.levels[-1])
            qcur, qnext = qnext, qcur
            cur_counts = next_counts
            pending, spill_next = spill_next, pending
        res.wall_seconds = time.time() - t0
        if mp and cfg.record_trace:
            self._write_trace_piece(trace)
        return res
