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

The level loop is ``BFSEngine._run_impl`` (whose run wrapper,
degradation, events, report, counterexample files and ``replay`` it
inherits); the mesh overrides the steps it calls for one shard, with
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

import glob
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..engine import checkpoint as ckpt_mod
from ..engine import chunk as chunk_mod
from ..engine.bfs import (PLANS, BFSEngine, EngineConfig, EngineResult,
                          ResumePoint, auto_capacities, check_resume_trace,
                          device_memory, host_rows, por_device_arrays)
from ..engine.chunk import (ST_COUNT, ST_DEAD, ST_OFFSET, ST_STEPS,
                            ST_TCOUNT, ST_VINV, ST_VIOL)
from ..models.actions import build_expand
from ..models.actions2 import build_v2
from ..models.dims import RaftDims
from ..models.schema import ROW_DTYPE, unflatten_state
from ..obs.events import device_memory_stats, events_path
from ..ops import compact as compact_mod
from ..ops import fpset
from ..ops.chunk_front import FrontOut
from ..ops.fingerprint import MASK32, build_fingerprint
from ..ops.fpset import EMPTY, pack
from ..ops.fpset_cuda import insert
from ..resilience import faults as _faults
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
        P = self.exchange.min([c[0].view(1) for c in comp])
        fronts = []
        for s in range(n):
            step = self.steps[s]
            Ps = P[s]
            states, en, ovf, pruned = masked[s]
            _P, _total, lane_id, kvalid = comp[s]
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


#: The exchange's crossings a step: the cond's AND, the shared P's
#: minimum, the owner blocks out and the novelty bits back.
EXCHANGE_CROSSINGS = 4


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
        cfg = config or EngineConfig()
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
            self._pool_sum = None
            self._exchange = ListExchange(devs)
        BFSEngine.__init__(self, dims, invariants, constraint, cfg, devs[0])

    def _trace_out(self):
        """One trace file a controller under a process group."""
        trace_out = self.config.trace_out
        if trace_out is not None and self._pc > 1:
            root, ext = os.path.splitext(trace_out)
            trace_out = f"{root}.p{self._pi}of{self._pc}{ext or '.json'}"
        return trace_out

    def _resolve_plan(self):
        return PLANS[self._plan_name].resolve_mesh_plan(
            self.device, self.config.enqueue_method)

    def _size_tables(self, sw: int, B: int, K: int) -> int:
        """Per-shard capacities ``QL = max(ceil(ceil(qreq/n)/B)·B, K)`` and
        ``CL = pow2(max(ceil(sreq/n), 8K))``; automatic sizes divide each
        card's budget among the shards on it, those of every process on
        that card."""
        cfg, devs, n = self.config, self.devices, self.n_dev
        qreq, sreq = cfg.queue_capacity, cfg.seen_capacity
        if qreq is None or sreq is None:
            cards = (sum(mh.all_gather_objects(
                [mh.card_key(d) for d in devs]), []) if self._mp else None)
            per = []
            for d in dict.fromkeys(devs):
                m = cards.count(mh.card_key(d)) if self._mp \
                    else devs.count(d)
                limit = device_memory(d)
                q, s = auto_capacities(sw, B, cfg.record_trace,
                                       None if limit is None else limit // m)
                if limit is None:
                    q, s = -(-q // m), -(-s // m)
                per.append((q, s))
            q, s = min(q for q, _s in per), min(s for _q, s in per)
            if self._mp:
                q, s = self._agree_min(q), self._agree_min(s)
            qreq = q * n if qreq is None else qreq
            sreq = s * n if sreq is None else sreq
        self._CL = compact_mod.pow2(max(-(-sreq // n), 8 * K))
        return max(-(-(-(-qreq // n)) // B) * B, K)

    def _build_step(self) -> None:
        """Each shard's ``ChunkStep`` (one a device) under one
        ``MeshStep``, the fingerprints, and perf's launch accounting."""
        cfg, dims, devs = self.config, self.dims, self.devices
        B, G, K, v1 = self._B, self._G, self._K, self._plan_name == "v1"
        F = len(dims.family_sizes)
        self._CUR = chunk_mod.N_SCALARS + 3 * F
        # The shard's own row count, past the single engine's words.
        self._OWN = chunk_mod.state_words(F)
        self._W = self._OWN + 1
        by_dev, self._fps, kspr = {}, {}, {}
        for d in dict.fromkeys(devs):
            por_mask, por_priority = por_device_arrays(self._por_table, d)
            by_dev[d] = chunk_mod.ChunkStep(
                dims=dims, B=B, K=K, Q=self._Q, QTH=self._QTH, TQ=self._TQ,
                record_trace=cfg.record_trace,
                check_deadlock=self._check_deadlock, device=d,
                count_word=self._OWN, v2=build_v2(dims, d),
                expand=build_expand(dims, d) if v1 else None,
                inv_fns=self._inv_fns, constraint=self._constraint,
                front=None, enqueue_method=self._method,
                por_mask=por_mask, por_priority=por_priority)
            self._fps[d] = build_fingerprint(dims, d)
            kspr[d] = compact_mod.kspread(B, G, K, d)
        self._fingerprint = self._fps[self.device]
        self._steps = [by_dev[d] for d in devs]
        self._mstep = MeshStep(self._steps, devs, G,
                               [kspr[d] for d in devs], self._exchange)
        # No front on the mesh (v4 resolves to v3's arrangement).
        self._front, self._front_info = None, None
        # One CUDA graph for the whole step when every shard is on one
        # card and in this process; eager steps across cards, across
        # processes and on the CPU.
        self._graphable = (self.device.type == "cuda"
                           and len(set(devs)) == 1 and not self._mp)
        self._last_skew = None
        # The chunk profiler is a one-device instrument, as in the JAX
        # mesh; perf keeps launch accounting and the exchange's probe.
        self._profiler = None
        self._perf = None
        if cfg.perf:
            from ..obs import perf as perf_mod
            self._perf = perf_mod.PerfAccounting(
                pipeline=self._plan_name, stage_traffic=None,
                device=self.device, metrics=self.metrics,
                collectives_per_batch=EXCHANGE_CROSSINGS)

    def _postmortem_path(self):
        """One postmortem piece a controller under a process group."""
        base = BFSEngine._postmortem_path(self)
        if base is None:
            return None
        return events_path(base, None, self._pi, self._pc)

    _RUN_BUFFERS = ("_css", "_tbufs", "_ctl", "_st_groups")

    def _finish(self, err):
        """``BFSEngine._finish``, the graphs dropped first: the mesh's
        queues, tables and states are its run's own (``_run_buffers``
        allocates them anew), so a graph captured on them must not
        outlive the run (a queue that lands at the same address would
        key it to the next run's other buffers)."""
        self._drop_graphs()
        BFSEngine._finish(self, err)

    def _run_degradable(self, init_states, resume) -> EngineResult:
        """Under a process group an out-of-memory error is raised, not
        degraded: a retry on one controller would leave the others
        waiting in a collective.  Every controller takes the same exit
        and writes its trace piece there."""
        if not self._mp:
            return BFSEngine._run_degradable(self, init_states, resume)
        res = self._run_impl(init_states, resume)
        if self.config.record_trace:
            self._write_trace_piece(self.trace)
        return res

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
        h[:, self._OWN] = torch.tensor(self._mine(cur_counts),
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

    def _eager(self, qcur, qnext, seens):
        step, tbufs, css = self._mstep, self._tbufs, self._css
        return lambda: step(qcur, seens, qnext, tbufs, css)

    def _runner(self, qcur, qnext, seens, res):
        eager = self._eager(qcur, qnext, seens)
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

    def _chunk_call(self, qcur, qnext, seens, cur_counts, offset: int,
                    next_counts, allowed: int, res):
        """``BFSEngine._run_chunk`` on the mesh: every global shard's state
        words read once at the end, and the capture seconds."""
        t = time.perf_counter()
        run = self._runner(qcur, qnext, seens, res)
        captured = time.perf_counter() - t
        self._phase("capture", captured)
        self._write_ctl(offset, next_counts, cur_counts, allowed)
        tracer = self.tracer
        t_span = time.perf_counter()
        if self.device.type != "cuda":
            t = time.perf_counter()
            while bool(self._mstep.cond(seens, self._css)[0]):
                run()
                res.steps += 1
            self._phase("dispatch", time.perf_counter() - t)
            if tracer.enabled:
                tracer.complete("chunk", t_span)
            with self._span("stats_fetch"):
                return self._read_stats(), captured
        top = max(cur_counts)
        done, at = 0, offset
        while True:
            k = min(allowed - done, -(-(top - at) // self._B))
            t = time.perf_counter()
            self._dispatch(run, k, seens)
            res.steps += k
            t_s = time.perf_counter()
            t_f = time.perf_counter()
            st = self._read_stats()            # the chunk's device sync
            self._phase("dispatch", t_s - t)
            self._phase("sync", time.perf_counter() - t_s)
            if not st[0][self._CUR + 2]:
                if tracer.enabled:
                    tracer.complete("chunk", t_span)
                    tracer.complete("stats_fetch", t_f)
                return st, captured
            done, at = st[0][ST_STEPS], st[0][ST_OFFSET]

    # -- host side -----------------------------------------------------
    def _drain(self, qs, counts) -> np.ndarray:
        """This process's queued rows (``counts``: its shards') as one
        host array, in shard order."""
        segs = [host_rows(q[:c]) for q, c in zip(qs, counts) if c]
        return (np.concatenate(segs) if segs
                else np.zeros((0, self._sw), np.uint8))

    def _maybe_grow(self, seens, size: int, res, t0):
        """Past half load on any shard (``size``: the largest), every
        shard at double capacity (off the duration clock; the graphs go
        with the old tables)."""
        if size <= self._CL // 2:
            return seens, t0
        self._grow_attempts = getattr(self, "_grow_attempts", 0) + 1
        if _faults.ACTIVE:
            # A growth that runs out here propagates to the degradation
            # wrapper (halve the batch, resume): the per-shard rebuild has
            # no safe retry point midway, as in the JAX mesh.
            _faults.fire("oom", grow=self._grow_attempts)
        t = time.perf_counter()
        self._CL *= 2
        seens = [fpset.grow(s, self._CL) for s in seens]
        self._drop_graphs()
        stall = time.perf_counter() - t
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
        if self._perf is not None:
            self._exchange_probe()

    def _exchange_probe(self) -> None:
        """perf: one timed crossing of the exchange, an ``all_reduce``
        across processes (an agreement round), a ``Tensor.to`` round over
        the shards' devices in one process."""
        from ..obs import perf as perf_mod
        if self._mp:
            if not hasattr(self, "_sum_probe"):
                self._sum_probe = mh.build_sum()
                self._sum_probe(1)
            fn, args = self._sum_probe, (1,)
        else:
            x = torch.ones(1, device=self.device)

            def fn():
                for d in self.devices:
                    y = x.to(d)
                return float(y.to(self.device)[0])
            args = ()
        self._perf.note_collective_probe(
            perf_mod.timed_collective_probe(fn, *args,
                                            warm=not self._mp))

    def _write_checkpoint(self, qcur, cur_counts, pending, seens, res,
                          trace, wall):
        """The single engine's snapshot: this level's frontier (device
        rows of every shard, then the host segments) and the union of
        the shards' keys.  Under a process group each controller writes
        its piece (``checkpoint.piece_path``): its shards, its pool, its
        trace records; ``checkpoint.load`` merges the group."""
        hi, lo = (np.concatenate(k) for k in zip(
            *(fpset.to_host_keys(s) for s in seens)))
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

    def _ingest_wave(self, parts, seens, qnext, counts):
        """``BFSEngine._ingest_wave`` over the shards: each process
        uploads its own shards' parts, the keys go through the routed
        insert, and the novel constraint-passing roots are enqueued on
        the shard that holds them.  The violating root is the lowest
        flagged shard's."""
        B, sw = self._B, self._sw
        wave = []
        for s, dev in enumerate(self.devices):
            part = parts[self._r0 + s].to(dev)
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
            if self._inv_id is not None and (self._mp or not any(flags)):
                ids = self._inv_id(cands)
                bad = new[s] & (ids >= 0)
                if bool(bad.any()):
                    v = int(bad.to(torch.int32).argmax())
                    hit = (int(ids[v]), rows[v],
                           (int(fph[v]) << 32) | int(fpl[v]))
            flags.append(hit is not None)
            found.append(hit)
        glob = self._gather(local)
        # (invariants, rows, fingerprints): an item a local shard.
        g, inv, row, fp = self._lowest(
            flags, *zip(*(h or (None,) * 3 for h in found)))
        return (sum(r[0] for r in glob),
                [k + r[1] for k, r in zip(counts, glob)],
                [r[2] for r in glob], any(r[3] for r in glob),
                None if g is None else (int(inv), torch.as_tensor(row),
                                        int(fp)))

    def _spill_sync(self, qnext, counts, spill_next):
        """This process's shards drained into its host pool."""
        spill_next.append(self._drain(qnext, self._mine(counts)))

    def _spill(self, qnext, counts, spill_next):
        self._spill_sync(qnext, counts, spill_next)
        return qnext

    def _land_spills(self, spill_next):
        """Nothing in flight: the mesh drains at once."""

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
        if _faults.ACTIVE:
            # An injected slow sibling: exercises the merge's poll and
            # deadline without a slow host.
            _faults.fire("trace_piece_delay", piece=self._pi)
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
        deadline = time.perf_counter() + timeout
        for i in range(self._pc):
            if i == self._pi:
                continue
            path = self._trace_piece_path(i)
            while not os.path.exists(path):
                if time.perf_counter() > deadline:
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

    # -- the level loop's steps over the shards (BFSEngine._run_impl) ---
    def _device_name(self) -> str:
        label = (f"mesh of {self.n_dev} over {self._pc} processes "
                 f"({self._exchange.transport}), process {self._pi}"
                 if self._mp else f"mesh of {self.n_dev}")
        return label + ": " + ", ".join(str(d) for d in self.devices)

    def _resume_source(self, resume):
        """A snapshot's path or a ``Checkpoint`` -> the ``Checkpoint``,
        held to the engine's dims and trace recording.  Under a process
        group the controllers resume the same level: the least any of
        them found (a directory listing can lag on a shared filesystem),
        as a piece group of any writer count or one file; a traced run
        agrees its id."""
        cfg = self.config
        if isinstance(resume, ResumePoint):
            raise TypeError("the mesh resumes from a snapshot's path or a "
                            "Checkpoint, not a single engine's ResumePoint")
        if isinstance(resume, str):
            path, resume = resume, ckpt_mod.load(resume)
            agreed = (self._agree_min(resume.diameter) if self._mp
                      else resume.diameter)
            if agreed != resume.diameter:
                d = os.path.dirname(os.path.abspath(path))
                group = sorted(glob.glob(os.path.join(
                    d, f"level_{agreed:05d}.p0of*.npz")))
                resume = ckpt_mod.load(group[0] if group else os.path.join(
                    d, f"level_{agreed:05d}.npz"))
        if resume is not None:
            if resume.dims != self.dims:
                raise ValueError(f"checkpoint dims {resume.dims} != engine "
                                 f"dims {self.dims}")
            check_resume_trace(cfg, resume)
        if self._mp and cfg.record_trace:
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
        return resume

    def _run_buffers(self, fresh_table: bool):
        """Each shard's queues, trace buffer and chunk state, the run's
        own, and its empty table when ``fresh_table``."""
        devs, shape = self.devices, (self._Q + self._PAD, self._sw)
        qcur, qnext = ([torch.zeros(shape, dtype=ROW_DTYPE, device=d)
                        for d in devs] for _ in range(2))
        self._tbufs = [torch.zeros((self._TA, chunk_mod.TRACE_ROW),
                                   dtype=torch.uint8, device=d)
                       for d in devs]
        self._alloc_state(self._sw)
        self._carry = None     # the rest of a segment too large to upload
        seens = ([fpset.empty(self._CL, d) for d in devs] if fresh_table
                 else None)
        return qcur, qnext, seens

    def _resume_into(self, ck, qcur, pending, trace):
        """The snapshot's keys sharded by owner, this controller's slice
        of its frontier (``fr[i::m]``) in host segments of what one
        upload takes, and its trace records."""
        seens = self._shards_from_keys(ck.seen_hi, ck.seen_lo)
        fr = np.ascontiguousarray(ck.frontier).astype(np.uint8,
                                                       casting="safe")
        fr, cap = fr[self._pi::self._pc], self._L * self._Q
        for i in range(0, fr.shape[0], cap):
            pending.append(fr[i:i + cap])
        sizes = self._gather([[int(s.size[0])] for s in seens])
        if self.config.record_trace and ck.trace_fps.size:
            trace.add_batch(ck.trace_fps, ck.trace_parents,
                            ck.trace_actions)
            trace.roots.update(ck.roots)
        return seens, [0] * self.n_dev, [r[0] for r in sizes]

    def _seen_capacity(self, seens) -> int:
        return self._CL

    def _flush_rows(self, rows):
        for tbuf, r in zip(self._tbufs, self._mine(rows)):
            if r[ST_TCOUNT]:
                self._flush_trace(tbuf, r[ST_TCOUNT])

    def _flagged(self, rows):
        """The lowest-indexed flagged shard's violation and deadlock."""
        viol = dead = None
        if any(r[ST_VIOL] for r in rows):
            g, vrow, vfp = self._lowest(
                [r[ST_VIOL] for r in self._mine(rows)],
                [cs.vrow for cs in self._css], [cs.vfp for cs in self._css])
            viol = (rows[g][ST_VINV], chunk_mod.ChunkState(
                None, torch.as_tensor(vrow), torch.as_tensor(vfp), None))
        if self._check_deadlock and any(r[ST_DEAD] for r in rows):
            _g, drow = self._lowest([r[ST_DEAD] for r in self._mine(rows)],
                                    [cs.drow for cs in self._css])
            dead = chunk_mod.ChunkState(None, None, None,
                                        torch.as_tensor(drow))
        return viol, dead

    def _host_left(self, pending) -> bool:
        return self._any(bool(pending) or self._carry is not None)

    def _host_rows(self, pending, spill_next) -> int:
        """Rows in the host pools: this process's, totalled over the group
        when a queue budget reads them."""
        local = (pending.total_rows() + spill_next.total_rows()
                 + (len(self._carry) if self._carry is not None else 0))
        return self._pool_sum(local) if self._pool_sum is not None \
            else local

    def _upload(self, qcur, pending):
        """The next host segment, balanced across this process's shards
        (each controller uploads from its own pool); the rest of a
        segment larger than they hold is carried to the next upload."""
        if self._carry is None and pending:
            self._carry = np.require(pending.pop(0),
                                     requirements=["C", "W"])
        piece = (self._carry if self._carry is not None
                 else np.zeros((0, self._sw), np.uint8))
        L, cap = self._L, self._L * self._Q
        piece, self._carry = piece[:cap], (piece[cap:] if len(piece) > cap
                                           else None)
        share = -(-len(piece) // L)
        local = []
        for s, dev in enumerate(self.devices):
            part = piece[s * share:(s + 1) * share]
            qcur[s][:len(part)] = torch.from_numpy(
                np.ascontiguousarray(part)).to(dev)
            local.append([len(part)])
        return [r[0] for r in self._gather(local)]
