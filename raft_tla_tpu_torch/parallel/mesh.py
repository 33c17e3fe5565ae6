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
step makes no host read.  When every shard sits on one card the whole
n-shard step is one CUDA graph, replayed ``sync_every`` times as
``BFSEngine`` does (captured again after a growth); across distinct
cards it runs eagerly with the same device-side cond, its exchanges
``Tensor.to`` copies (ordered with both devices' streams; no run across
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
(``_sample_skew``).  Multi-process runs (``parallel/multihost.py``) are
not ported (ROADMAP.md A5b) and are refused.
"""

from __future__ import annotations

import dataclasses
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
from ..obs.events import RunEventLog, device_memory_stats
from ..obs.metrics import MetricsRegistry
from ..ops import compact as compact_mod
from ..ops import fpset
from ..ops.chunk_front import FrontOut
from ..ops.fingerprint import MASK32, build_fingerprint
from ..ops.fpset import EMPTY, pack
from ..ops.fpset_cuda import insert
from ..utils.device import resolve_device


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


def refuse_multiprocess() -> None:
    """A process group of more than one rank would run a duplicate mesh
    in each; the multi-controller mesh is not ported."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "multi-process mesh runs (parallel/multihost.py, the trace "
            "pieces, per-controller counterexample names) are not ported "
            "yet (ROADMAP.md A5b)")


def route_insert(seens: List[fpset.FPSet], keys: List[torch.Tensor],
                 valid: List[torch.Tensor]):
    """The JAX mesh's ``route_insert`` over n shards: ``keys[s]`` [k]
    packed keys of shard s with ``valid[s]``, each on its shard's device.
    Returns ``(new, fail)``: ``new[s]`` [k] bool on shard s's device,
    True on the lowest (source shard, lane) of each key in no shard's
    table before the call; ``fail[d]`` the insert's flag on owner d.
    Fixed shapes, no host read: the insert kernel runs once on each owner
    over n·k arrivals."""
    n = len(seens)
    k = keys[0].shape[0]
    blocks, places = [], []
    for s in range(n):
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
    for d in range(n):
        dev = seens[d].keys.device
        arr = torch.cat([blocks[s][d].to(dev) for s in range(n)])
        is_new, f = insert(seens[d], arr, arr != EMPTY)
        nov.append(is_new.view(n, k))
        fail.append(f)
    new = []
    for s in range(n):
        dev = keys[s].device
        back = torch.stack([nov[d][s].to(dev) for d in range(n)])
        new.append(back.view(-1).gather(0, places[s]))
    return new, fail


class MeshStep:
    """One batch on every shard: ``step(qcur, seens, qnext, tbufs, css)``
    over lists indexed by shard.  ``steps[s]`` is the ``ChunkStep`` of
    shard s's device (its cond, window, update and body stages); its
    ``count_word`` holds the shard's own row count and ``CUR`` the
    level's largest, so a shard's cond is the JAX cond's share."""

    def __init__(self, steps, devices, G: int, kspread):
        self.steps, self.devices = steps, devices
        self.n, self.G = len(devices), G
        self._kspr = kspread
        self._d0 = devices[0]

    def cond(self, seens, css) -> List[torch.Tensor]:
        """[1] bool a shard: whether the next step runs a batch."""
        ok = torch.cat([self.steps[s].cond(seens[s], css[s]).to(self._d0)
                        for s in range(self.n)]).all().view(1)
        return [ok.to(d) for d in self.devices]

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
        P = torch.cat([pt.narrow(0, 0, 1).to(self._d0)
                       for pt, _l, _k in comp]).min().view(1).to(torch.int64)
        fronts = []
        for s in range(n):
            step = self.steps[s]
            Ps = P.to(self.devices[s])
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
                                 [f.kvalid for f in fronts])
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
    ``BFSEngine``."""

    def __init__(self, dims: RaftDims,
                 invariants: Optional[Dict[str, Callable]] = None,
                 constraint: Optional[Callable] = None,
                 config: Optional[EngineConfig] = None, devices=None):
        refuse_multiprocess()
        self.dims = dims
        self.config = cfg = config or EngineConfig()
        self.devices = devs = resolve_devices(devices)
        self.n_dev = n = len(devs)
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
        sw = state_width(dims)
        B, G = cfg.batch, dims.n_instances
        K = compact_mod.choose_k(B, G, cfg.compact_lanes)
        qreq, sreq = cfg.queue_capacity, cfg.seen_capacity
        if qreq is None or sreq is None:
            # Each card's budget divided among the shards on it.
            per = []
            for d in dict.fromkeys(devs):
                m, limit = devs.count(d), device_memory(d)
                q, s = auto_capacities(sw, B, cfg.record_trace,
                                       None if limit is None else limit // m)
                if limit is None:
                    q, s = -(-q // m), -(-s // m)
                per.append((q, s))
            qreq = min(q for q, _s in per) * n if qreq is None else qreq
            sreq = min(s for _q, s in per) * n if sreq is None else sreq
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
                               [kspr[d] for d in devs])
        # One CUDA graph for the whole step when every shard is on one
        # card; eager steps across cards and on the CPU.
        self._graphable = dev0.type == "cuda" and len(set(devs)) == 1
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

    # -- device state --------------------------------------------------
    def _alloc_state(self, sw: int):
        """Each shard's ``ChunkState``; the state words of the shards on
        one device are rows of one tensor, so a chunk's control words go
        out in one copy a device and its stats come back in one read."""
        n, F = self.n_dev, len(self.dims.family_sizes)
        groups: Dict[torch.device, List[int]] = {}
        for s, d in enumerate(self.devices):
            groups.setdefault(d, []).append(s)
        self._st_groups = []
        css = [None] * n
        for d, shards in groups.items():
            st = torch.zeros((len(shards), self._W), dtype=torch.int32,
                             device=d)
            self._st_groups.append((st, shards))
            for r, s in enumerate(shards):
                cs = chunk_mod.chunk_state(F, sw, d)
                css[s] = cs._replace(st=st[r])
        self._css = css
        self._ctl = torch.zeros((n, self._W), dtype=torch.int32,
                                pin_memory=self.device.type == "cuda")

    def _write_ctl(self, offset: int, next_counts, cur_counts,
                   max_steps: int):
        """A chunk's start on every shard: every counter zero but these."""
        h, CUR = self._ctl, self._CUR
        h.zero_()
        h[:, ST_OFFSET] = offset
        h[:, ST_COUNT] = torch.tensor(next_counts, dtype=torch.int32)
        h[:, CUR] = max(cur_counts)
        h[:, CUR + 1] = max_steps
        h[:, CUR + 3] = torch.tensor(cur_counts, dtype=torch.int32)
        for st, shards in self._st_groups:
            src = h if len(shards) == self.n_dev else h[shards]
            st.copy_(src, non_blocking=True)

    def _read_stats(self) -> List[list]:
        """Every shard's state words, in one read a device."""
        if len(self._st_groups) == 1:
            return self._st_groups[0][0].tolist()
        rows = [None] * self.n_dev
        for st, shards in self._st_groups:
            for s, r in zip(shards, st.tolist()):
                rows[s] = r
        return rows

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
        """Every shard's queued rows as one host array, in shard order."""
        segs = [host_rows(q[:c]) for q, c in zip(qs, counts) if c]
        return (np.concatenate(segs) if segs
                else np.zeros((0, self._sw), ROW_DTYPE))

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
        loop already read; rows drained to the host pool are not
        counted."""
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
        the shards' keys."""
        keys = np.concatenate([s.keys.cpu().numpy() for s in seens])
        keys = keys[keys != EMPTY].view(np.uint64)
        hi = (keys >> np.uint64(32)).astype(np.uint32)
        lo = (keys & np.uint64(MASK32)).astype(np.uint32)
        order = np.lexsort((lo, hi))
        self._save_checkpoint(
            np.concatenate([self._drain(qcur, cur_counts),
                            *pending.segments()]),
            hi[order], lo[order], res, trace, wall)

    def _shards_from_keys(self, hi: np.ndarray, lo: np.ndarray):
        """The seen shards from a flat key set (owner ``hi mod n``), at a
        capacity that holds each at most half full."""
        hi = np.asarray(hi, np.uint32)
        lo = np.asarray(lo, np.uint32)
        owner = hi.astype(np.int64) % self.n_dev
        most = int(np.bincount(owner, minlength=self.n_dev).max()) \
            if len(hi) else 0
        while most > self._CL // 2:
            self._CL *= 2
        return [fpset.from_host_keys(hi[owner == d], lo[owner == d],
                                     self._CL, dev)
                for d, dev in enumerate(self.devices)]

    def _ingest(self, rows_all, seens, qnext, spill_next, res, t0):
        """The roots, round-robin across the shards in B-sized waves:
        fingerprinted, inserted through the routed insert, the novel
        constraint-passing ones enqueued on their shard.  Returns the
        shards' next-level counts, the seen sizes, the tables and t0."""
        cfg, n, B, sw = self.config, self.n_dev, self._B, self._sw
        mt, evlog = self.metrics, self._evlog
        per = [rows_all[i::n] for i in range(n)]
        waves = max(-(-p.shape[0] // B) for p in per)
        counts, sizes = [0] * n, [0] * n
        for c in range(waves):
            left = sum(max(0, p.shape[0] - c * B) for p in per)
            if c and cfg.max_seconds is not None \
                    and time.time() - t0 > cfg.max_seconds:
                res.stop_reason = "duration_budget"
                break
            if c and cfg.exit_conditions:
                hit = exit_condition_hit(
                    cfg.exit_conditions, res,
                    sum(counts) + spill_next.total_rows() + left)
                if hit:
                    res.stop_reason = hit
                    break
            t_h = time.time()
            wave = []
            for s, dev in enumerate(self.devices):
                part = per[s][c * B:(c + 1) * B].to(dev)
                rows = torch.zeros((B, sw), dtype=ROW_DTYPE, device=dev)
                rows[:part.shape[0]] = part
                valid = torch.arange(B, device=dev) < part.shape[0]
                cands = unflatten_state(rows, self.dims)
                fph, fpl = self._fps[dev](cands)
                wave.append((rows, valid, cands, fph, fpl))
            new, fail = route_insert(
                seens, [pack(w[3], w[4]) for w in wave],
                [w[1] for w in wave])
            viol = None
            for s, (rows, _v, cands, fph, fpl) in enumerate(wave):
                enq = new[s]
                if self._constraint is not None:
                    enq = enq & self._constraint(cands)
                idx = enq.nonzero().squeeze(1)
                qnext[s][counts[s]:counts[s] + idx.shape[0]] = rows[idx]
                counts[s] += idx.shape[0]
                n_new = int(new[s].sum())
                res.distinct += n_new
                mt.counter("engine/distinct", n_new)
                self._record(new[s], fph, fpl)
                if self._inv_id is not None and viol is None:
                    bad = new[s] & (self._inv_id(cands) >= 0)
                    if bool(bad.any()):
                        v = int(bad.to(torch.int32).argmax())
                        inv = int(self._inv_id(cands)[v])
                        viol = Violation(
                            self.inv_names[inv], self._decode_row(rows[v]),
                            (int(fph[v]) << 32) | int(fpl[v]))
            if any(bool(f) for f in fail):
                raise RuntimeError("seen-set probe failure during "
                                   "ingest; raise seen_capacity")
            sizes = [int(s.size[0]) for s in seens]
            seens, t0 = self._grow_shards(seens, sizes, res, t0)
            if max(counts) > self._QTH:
                spill_next.append(self._drain(qnext, counts))
                res.spills += 1
                evlog.emit("spill", rows=sum(counts), level=0,
                           where="ingest")
                counts = [0] * n
            self._phase("host", time.time() - t_h)
            if viol is not None:
                res.violation = viol
                res.stop_reason = "violation"
                evlog.emit("violation", invariant=viol.invariant,
                           fingerprint=hex(viol.fingerprint), level=0)
                break
        return counts, sizes, seens, t0

    # ------------------------------------------------------------------
    def _run_impl(self, init_states, resume) -> EngineResult:
        dims, cfg = self.dims, self.config
        n, sw, QL, devs = self.n_dev, self._sw, self._Q, self.devices
        res = self._result = EngineResult(
            pipeline=self._plan_name, fused_stages=dict(self._plan),
            fused_reasons=dict(self._plan_reasons),
            device=f"mesh of {n}: " + ", ".join(str(d) for d in devs),
            por_instances=(self._por_table.certified
                           if self._por_table else 0),
            family_groups=report_mod.family_groups(dims))
        mt, evlog = self.metrics, self._evlog
        coverage = self.coverage = ActionCoverage(dims.family_names,
                                                  dims.family_sizes)
        if isinstance(resume, str):
            resume = ckpt_mod.load(resume)
        if isinstance(resume, ResumePoint):
            raise TypeError("the mesh resumes from a snapshot's path or a "
                            "Checkpoint, not a single engine's ResumePoint")
        if resume is not None:
            ck = resume
            if ck.dims != dims:
                raise ValueError(
                    f"checkpoint dims {ck.dims} != engine dims {dims}")
            check_resume_trace(cfg, ck)
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
            for i in range(0, fr.shape[0], n * QL):
                pending.append(fr[i:i + n * QL])
            cur_counts = [0] * n
            sizes = [int(s.size[0]) for s in seens]
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
                return res
            seens = [fpset.empty(self._CL, d) for d in devs]
            t0 = time.time()
            counts, sizes, seens, t0 = self._ingest(rows_all, seens, qnext,
                                                    spill_next, res, t0)
            res.levels.append(sum(counts) + spill_next.total_rows())
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
        while (max(cur_counts) > 0 or pending) and res.violation is None \
                and res.stop_reason == "exhausted":
            if cfg.checkpoint_dir is not None \
                    and res.diameter % max(1, cfg.checkpoint_every) == 0 \
                    and res.diameter != skip_ckpt_level \
                    and (time.time() - last_ckpt
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
            calls_in_level = 0
            while True:
                offset = 0
                top = max(cur_counts)
                while offset < top:
                    allowed = self._CH
                    if cfg.max_seconds is not None:
                        remaining = cfg.max_seconds - (time.time() - t0)
                        if remaining <= 0:
                            res.stop_reason = "duration_budget"
                            break
                        allowed = (max(1, min(
                            self._CH, int(remaining / (2 * self._batch_ema)),
                            2 << min(calls_in_level, 9)))
                            if self._batch_ema else 1)
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
                        for tbuf, r in zip(self._tbufs, st):
                            if r[ST_TCOUNT]:
                                self._flush_trace(tbuf, r[ST_TCOUNT])
                        inner = time.time() - t_t
                        self._phase("trace", inner)
                    self._check_faults(total)
                    seens, t0 = self._grow_shards(seens, sizes, res, t0)
                    if max(next_counts) > self._QTH \
                            and (offset < top or pending or carry is not None):
                        t_s = time.time()
                        spill_next.append(self._drain(qnext, next_counts))
                        res.spills += 1
                        evlog.emit("spill", rows=sum(next_counts),
                                   level=res.diameter, where="chunk_loop")
                        next_counts = [0] * n
                        self._phase("spill", time.time() - t_s)
                        inner += time.time() - t_s
                    # The lowest-indexed flagged shard's violation or
                    # deadlock.
                    viol = next(((r[ST_VINV], cs) for r, cs
                                 in zip(st, self._css) if r[ST_VIOL]), None)
                    dead = next((cs for r, cs in zip(st, self._css)
                                 if r[ST_DEAD]), None)
                    last_progress = self._verdict(
                        res, viol, dead,
                        lambda: (sum(max(0, c - offset) for c in cur_counts)
                                 + pending.total_rows()
                                 + (len(carry) if carry is not None else 0)
                                 + sum(next_counts)
                                 + spill_next.total_rows()),
                        sum(cur_counts), max(sizes) / self._CL, t0,
                        last_progress)
                    self._phase("host", time.time() - t_h - inner)
                    if res.stop_reason != "exhausted":
                        break
                if res.stop_reason != "exhausted" \
                        or (carry is None and not pending):
                    break
                # The next host segment, balanced across the shards.
                t_s = time.time()
                if carry is None:
                    carry = np.require(pending.pop(0),
                                       requirements=["C", "W"])
                cap = n * QL
                piece, carry = carry[:cap], (carry[cap:] if len(carry) > cap
                                             else None)
                share = -(-len(piece) // n)
                for s, dev in enumerate(devs):
                    part = piece[s * share:(s + 1) * share]
                    qcur[s][:len(part)] = torch.from_numpy(
                        np.ascontiguousarray(part)).to(dev)
                    cur_counts[s] = len(part)
                self._phase("spill", time.time() - t_s)
            if res.stop_reason != "exhausted":
                break
            res.diameter += 1
            res.levels.append(sum(next_counts) + spill_next.total_rows())
            self._sample_skew(res, next_counts, sizes)
            self._emit_level_event(res, res.levels[-1])
            qcur, qnext = qnext, qcur
            cur_counts = next_counts
            pending, spill_next = spill_next, pending
        res.wall_seconds = time.time() - t0
        return res
