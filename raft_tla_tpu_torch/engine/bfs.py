"""Single-device exhaustive BFS checker (the v3 and v4 plans).

The JAX package's ``engine/bfs.py`` ``BFSEngine`` and its level loop:
roots are invariant-checked on their unpacked encoding and ingested
through the seen-set insert, then each level is expanded in chunks of up
to ``sync_every`` batches (``engine/chunk.py``) with one host round trip
a chunk.  What it keeps of the JAX engine:

- capacity rules: K compacted lanes (``ops/compact.py choose_k``,
  ``compact_lanes``), a seen table floored at 8·K keys, a next-level
  queue of Q >= K rows (rounded to a multiple of B) plus PAD = max(B, K)
  rows, so no count the card can reach lets a batch write past the end;
  with ``queue_capacity`` or ``seen_capacity`` None, both sized from the
  card's memory (``auto_capacities``);
- the chunk: the JAX device ``while_loop`` becomes a step on device
  counters (``engine/chunk.py ChunkStep``) whose ``cond`` is evaluated on
  the card.  On the card the step is captured once as a CUDA graph for
  each set of buffers it runs on (the two level queues, the async
  spill's spare, the seen set; captured again after a growth) and
  replayed up to ``sync_every`` times; the host reads the packed counters
  once, drains the device trace buffer to the trace store and handles
  spill, growth, violation, deadlock, budgets and progress, as the JAX
  loop does after each chunk.  On the CPU the same step runs eagerly
  while its cond holds.  Duration budgets shrink the chunk from the
  measured seconds a batch, as the JAX loop does;
- the spill watermark: when more than Q - K rows wait in the next-level
  queue and the level has more to expand, the queue's rows go to host
  memory (TLC's disk queue; ``engine/spillpool.py``, in RAM or memory-
  mapped files under ``spill_dir``).  On the card the drain is
  asynchronous: a spare queue is swapped in while a copy stream moves the
  rows into pinned memory, resolved at the next drain or the level's end;
- seen-set growth: past half full the table doubles by rehashing on its
  device (off the duration clock, recorded in ``growth_stalls``);
- graceful degradation: running out of device memory in the level loop
  (``torch.cuda.OutOfMemoryError``, or what ``resilience/faults.py``
  ``is_resource_exhausted`` accepts) rebuilds the engine at half the
  batch (down to ``min_batch``) and resumes from this run's newest
  snapshot in ``checkpoint_dir``, or from the roots; a seen-set growth
  that runs out retries once from the host keys after releasing the old
  table (the ``degraded`` event with ``reason="oom_grow_retry"``);
- the fault sites of the JAX loop (``resilience/faults.py``): ``kill``
  and ``oom`` at a chunk call (params ``level``, ``chunk``), ``oom`` at a
  growth (param ``grow``);
- the TLC-style progress line every ``progress_interval_seconds``;
- ``replay``: walk the trace back to a root and re-run the successor
  function forward, matching each recorded child by fingerprint.

``EngineResult.phases`` splits the wall time into the host's dispatch of
each chunk, its waits for the device (``sync``), graph capture, trace
drains, spills and its own bookkeeping.  ``EngineConfig.pipeline`` picks
the chunk's plan: "v3" (the default; the masks and lane stages in
PyTorch around the compaction kernel; "auto" and "v2", the JAX
package's names of its delta pipeline, run it too) or "v4" (one front
kernel, ``ops/chunk_front_cuda.py``).  ``enqueue_method`` picks the tail: the
fused insert + enqueue kernel (the default) or the split tail, the
insert kernel followed by the enqueue kernel or a PyTorch lowering.
Every combination gives equal results.

Also the JAX engine's, in the same terms: level-boundary checkpoints in
its ``.npz`` format and ``run(resume=...)`` (``engine/checkpoint.py``; a
snapshot of either package resumes in the other), the TLCGet exit
budgets over distinct / generated / queue (checked after each chunk),
and the partial-order reduction fed by a certified table
(``analysis/por.py``; ``por=True`` would certify in process through the
jaxpr analyzer, which is not ported).

Observability, the JAX engine's (``obs/``): a ``MetricsRegistry`` on the
engine (``engine.metrics``; the phase seconds mirrored from
``EngineResult.phases``, the live counters and gauges), the JSONL run
events (``events_out``), the per-family action coverage read from the
counters the chunk already keeps, a ``level_stats`` row at each level
boundary, the statespace report at run end (``statespace_report``) and,
on a traced violation, ``counterexample.{txt,json}``
(``counterexample_dir``, else ``checkpoint_dir``).  All of it reads
values the level loop has already brought to the host: it adds no wait
for the device, and no count depends on it.  Also the JAX engine's: the
span tracer (``trace_out``: a ``run`` span, a ``level`` span a level and
the loop's spans under the JAX names), the flight recorder armed for the
run (``postmortem.json`` in ``postmortem_dir``, else ``checkpoint_dir``,
on an escaping exception, SIGTERM or an exit while armed; ``run_end``
carries its path), the chunk profiler (``profile_chunks_every``), the
performance block (``perf``), the device-profiler capture
(``xla_profile_chunks``) and the trace store's choice (``trace_store``,
named on ``run_start`` and ``EngineResult.trace_store``).  A profiler
sample waits for the card once; everything else reads what the loop
already has.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
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
from ..obs import report as report_mod
from ..obs.coverage import ActionCoverage
from ..obs.events import (RunEventLog, all_device_memory_stats,
                          device_memory_stats, events_path,
                          peak_host_rss_bytes)
from ..obs.flight import RECORDER as _FLIGHT
from ..obs.metrics import PHASE_PREFIX, MetricsRegistry, phase_delta
from ..obs.tracing import SpanTracer
from ..ops import chunk_front_cuda, compact_cuda, enqueue_cuda
from ..ops import compact as compact_mod
from ..ops import fpset, fpset_cuda, fused_tail_cuda, pipeline_v3
from ..ops import pipeline_v4
from ..ops.chunk_front_cuda import Front
from ..ops.fingerprint import build_fingerprint
from ..ops.fpset import pack
from ..ops.fpset_cuda import insert
from ..resilience import faults as _faults
from ..resilience.faults import is_resource_exhausted
from ..utils.device import capture_graph, resolve_device
from . import checkpoint as ckpt_mod
from . import chunk as chunk_mod
from .chunk import (ST_COUNT, ST_DEAD, ST_EXPANDED, ST_FAIL, ST_GEN, ST_NEW,
                    ST_OFFSET, ST_OVF, ST_SEEN, ST_STEPS, ST_TCOUNT, ST_VIOL,
                    ST_VINV)
from .spillpool import SpillPool
from .trace import make_trace_store

PLANS = {"v3": pipeline_v3, "v4": pipeline_v4}

#: ``EngineConfig.pipeline`` -> plan.  The JAX package's "auto" (its
#: default) and "v2" (its delta pipeline) are the v3 plan's semantics
#: with the same counts; "v1" (the classical expand) is not ported.
PLAN_NAMES = {"v3": "v3", "v4": "v4", "auto": "v3", "v2": "v3"}

#: The phases of ``EngineResult.phases``.
PHASES = ("dispatch", "sync", "capture", "trace", "spill", "host",
          "checkpoint")

#: The kernel wrappers' modules, whose ``launches`` a graph replay adds to.
KERNEL_MODULES = (compact_cuda, fpset_cuda, fused_tail_cuda,
                  chunk_front_cuda, enqueue_cuda)


def host_rows(rows: torch.Tensor) -> np.ndarray:
    """A host copy of queue rows (on the CPU, ``.numpy()`` alone would be
    a view of a buffer the loop is about to overwrite)."""
    return rows.to("cpu", copy=True).numpy()


def device_memory(device) -> Optional[int]:
    """The card's memory in bytes as PyTorch reports it; None on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory


def auto_capacities(sw: int, batch: int, record_trace: bool,
                    limit: Optional[int]) -> Tuple[int, int]:
    """``(queue rows, seen keys)`` sized from ``limit`` bytes of device
    memory: the JAX package's ``_auto_capacities``.  After 25% headroom
    for temporaries, half to the three level queues (current, next, the
    async spill's spare; plus a 20-byte trace row when tracing) and a
    quarter to the seen table (8 bytes a slot).  These size only the
    device-resident working set: the queue spills to the host and the
    table grows.  No limit (the CPU) gives modest defaults."""
    if limit is None:
        return 1 << 20, 1 << 22
    usable = int(limit * 0.75)
    row_cost = 3 * sw + (chunk_mod.TRACE_ROW if record_trace else 0)
    q = max(batch, min(usable // 2 // row_cost, 1 << 25))
    s = max(1 << 18, min(usable // 4 // 8, 1 << 28))
    return q, s


def progress_line(res, t0: float, queue_rows: int, level_frontier: int,
                  load: float, metrics=None) -> str:
    """TLC's progress report (generated, distinct, queue) with the JAX
    package's extras (rates, the level being expanded, the seen set's
    load factor): the text of its ``_progress_line``, whose gauges it
    also sets in ``metrics``."""
    dt = max(time.time() - t0, 1e-9)
    if metrics is not None:
        metrics.gauge("engine/queue_rows", queue_rows)
        metrics.gauge("engine/level_frontier", level_frontier)
        metrics.gauge("engine/states_per_sec", res.distinct / dt)
        metrics.gauge("engine/generated_per_sec", res.generated / dt)
    return (f"progress: {res.generated:,} generated "
            f"({res.generated / dt:,.0f}/s), "
            f"{res.distinct:,} distinct ({res.distinct / dt:,.0f}/s), "
            f"diameter {res.diameter} (expanding {level_frontier:,}), queue "
            f"{queue_rows:,}, fpset load {load:.2f}, elapsed {dt:,.0f}s")


@dataclasses.dataclass
class EngineConfig:
    batch: int = 256                 # parents expanded per batch
    # Device rows of the next-level queue and initial seen-set slots (the
    # table grows); None sizes both from the card (auto_capacities).
    queue_capacity: Optional[int] = 1 << 16
    seen_capacity: Optional[int] = 1 << 18
    # Compacted lanes a batch (None = 16 per parent; ops/compact.py
    # choose_k floors and rounds it).
    compact_lanes: Optional[int] = None
    check_deadlock: Optional[bool] = None  # None = TLC's default (on)
    record_trace: bool = True
    sync_every: int = 32             # batches per host round trip
    max_seconds: Optional[float] = None    # StopAfter duration budget
    max_diameter: Optional[int] = None     # StopAfter diameter budget
    pipeline: str = "v3"     # chunk plan: "v3" or "v4" (PLAN_NAMES)
    # The chunk's tail.  "fused": one insert + enqueue kernel (the JAX
    # plans' fused tail).  Split, the insert kernel and then: "kernel",
    # the enqueue kernel (JAX: enqueue_method="pallas" with
    # insert_method="pallas", or v3_force_stages={"insert": "xla"} on the
    # fused plans); "scatter" / "window", the PyTorch lowerings of the
    # JAX enqueue methods of those names.  One field where the JAX
    # package has three: the port has one insert.
    enqueue_method: str = "fused"
    # Further TLCGet budgets as (counter, threshold) pairs over "distinct"
    # / "generated" / "queue", checked after every chunk; stop_reason
    # "<counter>_budget".  Duration and diameter ride the fields above.
    exit_conditions: tuple = ()
    # TLC-style progress line on stderr every so many seconds; 0 = off.
    progress_interval_seconds: float = 0.0
    # Level-boundary snapshots (engine/checkpoint.py): every
    # checkpoint_every levels, at most once per
    # checkpoint_interval_seconds, keeping the newest keep_checkpoints
    # (None or 0 = all).
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1
    checkpoint_interval_seconds: float = 0.0
    keep_checkpoints: Optional[int] = None
    # Spilled level segments: None keeps them in host RAM, a directory
    # memory-maps them to files there (engine/spillpool.py).
    spill_dir: Optional[str] = None
    # Partial-order reduction: a certified analysis/por.py PorTable or
    # the path of its artifact, admission-checked at engine build.
    # por=True (certify in process) needs the analyzer, not ported.
    por: bool = False
    por_table: Optional[object] = None
    # On running out of device memory (resilience/faults.py
    # is_resource_exhausted): rebuild at half the batch (not below
    # min_batch) and resume from this run's newest snapshot, or restart.
    degrade_on_oom: bool = True
    min_batch: int = 32
    # Observability (obs/): the statespace report at run end (on by
    # default, as in the JAX package); the JSONL run events (None puts
    # them in events.jsonl next to checkpoint_dir; with neither, no file);
    # where a traced violation's counterexample.{txt,json} land (None
    # means checkpoint_dir; with neither, no files).  No count depends
    # on any of them.
    statespace_report: bool = True
    events_out: Optional[str] = None
    counterexample_dir: Optional[str] = None
    # The mesh (parallel/mesh.py): a ``skew`` event at a level boundary
    # whose largest shard frontier is at least this many times the mean
    # (0 = never).
    skew_warn_ratio: float = 2.0
    # The mesh under a process group (parallel/multihost.py): the shared
    # directory where the controllers exchange their trace pieces (None
    # means checkpoint_dir), and how long a replay waits for a sibling's
    # piece (None: 30 s plus the local piece's bytes at 8 MB/s).
    trace_dir: Optional[str] = None
    trace_merge_timeout_seconds: Optional[float] = None
    # The predecessor-trace store (engine/trace.py make_trace_store):
    # "columnar" (numpy columns) or "native" (the C++ hash store).
    trace_store: str = "columnar"
    # Span tracing (obs/tracing.py): the Chrome trace file, None = off.
    trace_out: Optional[str] = None
    # The chunk profiler (obs/profile.py): sample every Nth chunk call;
    # None = unset (perf then samples every 16th), 0 = off.
    profile_chunks_every: Optional[int] = None
    # The performance block (obs/perf.py, obs/roofline.py).
    perf: bool = False
    # Where the flight recorder's postmortem.json lands (None means
    # checkpoint_dir; with neither, no dump).
    postmortem_dir: Optional[str] = None
    # The device-profiler capture (obs/profile.py ProfileCapture) of the
    # first N chunk calls, into xla_profile_dir (None means
    # <checkpoint_dir>/xla_profile, else ./xla_profile).
    xla_profile_chunks: Optional[int] = None
    xla_profile_dir: Optional[str] = None
    # A shared MetricsRegistry (None gives the engine its own): the
    # checker service passes its process-wide one, so several runs
    # aggregate and other threads read live gauges.
    metrics: Optional[object] = None
    # Caller tags (the serving layer's job and tenant) on the flight
    # recorder's run_context record.
    run_context_extra: Optional[dict] = None


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
    batches: int = 0     # batches that ran (the step's cond held)
    # Steps dispatched: those whose cond failed too, and those of an
    # attempt that ran out of device memory.
    steps: int = 0
    chunks: int = 0      # host round trips of the level loop
    # (batch, new batch, snapshot resumed or None) per OOM degradation.
    degraded: List = dataclasses.field(default_factory=list)
    pipeline: str = "v3"
    fused_stages: Dict[str, str] = dataclasses.field(default_factory=dict)
    # Why a stage is not what the plan names elsewhere (the mesh's
    # resolution, ops/pipeline_v3.py resolve_mesh_plan); {} otherwise.
    fused_reasons: Dict[str, str] = dataclasses.field(default_factory=dict)
    device: str = ""
    # Host wall seconds: "dispatch" (queueing a chunk's steps), "sync"
    # (waiting for the device at the chunk's stats read), "capture" (CUDA
    # graph capture, off the duration clock), "trace" (device trace
    # buffer drains), "spill" (queue drains and uploads), "host" (the
    # loop's other bookkeeping: root ingest, growth, budgets),
    # "checkpoint" (snapshot writes).
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Per family {generated, distinct, disabled, pruned} (obs/coverage.py).
    coverage: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    # The base families grouped by parameter grid, for the report.
    family_groups: List = dataclasses.field(default_factory=list)
    # The statespace report (obs/report.py build_report); {} when
    # EngineConfig.statespace_report is off.
    report: Dict = dataclasses.field(default_factory=dict)
    # One row a level boundary: level, frontier, distinct, generated, the
    # seen set's size and capacity, the card's memory.
    level_stats: List = dataclasses.field(default_factory=list)
    # {"txt", "json", "depth"} of the written counterexample, else {}.
    counterexample: Dict = dataclasses.field(default_factory=dict)
    # The trace store that ran: "columnar" or "native" (a native store
    # that could not be built runs columnar, and says why on stderr).
    trace_store: str = ""
    # {stage: mean seconds} when the chunk profiler ran, else {}.
    chunk_stages: Dict[str, float] = dataclasses.field(default_factory=dict)
    # The performance block (obs/perf.py) with perf on, else {}.
    perf: Dict = dataclasses.field(default_factory=dict)

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


def check_resume_trace(cfg: EngineConfig, ck: ckpt_mod.Checkpoint) -> None:
    """Refuse a snapshot whose trace records do not fit the run's trace
    recording."""
    if cfg.record_trace and ck.distinct > 0 and ck.trace_fps.size == 0:
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
        # Re-entered at a smaller batch by OOM degradation
        # (_rebuild_at_batch): everything below is rebuilt but the
        # registry and the open event log.
        self.dims = dims
        self.config = cfg = config or EngineConfig()
        self.device = dev = resolve_device(device)
        if not hasattr(self, "metrics"):
            self.metrics = (cfg.metrics if cfg.metrics is not None
                            else MetricsRegistry())
            self._evlog = RunEventLog(None)
            self.tracer = SpanTracer(cfg.trace_out)
            self.metrics.tracer = self.tracer
            self._xla_capture = None
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
        self._v2 = build_v2(dims, dev)
        self._fingerprint = build_fingerprint(dims, dev)
        self._plan = PLANS[self._plan_name].resolve_plan(dev,
                                                          cfg.enqueue_method)
        if cfg.checkpoint_dir is not None:
            ckpt_mod.check_dims_checkpointable(dims)
        self._por_table = resolve_por(cfg, dims, invariants or {},
                                      constraint)
        por_mask, por_priority = por_device_arrays(self._por_table, dev)
        self._check_deadlock = (True if cfg.check_deadlock is None
                                else cfg.check_deadlock)
        sw = state_width(dims)
        B, G = cfg.batch, dims.n_instances
        K = compact_mod.choose_k(B, G, cfg.compact_lanes)
        qreq, sreq = cfg.queue_capacity, cfg.seen_capacity
        if qreq is None or sreq is None:
            auto_q, auto_s = auto_capacities(sw, B, cfg.record_trace,
                                             device_memory(dev))
            qreq = auto_q if qreq is None else qreq
            sreq = auto_s if sreq is None else sreq
        self._seen_cap = max(sreq, 8 * K)
        Q = max(-(-qreq // B) * B, K)
        self._sw, self._B, self._G, self._Q, self._K = sw, B, G, Q, K
        self._PAD = max(B, K)
        self._QTH = Q - K
        # Trace buffer rows: room for a batch of records at any chunk
        # start (the cond stops a chunk past TQ - K), K more so no count
        # the card reaches lets a batch write past the end; a stub
        # without trace recording.
        self._TQ = Q + K if cfg.record_trace else 0
        self._TA = self._TQ + K if cfg.record_trace else 1
        self._CH = max(1, cfg.sync_every)
        front = None
        if self._plan_name == "v4":
            front = Front(dims=dims, v2=self._v2, inv_fns=self._inv_fns,
                          constraint=constraint, B=B, K=K, device=dev,
                          por_mask=por_mask, por_priority=por_priority)
        self._step = chunk_mod.ChunkStep(
            dims=dims, B=B, K=K, Q=Q, QTH=self._QTH, TQ=self._TQ,
            record_trace=cfg.record_trace,
            check_deadlock=self._check_deadlock, device=dev,
            v2=self._v2, inv_fns=self._inv_fns, constraint=constraint,
            front=front, enqueue_method=cfg.enqueue_method,
            por_mask=por_mask, por_priority=por_priority)
        self._graphs: Dict[tuple, tuple] = {}
        self._pool = None
        self._warm = False
        self.trace = make_trace_store(cfg.trace_store)
        self._build_observers(dict(
            v2=self._v2, inv_fns=self._inv_fns, constraint=constraint,
            record_trace=cfg.record_trace,
            enqueue_method=cfg.enqueue_method, por_mask=por_mask,
            por_priority=por_priority))

    def _build_observers(self, stage_kw: dict) -> None:
        """The chunk profiler and the performance accounting, built for
        this engine's batch (rebuilt by a degradation's re-entrant
        ``__init__``); ``perf`` alone samples every 16th chunk call."""
        cfg, dims, dev = self.config, self.dims, self.device
        every = (cfg.profile_chunks_every
                 if cfg.profile_chunks_every is not None
                 else (16 if cfg.perf else None))
        pipeline = self._plan_name
        self._profiler = None
        if every:
            from ..obs.profile import ChunkProfiler
            self._profiler = ChunkProfiler(
                dims, batch=self._B, lanes=self._K,
                seen_capacity=max(min(cfg.seen_capacity or (1 << 20),
                                      1 << 22), 8 * self._K),
                pipeline=pipeline, every=every, metrics=self.metrics,
                device=dev, stage_kw=stage_kw, sync_every=cfg.sync_every,
                enqueue_method=cfg.enqueue_method)
        self._perf = None
        if cfg.perf:
            from ..obs import perf as perf_mod
            from ..obs import roofline
            self._perf = perf_mod.PerfAccounting(
                pipeline=pipeline,
                stage_traffic=roofline.stage_traffic(
                    dims, self._B, self._K, pipeline=pipeline,
                    enqueue_method=cfg.enqueue_method),
                device=dev, metrics=self.metrics)

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

    def _record(self, new, kh, kl):
        """Root records: parent 0, action -1."""
        if not self.config.record_trace:
            return
        idx = new.nonzero().squeeze(1)
        hi, lo = (x[idx].cpu().numpy().astype(np.uint64) for x in (kh, kl))
        fps = (hi << np.uint64(32)) | lo
        self.trace.add_batch(fps, np.zeros_like(fps),
                             np.full(fps.shape, -1, np.int32))

    def _flush_trace(self, tbuf, tcount: int):
        """Drain the device trace buffer: one copy of ``tcount`` records."""
        rec = host_rows(tbuf[:tcount]).view(np.uint32).reshape(-1, 5)
        cols = rec.astype(np.uint64)
        self.trace.add_batch((cols[:, 0] << np.uint64(32)) | cols[:, 1],
                             (cols[:, 2] << np.uint64(32)) | cols[:, 3],
                             rec[:, 4].view(np.int32))

    def _decode_row(self, row: torch.Tensor) -> PyState:
        st = unflatten_state(row.reshape(1, -1).cpu(), self.dims)
        return decode_state(StateBatch(*(f[0] for f in st)), self.dims)

    def _maybe_grow(self, seen, size: int, res, t0):
        """Double the table past half full (off the duration clock); the
        graphs captured on the old table go with it.  A growth that runs
        out of device memory is retried once from the host keys
        (``_grow_from_host``); the ``oom`` fault site (param ``grow``,
        the engine's growth count) rehearses that."""
        if size <= seen.capacity // 2:
            return seen, t0
        t = time.time()
        cap = 2 * seen.capacity
        self._grow_attempts = getattr(self, "_grow_attempts", 0) + 1
        try:
            if _faults.ACTIVE:
                _faults.fire("oom", grow=self._grow_attempts)
            grown = fpset.grow(seen, cap)
        except Exception as e:
            if not (self.config.degrade_on_oom and is_resource_exhausted(e)):
                raise
            grown = self._grow_from_host(seen, cap, e)
        seen = grown
        self._drop_graphs()
        stall = time.time() - t
        res.growth_stalls.append((seen.capacity, round(stall, 3)))
        self.metrics.counter("engine/fpset_resizes")
        self._evlog.emit("fpset_resize", capacity=seen.capacity,
                         stall_seconds=round(stall, 3),
                         memory=device_memory_stats(self.device))
        return seen, t0 + stall

    def _grow_from_host(self, seen, cap: int, err):
        """The JAX engine's degraded growth retry: the keys to the host,
        then the graphs captured on the old table dropped (their pool is
        freed with them), the old table's storage released in place and
        the cache returned to the driver, so the new table is the
        retry's only large allocation.  A second failure propagates to
        ``_run_degradable``, which halves the batch."""
        hi, lo = fpset.to_host_keys(seen)
        self._evlog.emit(
            "degraded", reason="oom_grow_retry", capacity=cap,
            error=f"{type(err).__name__}: {str(err)[:300]}",
            memory=device_memory_stats(self.device))
        self.metrics.counter("engine/degraded")
        self._drop_graphs()
        for t in (seen.keys, seen.owner):
            if t is not None:
                t.set_()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return fpset.from_host_keys(hi, lo, cap, self.device)

    def _phase(self, name: str, seconds: float):
        """Add host seconds to ``EngineResult.phases[name]`` and the same
        seconds to the registry's ``phase/<name>``: one clock, two
        views."""
        phases = self._result.phases
        phases[name] = phases.get(name, 0.0) + seconds
        self.metrics.observe(PHASE_PREFIX + name, seconds)

    def _emit_level_event(self, res, frontier_rows: int):
        """A level boundary: the report's ``level_stats`` row and the
        ``level_complete`` event (counters, per-phase seconds since the
        run started, the card's memory), as the JAX engine's, and the
        level's span.  The event goes out with or without a file (the
        flight ring mirrors it)."""
        mt = self.metrics
        if self.tracer.enabled:
            self.tracer.complete("level", self._lvl_t0, level=res.diameter,
                                 frontier_rows=frontier_rows,
                                 distinct=res.distinct,
                                 generated=res.generated)
            self.tracer.write()
        self._lvl_t0 = time.perf_counter()
        if self._perf is not None:
            self._perf.end_level(res.diameter)
        mem = device_memory_stats(self.device)
        peak = mem.get("peak_bytes_in_use")
        if peak is not None:
            self._hbm_watermark = max(self._hbm_watermark, peak)
            mt.gauge("engine/device_hbm_peak_bytes", self._hbm_watermark)
        # The mesh's shard balance, sampled just before (parallel/mesh.py
        # _sample_skew); None on one device.
        skew = getattr(self, "_last_skew", None)
        extra = ({k: skew.get(k) for k in ("frontier_skew", "seen_skew",
                                           "shard_frontier")}
                 if skew is not None else {})
        if self.config.statespace_report:
            res.level_stats.append({
                "level": res.diameter, "frontier": int(frontier_rows),
                "distinct": res.distinct, "generated": res.generated,
                "seen_size": int(mt.gauge_value("engine/seen_size")),
                "seen_capacity": int(mt.gauge_value("engine/seen_capacity")),
                "hbm_peak_bytes": peak,
                "hbm_bytes_in_use": mem.get("bytes_in_use"), **extra})
        evlog = self._evlog
        phases = phase_delta(mt.phase_seconds(), self._phase_base)
        evlog.emit(
            "level_complete", level=res.diameter,
            frontier_rows=frontier_rows, distinct=res.distinct,
            generated=res.generated, phase_seconds=phases,
            unattributed_seconds=round(
                evlog.elapsed() - sum(phases.values()), 6),
            memory=mem, **extra)

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
        seen_hi, seen_lo = fpset.to_host_keys(seen)
        self._save_checkpoint(
            np.concatenate([host_rows(qcur[:cur_count]),
                            *pending.segments()]),
            seen_hi, seen_lo, res, trace, wall)

    def _save_checkpoint(self, frontier, seen_hi, seen_lo, res, trace,
                         wall, path: Optional[str] = None):
        """``level_<diameter>.npz`` in ``checkpoint_dir`` (or ``path``: a
        controller's piece) from the frontier rows and the lex-sorted seen
        keys, with the counters and the trace."""
        cfg = self.config
        if cfg.record_trace:
            tf, tp, ta = trace.export()
            roots = dict(trace.roots)
        else:
            tf = tp = np.empty(0, np.uint64)
            ta = np.empty(0, np.int32)
            roots = {}
        ck = ckpt_mod.Checkpoint(
            dims=self.dims, frontier=frontier,
            seen_hi=seen_hi, seen_lo=seen_lo,
            distinct=res.distinct, generated=res.generated,
            diameter=res.diameter, levels=tuple(res.levels),
            action_counts=dict(res.action_counts), wall_seconds=wall,
            trace_fps=tf, trace_parents=tp, trace_actions=ta, roots=roots)
        ckpt_mod.save(path or os.path.join(cfg.checkpoint_dir,
                                           f"level_{res.diameter:05d}.npz"),
                      ck)
        # Retention after the write: the newest snapshot lands first.
        ckpt_mod.gc(cfg.checkpoint_dir, cfg.keep_checkpoints)

    # -- the chunk -----------------------------------------------------
    def _capture(self, fn, res):
        """``fn`` (one step) captured as a CUDA graph in the engine's pool,
        on a side stream.  The engine's first capture follows one eager
        step whose cond is false (it loads every kernel and changes
        nothing).  The wrappers' launch counts the capture took are given
        back, and returned as what each replay launches."""
        if not self._warm:
            self._write_idle_ctl()
            fn()
            res.steps += 1
            self._warm = True
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = [m.launches for m in KERNEL_MODULES]
        g = capture_graph(fn, self.device, self._pool)
        delta = []
        for m, b in zip(KERNEL_MODULES, before):
            if m.launches != b:
                delta.append((m, m.launches - b))
                m.launches = b
        return g, delta

    def _write_idle_ctl(self):
        """Control words under which a step changes nothing."""
        self._write_ctl(0, 0, 0, 0)

    def _drop_graphs(self):
        """Release the captured graphs and their memory pool (a pool whose
        graphs are all gone cannot take another capture)."""
        self._graphs.clear()
        self._pool = None

    #: What a run leaves on the device besides the graphs (``release``).
    _RUN_BUFFERS = ("_cs", "_tbuf", "_ctl", "_pinned")

    def release(self) -> None:
        """Give back what the engine holds on its device between runs (the
        checker service calls it on a warm engine it evicts): the captured
        graphs first, whose memory pool lives as long as they do, then the
        run's buffers."""
        self._drop_graphs()
        for name in self._RUN_BUFFERS:
            self.__dict__.pop(name, None)

    def _runner(self, qcur, qnext, seen, res):
        """One step on these buffers: a graph replay on the card (captured
        at first use; a capture that fails raises), the step itself on the
        CPU."""
        step, tbuf, cs = self._step, self._tbuf, self._cs

        def eager():
            step(qcur, seen, qnext, tbuf, cs)

        if self.device.type != "cuda":
            return eager
        return self._graph_replay(
            (qcur.data_ptr(), qnext.data_ptr(), seen.keys.data_ptr()),
            eager, res)

    def _graph_replay(self, key, eager, res):
        """A replay of ``eager``'s graph for the buffers ``key`` names
        (captured at first use), which adds the launches the capture
        took to the wrappers' counts."""
        if key not in self._graphs:
            self._graphs[key] = self._capture(eager, res)
        g, delta = self._graphs[key]

        def replay():
            g.replay()
            for m, d in delta:
                m.launches += d

        return replay

    def _write_ctl(self, offset: int, next_count: int, cur_count: int,
                   max_steps: int):
        """A chunk's start: every counter zero but these."""
        h = self._ctl
        h.zero_()
        h[ST_OFFSET], h[ST_COUNT] = offset, next_count
        h[self._step.CUR], h[self._step.CUR + 1] = cur_count, max_steps
        self._cs.st.copy_(h, non_blocking=True)

    def _dispatch(self, run, n: int, seen):
        """Queue n steps and the cond after them (no host wait)."""
        for _ in range(n):
            run()
        more = self._step.cond(seen, self._cs)
        self._cs.st.narrow(0, self._step.CUR + 2, 1).copy_(more)

    def _run_chunk(self, qcur, qnext, seen, cur_count: int, offset: int,
                   next_count: int, allowed: int, res) -> Tuple[list, float]:
        """Up to ``allowed`` batches of the level from ``offset``, as one
        JAX chunk call: returns the state words read once, and the
        seconds spent capturing (off the duration clock).  On the card
        the steps go out in bursts of at most the batches the level has
        left, so a burst wastes no step at a level's end unless progress
        limiting held a batch back; then a short burst follows."""
        t = time.time()
        run = self._runner(qcur, qnext, seen, res)
        captured = time.time() - t
        self._phase("capture", captured)
        self._write_ctl(offset, next_count, cur_count, allowed)
        tracer = self.tracer
        t_span = time.perf_counter()
        if self.device.type != "cuda":
            t = time.time()
            while bool(self._step.cond(seen, self._cs)):
                run()
                res.steps += 1
            self._phase("dispatch", time.time() - t)
            if tracer.enabled:
                tracer.complete("chunk", t_span)
            with self._span("stats_fetch"):
                return self._cs.st.tolist(), captured
        done, at = 0, offset
        while True:
            n = min(allowed - done, -(-(cur_count - at) // self._B))
            t = time.time()
            self._dispatch(run, n, seen)
            res.steps += n
            t_s = time.time()
            t_f = time.perf_counter()
            st = self._cs.st.tolist()          # the chunk's device sync
            self._phase("dispatch", t_s - t)
            self._phase("sync", time.time() - t_s)
            if not st[self._step.CUR + 2]:
                if tracer.enabled:
                    # One chunk span a call (its bursts included) and the
                    # last stats read, as the JAX engine's chunk call.
                    tracer.complete("chunk", t_span)
                    tracer.complete("stats_fetch", t_f)
                return st, captured
            done, at = st[ST_STEPS], st[ST_OFFSET]

    def _observe_chunk(self, qcur, qnext, seen, offset: int,
                       cur_count: int) -> None:
        """Before a chunk call (between graph replays): the launch model
        at the first call with perf on, and the profiler's sample of the
        batch the call expands first.  Neither changes what the engine
        computes."""
        pf, prof = self._perf, self._profiler
        if pf is not None and pf.wants_model(self._xla_capture):
            t = time.time()

            def idle_step():
                self._write_idle_ctl()
                self._step(qcur, seen, qnext, self._tbuf, self._cs)

            pf.measure(idle_step,
                       lambda: self._dispatch(lambda: None, 0, seen))
            self._phase("profile", time.time() - t)
        if prof is not None and prof.want():
            t = time.time()
            B = self._B
            with self._span("profile"):
                prof.sample(qcur[offset:offset + B],
                            (offset + torch.arange(B, device=self.device))
                            < cur_count)
            self._phase("profile", time.time() - t)

    def _spill(self, inflight, free_q, qnext, count: int):
        """Start draining ``count`` rows of ``qnext`` to the host and
        return the spare queue to go on with.  On the card the copy runs
        on a copy stream into pinned memory, behind the next chunks."""
        ev = None
        if self.device.type == "cuda":
            if self._pinned is None:
                self._pinned = torch.empty(qnext.shape, dtype=qnext.dtype,
                                           pin_memory=True)
            cur = torch.cuda.current_stream(self.device)
            self._copy_stream.wait_stream(cur)
            with torch.cuda.stream(self._copy_stream):
                self._pinned[:count].copy_(qnext[:count], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self._copy_stream)
        inflight.append((qnext, count, ev))
        return free_q.pop()

    def _resolve_spill(self, inflight, free_q, spill_next):
        """Land the drain in flight in the spill pool; its queue becomes
        the spare."""
        while inflight:
            buf, count, ev = inflight.pop(0)
            with self._span("spill"):
                if ev is None:
                    spill_next.append(host_rows(buf[:count]))
                else:
                    ev.synchronize()
                    spill_next.append(self._pinned[:count].numpy(),
                                      copy=True)
            free_q.append(buf)

    # ------------------------------------------------------------------
    def run(self, init_states: Optional[List[PyState]] = None,
            resume: Union[None, str, ckpt_mod.Checkpoint,
                          ResumePoint] = None) -> EngineResult:
        """Check from ``init_states``, or continue from ``resume``: a
        snapshot's path, a loaded ``Checkpoint`` or a ``ResumePoint``.

        On running out of device memory (``torch.cuda.OutOfMemoryError``
        or what ``is_resource_exhausted`` accepts, and only on that) with
        ``degrade_on_oom``: rebuild at half the batch, down to
        ``min_batch``, and go on from this run's newest snapshot in
        ``checkpoint_dir`` or from the start.  A snapshot that was in the
        directory before a fresh run belongs to another run and is never
        taken.

        The run's events go to ``events_out`` (``run_start`` ...
        ``run_end``), and at its end come the coverage, the statespace
        report and, on a traced violation, the counterexample files
        (``_finish``)."""
        if (init_states is None) == (resume is None):
            raise ValueError("need exactly one of init_states or resume")
        cfg, mt = self.config, self.metrics
        self._evlog = evlog = RunEventLog(self._events_path())
        self._phase_base = mt.phase_seconds()
        self._collision_base = mt.counter_value("engine/fp_collisions")
        self._hbm_watermark = 0
        self._result = None
        self.coverage = None
        for obs in (self._profiler, self._perf):
            if obs is not None:
                obs.reset()
        if self.tracer.enabled:
            self.tracer.reset()             # one trace file, one run
        # The black box, armed before the first event so run_start is in
        # its ring.
        _FLIGHT.arm(self._postmortem_path(), metrics=mt, context={
            "engine": type(self).__name__, "dims": repr(self.dims),
            "batch": cfg.batch, "resume": resume is not None,
            "pipeline": self._plan_name, "fused_stages": dict(self._plan),
            **dict(cfg.run_context_extra or {})})
        _FLIGHT.set_live_evlog(evlog)
        self._xla_capture = None
        if cfg.xla_profile_chunks:
            from ..obs.profile import ProfileCapture
            self._xla_capture = ProfileCapture(
                self._xla_profile_dir(), cfg.xla_profile_chunks,
                self.device)
            self._xla_capture.start()
        self._run_t0 = self._lvl_t0 = time.perf_counter()
        evlog.emit(
            "run_start", engine=type(self).__name__, dims=repr(self.dims),
            batch=cfg.batch, sync_every=cfg.sync_every,
            record_trace=cfg.record_trace, resume=resume is not None,
            memory=device_memory_stats(self.device),
            trace_store=self.trace.kind, **self._run_start_fields())
        err = None
        try:
            return self._run_degradable(init_states, resume)
        except BaseException as e:
            err = e
            raise
        finally:
            self._finish(err)

    def _events_path(self) -> Optional[str]:
        """Where the run's events go (``events_out``, else next to the
        checkpoints, else nowhere)."""
        return events_path(self.config.events_out, self.config.checkpoint_dir)

    def _run_start_fields(self) -> dict:
        """Fields the ``run_start`` event carries beyond the common
        ones (the mesh under a process group adds its layout)."""
        return {}

    def _counterexample_base(self) -> str:
        """The stem of the counterexample files."""
        return "counterexample"

    def _postmortem_path(self) -> Optional[str]:
        """Where the flight recorder dumps on an abnormal end
        (``postmortem_dir``, else next to the checkpoints, else
        nowhere)."""
        d = self.config.postmortem_dir or self.config.checkpoint_dir
        return os.path.join(d, "postmortem.json") if d else None

    def _xla_profile_dir(self) -> str:
        """Where ``--xla-profile`` writes: ``xla_profile_dir``, else next
        to the checkpoints, else ``./xla_profile``."""
        cfg = self.config
        if cfg.xla_profile_dir:
            return cfg.xla_profile_dir
        return os.path.join(cfg.checkpoint_dir or ".", "xla_profile")

    def _span(self, name: str):
        """A span of the run's trace (a no-op with tracing off)."""
        return self.tracer.span(name)

    def _finish(self, err):
        """The run's end, as the JAX engine's: the final coverage, the
        counterexample files, the statespace report, the chunk profile,
        the perf block, the capture's event, on an error the postmortem
        dump, and ``run_end``; the flight recorder disarmed, the event log
        closed, the trace written.  A failing render is reported and never
        hides the run's own verdict."""
        cfg, mt, evlog = self.config, self.metrics, self._evlog
        res, cov = self._result, self.coverage
        if res is not None and cov is not None:
            res.coverage = cov.snapshot()
            cov.feed_metrics(mt)
            if cov.total_generated:
                evlog.emit("coverage", final=True, level=res.diameter,
                           actions=res.coverage)
            if cfg.progress_interval_seconds:
                print(cov.render_table(), file=sys.stderr)
        ce_path = None
        ce_dir = cfg.counterexample_dir or cfg.checkpoint_dir
        if (err is None and res is not None and res.violation is not None
                and cfg.record_trace and ce_dir):
            try:
                from .explain import write_counterexample
                res.counterexample = write_counterexample(
                    self, res, ce_dir, basename=self._counterexample_base())
                ce_path = res.counterexample["txt"]
            except Exception as e:
                print(f"counterexample render failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)
        if cfg.statespace_report and res is not None and err is None:
            res.report = report_mod.build_report(
                res, coverage=cov, level_stats=res.level_stats,
                seen_capacity=int(mt.gauge_value(
                    "engine/seen_capacity")) or None,
                seen_size=int(mt.gauge_value("engine/seen_size")),
                observed_collisions=int(
                    mt.counter_value("engine/fp_collisions")
                    - self._collision_base))
            report_mod.feed_metrics(res.report, mt)
            evlog.emit("statespace", report=res.report)
            if cfg.progress_interval_seconds:
                print(report_mod.render_report(res.report), file=sys.stderr)
        # Read after the run: a degradation rebuilt both for its batch.
        prof, pf = self._profiler, self._perf
        if prof is not None:
            if res is not None:
                res.chunk_stages = prof.stage_means()
            prof.finish(evlog)
        if pf is not None and err is None and res is not None:
            try:
                res.perf = pf.finish(evlog, chunk_stages=res.chunk_stages)
            except Exception as e:
                print(f"perf: block assembly failed "
                      f"({type(e).__name__}: {e})", file=sys.stderr)
        if self._xla_capture is not None:
            self._xla_capture.finish(evlog)
        # An exception escaping the run is an abnormal end: the black box
        # is dumped and its path goes on run_end.
        pm_path = None
        if err is not None:
            pm_path = _FLIGHT.dump(f"run error: {type(err).__name__}: {err}")
            if pm_path is not None:
                evlog.emit("postmortem", dump={"path": pm_path,
                                               "reason": "run_error"})
        evlog.emit(
            "run_end",
            stop_reason=(getattr(res, "stop_reason", None)
                         if err is None else "error"),
            error=(f"{type(err).__name__}: {err}" if err is not None
                   else None),
            postmortem_path=pm_path, counterexample_path=ce_path,
            distinct=getattr(res, "distinct", None),
            generated=getattr(res, "generated", None),
            diameter=getattr(res, "diameter", None),
            levels=list(getattr(res, "levels", None) or []),
            wall_seconds=getattr(res, "wall_seconds", None),
            growth_stalls=len(getattr(res, "growth_stalls", ())),
            phase_seconds=phase_delta(mt.phase_seconds(), self._phase_base),
            memory=device_memory_stats(self.device),
            host_rss_peak_bytes=peak_host_rss_bytes(),
            devices_memory=all_device_memory_stats(self.device))
        _FLIGHT.set_live_evlog(None)
        _FLIGHT.disarm()        # ended or already dumped: no exit dump
        evlog.close()
        self._evlog = RunEventLog(None)
        if self.tracer.enabled:
            self.tracer.complete("run", self._run_t0,
                                 engine=type(self).__name__,
                                 stop_reason=getattr(res, "stop_reason",
                                                     None))
            self.tracer.write()

    def _run_degradable(self, init_states, resume) -> EngineResult:
        """The run, retried at half the batch on running out of device
        memory (see ``run``)."""
        cfg = self.config
        user_resume = resume is not None
        preexisting = (set(os.listdir(cfg.checkpoint_dir))
                       if cfg.checkpoint_dir
                       and os.path.isdir(cfg.checkpoint_dir) else set())
        degraded, steps = [], 0
        while True:
            try:
                res = self._run_impl(init_states, resume)
                res.degraded = degraded
                res.steps += steps
                return res
            except Exception as e:
                if not is_resource_exhausted(e):
                    raise
                why = f"{type(e).__name__}: {str(e)[:300]}"
                cfg = self.config
                new_batch = cfg.batch // 2
                if not cfg.degrade_on_oom \
                        or new_batch < max(1, cfg.min_batch):
                    raise
            # Out of the handler: the failed run's tensors are released.
            steps += self._result.steps
            ck = (ckpt_mod.latest(cfg.checkpoint_dir)
                  if cfg.checkpoint_dir else None)
            if ck is not None and not user_resume \
                    and os.path.basename(ck) in preexisting:
                ck = None              # another run's snapshot: restart
            if ck is not None:
                init_states, resume = None, ck
            degraded.append((cfg.batch, new_batch, ck))
            self._evlog.emit(
                "degraded", reason="resource_exhausted",
                error=why, batch=cfg.batch,
                new_batch=new_batch, resume_from=ck,
                memory=device_memory_stats(self.device))
            self.metrics.counter("engine/degraded")
            print(f"degraded: out of device memory; retrying at batch "
                  f"{new_batch}" + (f", resuming {ck}" if ck else ""),
                  file=sys.stderr)
            self._rebuild_at_batch(new_batch)

    def _rebuild_at_batch(self, new_batch: int) -> None:
        """The engine again at a smaller batch (re-entrant ``__init__``),
        its graphs and buffers released first."""
        self.release()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        BFSEngine.__init__(
            self, self.dims,
            invariants=dict(zip(self.inv_names, self._inv_fns)),
            constraint=self._constraint,
            config=dataclasses.replace(self.config, batch=new_batch),
            device=self.device)

    def _run_impl(self, init_states, resume) -> EngineResult:
        dims, cfg, dev = self.dims, self.config, self.device
        sw, B, Q = self._sw, self._B, self._Q
        res = self._result = EngineResult(
            pipeline=self._plan_name, fused_stages=dict(self._plan),
            device=str(dev), por_instances=(self._por_table.certified
                                            if self._por_table else 0),
            family_groups=report_mod.family_groups(dims))
        mt, evlog = self.metrics, self._evlog
        coverage = self.coverage = ActionCoverage(dims.family_names,
                                                  dims.family_sizes)
        if isinstance(resume, str):
            resume = ckpt_mod.load(resume)
        if isinstance(resume, ckpt_mod.Checkpoint):
            check_resume_trace(cfg, resume)
            resume = self.resume_point(resume)
        res.phases.update(dict.fromkeys(PHASES, 0.0))
        trace = self.trace = make_trace_store(cfg.trace_store)
        res.trace_store = trace.kind
        t_enter = time.time()
        QA = Q + self._PAD
        F = len(dims.family_sizes)

        def queue():
            return torch.zeros((QA, sw), dtype=ROW_DTYPE, device=dev)

        # A warm engine's graphs were captured on the last run's buffers,
        # which this run allocates anew: a graph keyed on a queue that
        # lands at the same address would write the old trace buffer and
        # counters.  Every run captures its own.
        self._drop_graphs()
        with self._span("warmup"):
            qcur, qnext = queue(), queue()
            free_q = [queue()]          # the async spill's spare
            self._tbuf = torch.zeros((self._TA, chunk_mod.TRACE_ROW),
                                     dtype=torch.uint8, device=dev)
            self._cs = chunk_mod.chunk_state(F, sw, dev)
            self._ctl = torch.zeros(chunk_mod.state_words(F),
                                    dtype=torch.int32,
                                    pin_memory=dev.type == "cuda")
            self._pinned = None
            if dev.type == "cuda":
                self._copy_stream = torch.cuda.Stream(dev)
        inflight: List = []         # drains not yet landed
        pending = SpillPool(cfg.spill_dir)      # host segments of this level
        spill_next = SpillPool(cfg.spill_dir)   # host segments of the next

        t0 = time.time()
        if resume is not None:
            seen = resume.seen
            seen_size = int(seen.size[0])
            while seen_size > seen.capacity // 2:
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
            # The generated series goes on from the snapshot, so the final
            # table still equals action_counts (distinct and expanded
            # restart from zero, as in the JAX engine).
            coverage.seed_generated(resume.action_counts)
            # Duration accumulates across restarts: wall_seconds, the rate
            # and the max_seconds budget all measure total checking time.
            t0 -= resume.wall_seconds
            if cfg.record_trace and resume.trace is not None:
                trace.add_batch(*resume.trace)
                trace.roots.update(resume.roots)
        else:
            rows_all = self._root_rows(init_states, res, trace, t_enter)
            if rows_all is None:
                return res
            seen = fpset.empty(self._seen_cap, dev)
            t0 = time.time()
            next_count = seen_size = 0
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
                        next_count + spill_next.total_rows()
                        + rows_all.shape[0] - base)
                    if hit:
                        res.stop_reason = hit
                        break
                t_h = time.time()
                rows = torch.zeros((B, sw), dtype=ROW_DTYPE, device=dev)
                part = rows_all[base:base + B]
                rows[:part.shape[0]] = part
                valid = torch.arange(B, device=dev) < part.shape[0]
                with self._span("ingest"):
                    n_new, next_count, fail, new, fph, fpl, inv = \
                        self._absorb(rows, valid, seen, qnext, next_count)
                res.distinct += n_new
                with self._span("trace_flush"):
                    self._record(new, fph, fpl)
                if fail:
                    raise RuntimeError("seen-set probe failure during "
                                       "ingest; raise seen_capacity")
                mt.counter("engine/distinct", n_new)
                seen_size = int(seen.size[0])
                seen, t0 = self._maybe_grow(seen, seen_size, res, t0)
                if next_count > self._QTH:
                    with self._span("spill"):
                        spill_next.append(host_rows(qnext[:next_count]))
                    res.spills += 1
                    evlog.emit("spill", rows=next_count, level=0,
                               where="ingest")
                    next_count = 0
                self._phase("host", time.time() - t_h)
                viol = new & (inv >= 0)
                if bool(viol.any()):
                    v = int(viol.to(torch.int32).argmax())
                    res.violation = Violation(
                        self.inv_names[int(inv[v])],
                        self._decode_row(rows[v]),
                        (int(fph[v]) << 32) | int(fpl[v]))
                    res.stop_reason = "violation"
                    evlog.emit("violation", invariant=res.violation.invariant,
                               fingerprint=hex(res.violation.fingerprint),
                               level=0)
                    break
            res.levels.append(next_count + spill_next.total_rows())
            mt.gauge("engine/seen_capacity", seen.capacity)
            mt.gauge("engine/seen_size", seen_size)
            self._emit_level_event(res, res.levels[-1])
            qcur, qnext = qnext, qcur
            cur_count = next_count
            pending, spill_next = spill_next, pending

        # The seen-set gauges, kept current a chunk (the progress line's
        # load and each level_stats row read them).
        mt.gauge("engine/seen_capacity", seen.capacity)
        mt.gauge("engine/seen_size", seen_size)
        self._batch_ema = 0.0       # measured seconds a batch
        last_progress = time.time()
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
                with self._span("checkpoint"):
                    self._write_checkpoint(qcur, cur_count, pending, seen,
                                           res, trace, wall=t_h - t0)
                last_ckpt = time.time()
                self._phase("checkpoint", last_ckpt - t_h)
                evlog.emit("checkpoint", level=res.diameter,
                           distinct=res.distinct)
            if cfg.max_diameter is not None \
                    and res.diameter >= cfg.max_diameter:
                res.stop_reason = "diameter_budget"
                break
            next_count = 0
            # Budgeted runs start each level with a one- or two-batch
            # probe and double the chunk from there (the JAX loop's ramp).
            calls_in_level = 0
            while True:
                offset = 0
                while offset < cur_count:
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
                    if _faults.ACTIVE:
                        # The JAX loop's sites: "kill" dies here (mid-
                        # level, past the level's snapshot), "oom" raises
                        # into the degradation path.
                        _faults.fire("kill", level=res.diameter,
                                     chunk=calls_in_level)
                        _faults.fire("oom", level=res.diameter,
                                     chunk=calls_in_level)
                    self._observe_chunk(qcur, qnext, seen, offset,
                                        cur_count)
                    t_call = time.time()
                    steps0 = res.steps
                    cap = self._xla_capture
                    with (cap.step() if cap is not None
                          else contextlib.nullcontext()):
                        st, captured = self._run_chunk(
                            qcur, qnext, seen, cur_count, offset,
                            next_count, allowed, res)
                    t0 += captured
                    t_h = time.time()
                    if self._perf is not None:
                        self._perf.add_chunk(res.steps - steps0,
                                             t_h - t_call - captured)
                    res.chunks += 1
                    steps = st[ST_STEPS]
                    if steps:
                        per = (t_h - t_call - captured) / steps
                        self._batch_ema = (per if not self._batch_ema else
                                           max(per, 0.5 * self._batch_ema
                                               + 0.5 * per))
                    res.batches += steps
                    offset, next_count = st[ST_OFFSET], st[ST_COUNT]
                    seen_size = st[ST_SEEN]
                    self._account_chunk(res, st, seen_size, seen.capacity,
                                        next_count)
                    inner = 0.0     # trace and spill, timed on their own
                    _FLIGHT.progress(
                        distinct=res.distinct, generated=res.generated,
                        diameter=res.diameter, frontier=cur_count,
                        offset=offset, next_count=next_count,
                        seen_size=seen_size,
                        elapsed=round(time.time() - t0, 3))
                    if cfg.record_trace and st[ST_TCOUNT]:
                        t_t = time.time()
                        with self._span("trace_flush"):
                            self._flush_trace(self._tbuf, st[ST_TCOUNT])
                        inner = time.time() - t_t
                        self._phase("trace", inner)
                    self._check_faults(st)
                    seen, t0 = self._maybe_grow(seen, st[ST_SEEN], res, t0)
                    if next_count > self._QTH \
                            and (offset < cur_count or pending):
                        # Drain to the host behind the next chunks.
                        t_s = time.time()
                        self._resolve_spill(inflight, free_q, spill_next)
                        with self._span("spill"):
                            qnext = self._spill(inflight, free_q, qnext,
                                                next_count)
                        res.spills += 1
                        evlog.emit("spill", rows=next_count,
                                   level=res.diameter, where="chunk_loop")
                        next_count = 0
                        self._phase("spill", time.time() - t_s)
                        inner += time.time() - t_s
                    # TLC's "queue" is the whole unexplored queue: the
                    # rest of this level and everything enqueued for the
                    # next, drains in flight too.
                    last_progress = self._verdict(
                        res, (st[ST_VINV], self._cs) if st[ST_VIOL] else None,
                        self._cs if st[ST_DEAD] else None,
                        lambda: (max(0, cur_count - offset)
                                 + pending.total_rows() + next_count
                                 + spill_next.total_rows()
                                 + sum(c for _b, c, _e in inflight)),
                        cur_count, seen_size / seen.capacity, t0,
                        last_progress)
                    self._phase("host", time.time() - t_h - inner)
                    if res.stop_reason != "exhausted":
                        break
                if res.stop_reason != "exhausted" or not pending:
                    break
                t_s = time.time()
                with self._span("upload"):
                    seg = np.require(pending.pop(0),
                                     requirements=["C", "W"])
                    qcur[:len(seg)] = torch.from_numpy(seg).to(dev)
                cur_count = len(seg)
                self._phase("spill", time.time() - t_s)
            if res.stop_reason != "exhausted":
                break
            t_s = time.time()
            self._resolve_spill(inflight, free_q, spill_next)
            self._phase("spill", time.time() - t_s)
            res.diameter += 1
            res.levels.append(next_count + spill_next.total_rows())
            self._emit_level_event(res, res.levels[-1])
            qcur, qnext = qnext, qcur
            cur_count = next_count
            pending, spill_next = spill_next, pending
        res.wall_seconds = time.time() - t0
        return res

    def _account_chunk(self, res, st, seen_size: int, capacity: int,
                       next_count: int):
        """A chunk's counters (``ST_*`` words, summed over shards on the
        mesh) into the result, the registry and the coverage."""
        S, F = chunk_mod.N_SCALARS, len(self.dims.family_sizes)
        mt = self.metrics
        res.distinct += st[ST_NEW]
        res.generated += st[ST_GEN]
        mt.counter("engine/distinct", st[ST_NEW])
        mt.counter("engine/generated", st[ST_GEN])
        mt.gauge("engine/seen_size", seen_size)
        mt.gauge("engine/seen_capacity", capacity)
        mt.gauge("engine/next_count", next_count)
        mt.gauge("engine/diameter", res.diameter)
        gen, new = st[S:S + F], st[S + F:S + 2 * F]
        pruned = st[S + 2 * F:S + 3 * F]
        for name, c, p in zip(self.dims.family_names, gen, pruned):
            res.action_counts[name] = res.action_counts.get(name, 0) + c
            res.action_pruned[name] = res.action_pruned.get(name, 0) + p
        # Coverage from the same stats read (obs/coverage.py).
        self.coverage.add_chunk(st[ST_EXPANDED], gen, new, pruned)

    def _check_faults(self, st):
        """Stop on an overflowing successor or a seen-set probe failure."""
        dims = self.dims
        if st[ST_OVF]:
            raise RuntimeError(
                f"{st[ST_OVF]} successors exceeded fixed-width "
                f"capacity (max_log={dims.max_log}, "
                f"n_msg_slots={dims.n_msg_slots}) or wrapped "
                "the uint8 row; rerun with larger capacities")
        if st[ST_FAIL]:
            raise RuntimeError(
                "seen-set probe failure (load spiked past the "
                "growth threshold within one batch); raise "
                "seen_capacity")

    def _verdict(self, res, viol, dead, queue_rows, level_frontier: int,
                 load: float, t0: float, last_progress: float) -> float:
        """After a chunk: the violation (``(invariant index, ChunkState)``)
        or the deadlock (the ``ChunkState`` holding it) it stopped on, else
        the progress line and the TLCGet budgets (``queue_rows()`` is read
        only when one needs it).  Returns the progress line's time."""
        cfg, evlog = self.config, self._evlog
        if viol is not None:
            inv, cs = viol
            vfp = cs.vfp.tolist()
            res.violation = Violation(self.inv_names[inv],
                                      self._decode_row(cs.vrow),
                                      (vfp[0] << 32) | vfp[1])
            res.stop_reason = "violation"
            evlog.emit("violation", invariant=res.violation.invariant,
                       fingerprint=hex(res.violation.fingerprint),
                       level=res.diameter)
            return last_progress
        if dead is not None and self._check_deadlock:
            res.deadlock = self._decode_row(dead.drow)
            res.stop_reason = "deadlock"
            evlog.emit("deadlock", level=res.diameter)
            return last_progress
        want_progress = bool(cfg.progress_interval_seconds
                             and time.time() - last_progress
                             >= cfg.progress_interval_seconds)
        if not (cfg.exit_conditions or want_progress):
            return last_progress
        rows = queue_rows()
        if want_progress:
            mt = self.metrics
            print(progress_line(res, t0, rows, level_frontier, load, mt),
                  file=sys.stderr)
            # Coverage rides the same cadence.
            self.coverage.feed_metrics(mt)
            evlog.emit("coverage", level=res.diameter,
                       actions=self.coverage.snapshot())
            last_progress = time.time()
        # A violation or deadlock in the same chunk outranks a budget stop.
        hit = exit_condition_hit(cfg.exit_conditions, res, rows)
        if hit:
            res.stop_reason = hit
        return last_progress

    def _root_rows(self, init_states, res, trace, t_enter):
        """The roots as packed rows on the engine's device, registered in
        the trace; None when a root violates an invariant (checked on its
        unpacked encoding; ``res`` then holds the violation)."""
        dims, cfg = self.dims, self.config
        encoded = [encode_state(s, dims) for s in init_states]
        roots = stack_states(encoded, self.device)
        if self._inv_id is not None:
            with self._span("root_check"):
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
                self._evlog.emit("violation",
                                 invariant=res.violation.invariant,
                                 fingerprint=hex(fp), level=0)
                return None
        for e in encoded:
            check_packable(e, dims)
        rows_all = flatten_state(roots, dims)
        if cfg.record_trace:
            with self._span("root_check"):
                rhi, rlo = self._fingerprint(unflatten_state(rows_all, dims))
                for i, (h, l) in enumerate(zip(rhi.tolist(),
                                               rlo.tolist())):
                    trace.roots.setdefault((h << 32) | l, init_states[i])
        return rows_all

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
                # Where a fingerprint collision becomes visible: counted
                # for the report's observed collisions.
                self.metrics.counter("engine/fp_collisions")
                raise RuntimeError(
                    f"replay divergence: no enabled candidate matches fp "
                    f"{child_fp:#018x} (recorded action {g_rec})")
            g = g_rec if 0 <= g_rec < ok.shape[0] and ok[g_rec] \
                else int(np.argmax(ok))
            state = decode_state(StateBatch(*(f[g] for f in succ)),
                                 self.dims)
            out.append((g, state))
        return out
