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
  replayed up to ``sync_every`` times.  The buffers and the graphs are
  the engine's: allocated and captured at its first run, reset in place
  at each later one (``_run_buffers``), so a warm engine's run replays
  the graphs an earlier run captured; the host reads the packed counters
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

The level loop (``_run_impl``, the roots' ``_ingest``) is the mesh's
too (``parallel/mesh.py``): it holds counts, seen sizes and stats words
as lists with one entry a shard, and what one shard does at each of its
steps is a method the mesh overrides for n.

``EngineResult.phases`` splits ``run()``'s wall time, on
``time.perf_counter``'s clock, into disjoint phases that cover it: the
run's set-up, the host's dispatch of each chunk, its waits for the device
(``sync``), graph capture, trace drains, spills and uploads, its own
bookkeeping, and the run's end (``PHASES``).
``EngineResult.device_seconds`` is the chunks' device time between CUDA
events (no wait added), ``alloc`` and ``gc`` the run's allocator and
garbage-collector counters.  ``EngineConfig.pipeline`` picks the chunk's
plan: "v3" (the default; the masks and lane stages in
PyTorch around the compaction kernel; "auto" and "v2", the JAX
package's names of its delta pipeline, run it too), "v4" (one front
kernel, ``ops/chunk_front_cuda.py``) or "v1" (the classical expansion of
``models/actions.py`` with the compaction, insert and enqueue kernels,
``ops/pipeline_v1.py``).  ``enqueue_method`` picks the tail: the fused
insert + enqueue kernel (the default; on v1 it resolves to the split
tail's enqueue kernel) or the split tail, the insert kernel followed by
the enqueue kernel or a PyTorch lowering.  Every combination gives equal
results.

Also the JAX engine's, in the same terms: level-boundary checkpoints in
its ``.npz`` format and ``run(resume=...)`` (``engine/checkpoint.py``; a
snapshot of either package resumes in the other), the TLCGet exit
budgets over distinct / generated / queue (checked after each chunk),
and the partial-order reduction fed by a certified table
(``analysis/por.py``; ``por=True`` certifies one in process through the
analyzer, against this run's invariants and constraint).

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
the loop's spans under the JAX names; beyond them ``setup``, ``finish``,
one ``capture`` a graph, ``gc`` and ``spill_wait``; the file written once,
at the run's end, its ``ts`` on the profiler's Unix-epoch clock and the
run's id on the ``run`` span), the flight recorder armed for the
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

from ..models.actions import build_expand
from ..models.actions2 import ParentHash, build_v2
from ..models.dims import RaftDims, family_groups
from ..models.invariants import build_inv_id
from ..models.pystate import PyState
from ..models.schema import (ROW_DTYPE, StateBatch, check_packable,
                             decode_state, encode_state, flatten_state,
                             gather_states, stack_states, state_width,
                             unflatten_state)
from ..analysis import por as por_mod
from ..obs import report as report_mod
from ..obs.coverage import ActionCoverage
from ..obs.events import (GcWatch, RunEventLog, all_device_memory_stats,
                          alloc_delta, device_memory_stats, events_path,
                          next_run_id, peak_host_rss_bytes)
from ..obs.flight import RECORDER as _FLIGHT
from ..obs.metrics import PHASE_PREFIX, MetricsRegistry, phase_delta
from ..obs.tracing import SpanTracer
from ..ops import chunk_front_cuda, compact_cuda, enqueue_cuda
from ..ops import compact as compact_mod
from ..ops import fpset, fpset_cuda, fused_tail_cuda, pipeline_v3
from ..ops import pipeline_v1, pipeline_v4, step_glue_cuda
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

PLANS = {"v1": pipeline_v1, "v3": pipeline_v3, "v4": pipeline_v4}

#: ``EngineConfig.pipeline`` -> plan.  The JAX package's "auto" (its
#: default) and "v2" (its delta pipeline) are the v3 plan's semantics
#: with the same counts; "v1" is the classical expansion.
PLAN_NAMES = {"v1": "v1", "v3": "v3", "v4": "v4", "auto": "v3",
              "v2": "v3"}


def resolve_pipeline(pipeline: str) -> str:
    """``EngineConfig.pipeline`` -> the plan's name (``PLAN_NAMES``)."""
    if pipeline not in PLAN_NAMES:
        raise ValueError(f"pipeline must be one of {sorted(PLAN_NAMES)}, "
                         f"got {pipeline!r}")
    return PLAN_NAMES[pipeline]

#: The phases of ``EngineResult.phases``, disjoint, in the order a run
#: meets them (``EngineResult.phases`` says what each holds).
PHASES = ("setup", "dispatch", "sync", "capture", "trace", "spill",
          "upload", "host", "checkpoint", "loop", "finish")

#: The kernel wrappers' modules (the step's two launches: the wrappers
#: themselves), whose ``launches`` a graph replay adds to.
KERNEL_MODULES = (compact_cuda, fpset_cuda, fused_tail_cuda,
                  chunk_front_cuda, enqueue_cuda, step_glue_cuda.step_begin,
                  step_glue_cuda.step_end)


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
    dt = max(time.perf_counter() - t0, 1e-9)
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
    pipeline: str = "v3"     # chunk plan: "v1", "v3" or "v4" (PLAN_NAMES)
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
    # the path of its artifact, admission-checked at engine build;
    # por=True without a table certifies one in process.
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
    # Host seconds (time.perf_counter), disjoint, which together cover
    # run() from its entry to the run_end event: "setup" (run()'s entry
    # to the first chunk, less the phases nested in it: the event log,
    # the flight recorder's arm, the run's buffers allocated or reset,
    # the roots), "dispatch" (queueing a chunk's steps), "sync" (waiting for
    # the device at the chunk's stats read), "capture" (CUDA graph
    # capture, off the duration clock), "trace" (device trace buffer
    # drains), "spill" (queue drains to the host), "upload" (a spilled
    # segment back to the device), "host" (the loop's other bookkeeping:
    # root ingest, growth, budgets), "checkpoint" (snapshot writes),
    # "loop" (the level loop's time outside the phases above: each
    # chunk's control words, the level boundaries' stats and events),
    # "finish" (the run's end: coverage, report, the span file written);
    # "profile" too when a profiler samples.
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    # The chunks' CUDA graphs this run captured, and the chunks that
    # replayed one an earlier chunk or run had captured (both 0 on the
    # CPU): a warm engine's run captures none.
    graph_captures: int = 0
    graph_hits: int = 0
    # The successors the v4 step's build launch built after the seen-set
    # insert: one a lane the insert found new, so also the states the
    # invariants were evaluated on in the steps (distinct less the roots
    # on a run with no insert failure).  0 on the plans that build every
    # compacted lane before the insert (v1, v3, the mesh).
    built: int = 0
    # Of those, the successors in which some server's latest config entry
    # is joint (C_old,new: BecomeLeader and AdvanceCommitIndex take
    # majorities of both configurations there), counted by the
    # reconfiguration variant's build launches; 0 for the spec and on the
    # other plans.
    joint: int = 0
    # The run's id, unique in the process (obs/events.py next_run_id): on
    # the run span, the span file's metadata, run_start and run_end.
    run_id: str = ""
    # Device seconds of the chunks' graph replays, between two CUDA
    # events a burst (0 on the CPU); over wall_seconds, the card's busy
    # share without a profiler.
    device_seconds: float = 0.0
    # The caching allocator over the run (obs/events.py alloc_delta):
    # retries, device_mallocs, device_frees, reserved_start and
    # reserved_end bytes; {} on the CPU.
    alloc: Dict[str, int] = dataclasses.field(default_factory=dict)
    # Python's garbage collections during the run (obs/events.py
    # GcWatch.summary): collections, seconds, gen2_collections,
    # gen2_seconds, collected.
    gc: Dict[str, float] = dataclasses.field(default_factory=dict)
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
    # The invariants the run evaluated, in the cfg's order.
    invariants: List[str] = dataclasses.field(default_factory=list)
    # The v4 front of the engine (BFSEngine.front_info), {} on other plans.
    front: Dict = dataclasses.field(default_factory=dict)

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
    None (POR off).  Shared by the single-device and mesh engines.  A
    path loads the artifact (its fingerprint is checked there);
    ``por=True`` without a table certifies one in process against
    exactly this run's invariants and constraint (the analyzer traces on
    the CPU whatever the engine's device).  Either way ``check_table``
    then holds the table to this run's model, invariants and
    constraint."""
    if not cfg.por and cfg.por_table is None:
        return None
    table = cfg.por_table
    if isinstance(table, str):
        table = por_mod.load_table(table)
    if table is None:
        table = por_mod.build_table(dims, invariants=dict(invariants),
                                    constraint=constraint)
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
        # registry and the open event log.  The mesh sizes its shards'
        # tables and builds their step in the methods it overrides.
        self.dims = dims
        self.config = cfg = config or EngineConfig()
        self.device = dev = resolve_device(device)
        if not hasattr(self, "metrics"):
            self.metrics = (cfg.metrics if cfg.metrics is not None
                            else MetricsRegistry())
            self._evlog = RunEventLog(None)
            self.tracer = SpanTracer(self._trace_out())
            self.metrics.tracer = self.tracer
            self._xla_capture = None
        self.inv_names = list((invariants or {}).keys())
        self._inv_fns = list((invariants or {}).values())
        self._inv_id = (build_inv_id(self._inv_fns) if self._inv_fns
                        else None)
        self._constraint = constraint
        self._plan_name = resolve_pipeline(cfg.pipeline)
        self._v2 = build_v2(dims, dev)
        self._expand = (build_expand(dims, dev) if self._plan_name == "v1"
                        else None)
        self._plan, self._plan_reasons, self._method = self._resolve_plan()
        if cfg.checkpoint_dir is not None:
            ckpt_mod.check_dims_checkpointable(dims)
        self._por_table = resolve_por(cfg, dims, invariants or {},
                                      constraint)
        self._check_deadlock = (True if cfg.check_deadlock is None
                                else cfg.check_deadlock)
        sw = state_width(dims)
        B, G = cfg.batch, dims.n_instances
        K = compact_mod.choose_k(B, G, cfg.compact_lanes)
        Q = self._size_tables(sw, B, K)
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
        self._graphs: Dict[tuple, tuple] = {}
        self._pool = None
        self._warm = False
        self.trace = make_trace_store(cfg.trace_store)
        self._build_step()

    def _trace_out(self) -> Optional[str]:
        """The span file (``trace_out``)."""
        return self.config.trace_out

    def _resolve_plan(self):
        """``(fused_stages, fused_reasons, enqueue_method)`` of the plan
        on the engine's device; v1 has no fused tail: "fused" resolves to
        the enqueue kernel."""
        method, reasons = self.config.enqueue_method, {}
        if self._plan_name == "v1":
            method, reasons = pipeline_v1.resolve_method(method)
        return (PLANS[self._plan_name].resolve_plan(
            self.device, self.config.enqueue_method), reasons, method)

    def _size_tables(self, sw: int, B: int, K: int) -> int:
        """The queue's rows Q (a multiple of B, at least K) and the seen
        table's first capacity, as configured or from the card's
        memory."""
        cfg = self.config
        qreq, sreq = cfg.queue_capacity, cfg.seen_capacity
        if qreq is None or sreq is None:
            auto_q, auto_s = auto_capacities(sw, B, cfg.record_trace,
                                             device_memory(self.device))
            qreq = auto_q if qreq is None else qreq
            sreq = auto_s if sreq is None else sreq
        self._seen_cap = max(sreq, 8 * K)
        return max(-(-qreq // B) * B, K)

    def _build_step(self) -> None:
        """The chunk step (v4: behind its front kernel), the fingerprint
        and the observers on the engine's device."""
        cfg, dims, dev, B, K = (self.config, self.dims, self.device,
                                self._B, self._K)
        por_mask, por_priority = por_device_arrays(self._por_table, dev)
        self._fingerprint = build_fingerprint(dims, dev)
        front = None
        if self._plan_name == "v4":
            front = Front(dims=dims, v2=self._v2, inv_fns=self._inv_fns,
                          constraint=self._constraint, B=B, K=K, device=dev,
                          por_mask=por_mask, por_priority=por_priority)
        self._front, self._front_info = front, None
        self._step = chunk_mod.ChunkStep(
            dims=dims, B=B, K=K, Q=self._Q, QTH=self._QTH, TQ=self._TQ,
            record_trace=cfg.record_trace,
            check_deadlock=self._check_deadlock, device=dev,
            v2=self._v2, inv_fns=self._inv_fns, constraint=self._constraint,
            front=front, enqueue_method=self._method,
            por_mask=por_mask, por_priority=por_priority,
            expand=self._expand)
        self._build_observers(dict(
            v2=self._v2, inv_fns=self._inv_fns, constraint=self._constraint,
            record_trace=cfg.record_trace,
            enqueue_method=self._method, por_mask=por_mask,
            por_priority=por_priority, expand=self._expand))

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
                enqueue_method=self._method)
        self._perf = None
        if cfg.perf:
            from ..obs import perf as perf_mod
            from ..obs import roofline
            self._perf = perf_mod.PerfAccounting(
                pipeline=pipeline,
                stage_traffic=roofline.walked_floors(
                    "BFSEngine", dims, self._B, self._K, pipeline=pipeline,
                    enqueue_method=self._method),
                device=dev, metrics=self.metrics)

    # ------------------------------------------------------------------
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
        grown table is the engine's from here on, later runs included,
        and the graphs captured on the old one go with it.  A growth that
        runs out of device memory is retried once from the host keys
        (``_grow_from_host``); the ``oom`` fault site (param ``grow``,
        the engine's growth count) rehearses that."""
        if size <= seen.capacity // 2:
            return seen, t0
        t = time.perf_counter()
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
        seen = self._keep_seen(grown)
        stall = time.perf_counter() - t
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

    # The residual phases ("setup", "loop", "finish") hold a stretch of
    # the run less the phases timed inside it, so the phases cover run()
    # without a timer around every statement.  One is open at a time.
    def _open_residual(self, name: str, now: float) -> None:
        res = self._result
        self._residual = (name, now,
                          sum(res.phases.values()) if res else 0.0)

    def _close_residual(self, now: float) -> None:
        """The open residual phase's seconds, up to ``now``."""
        if self._residual is None or self._result is None:
            return
        name, start, base = self._residual
        self._residual = None
        nested = sum(self._result.phases.values()) - base
        self._phase(name, max(0.0, now - start - nested))

    def _next_residual(self, name: str) -> None:
        """Close the open residual phase and open ``name`` at the same
        instant."""
        now = time.perf_counter()
        self._close_residual(now)
        self._open_residual(name, now)

    def front_info(self) -> dict:
        """The engine's v4 front (``Front.record``: its build, its
        predicates' codes, each launch's registers, spill and shared bytes
        and blocks an SM), made at the first call after a build; {} on
        the other plans."""
        if self._front_info is None:
            self._front_info = ({} if self._front is None
                                else self._front.record())
        return self._front_info

    def _start_level0(self) -> None:
        """Level 0 begins: the ``setup`` span (``run()``'s entry to here:
        the event log, the flight recorder, ``run_start``, a snapshot's
        load; its args carry the engine's front) ends, and the first
        ``level`` span starts.  The result takes the invariants' names and
        the front here."""
        res = self._result
        res.invariants = list(self.inv_names)
        res.front = self.front_info()
        self._lvl_t0 = time.perf_counter()
        if self.tracer.enabled:
            self.tracer.interval("setup", self._run_t0, self._lvl_t0,
                                 run_id=self._run_id, front=res.front)

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

    def _write_checkpoint(self, qcur, cur_counts, pending, seen, res, trace,
                          wall):
        """Snapshot the level boundary: this level's frontier (device rows,
        then the host segments), the seen keys, counters and trace."""
        with self._span("checkpoint"):
            seen_hi, seen_lo = fpset.to_host_keys(seen)
            self._save_checkpoint(
                np.concatenate([host_rows(qcur[:cur_counts[0]]),
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
        back, and returned as what each replay launches; a capture that
        fails gives them back too (what it recorded never runs)."""
        if not self._warm:
            self._write_idle_ctl()
            fn()
            res.steps += 1
            self._warm = True
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = [m.launches for m in KERNEL_MODULES]
        delta = []
        try:
            g = capture_graph(fn, self.device, self._pool)
        finally:
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

    #: What the engine keeps on its device besides the graphs, from its
    #: first run to ``release``: every buffer a graph reads or writes.
    _RUN_BUFFERS = ("_queues", "_seen", "_tbuf", "_cs", "_ctl", "_pinned",
                    "_copy_stream", "_burst_events", "_queue_names",
                    "_free_q", "_inflight")

    def release(self) -> None:
        """Give back what the engine holds on its device (the checker
        service calls it on a warm engine it evicts, the OOM degradation
        mid-run): the captured graphs first, whose memory pool lives as
        long as they do, then the buffers they were captured on."""
        self._drop_graphs()
        for name in self._RUN_BUFFERS:
            self.__dict__.pop(name, None)

    def _run_buffers(self, fresh_table: bool):
        """The run's queues ``(qcur, qnext)`` and seen table (None when
        ``fresh_table`` is false: a resumed run brings its own,
        ``_keep_seen``); the third queue is the async spill's spare
        (``_free_q``).  The engine's first run allocates
        them with the trace buffer, the chunk state and the control words;
        every later run gets the same tensors back, in the same order, so
        its chunks hit the graphs an earlier run captured.  The reset is
        what the run's semantics read: the table emptied here; the chunk
        state's words, the trace count among them, and the control words
        are written whole at every chunk's start (``_write_ctl``), and the
        violating and deadlocked rows are read only when that chunk set
        their flags.  Queue and trace rows past their live counts are
        left as the last run wrote them: the window gathers rows past the
        level's count only as invalid parents, whose lanes the masks
        drop, and nothing else reads them (within a run they hold an
        older level's rows anyway)."""
        dev = self.device
        with self._span("warmup"):
            if "_queues" not in self.__dict__:
                F = len(self.dims.family_sizes)
                bufs = dict(
                    _queues=tuple(torch.zeros(
                        (self._Q + self._PAD, self._sw), dtype=ROW_DTYPE,
                        device=dev) for _ in range(3)),
                    _seen=None, _pinned=None,
                    _tbuf=torch.zeros((self._TA, chunk_mod.TRACE_ROW),
                                      dtype=torch.uint8, device=dev),
                    _cs=chunk_mod.chunk_state(F, self._sw, dev),
                    _ctl=torch.zeros(chunk_mod.state_words(F),
                                     dtype=torch.int32,
                                     pin_memory=dev.type == "cuda"))
                bufs["_queue_names"] = {q.data_ptr(): f"q{i}" for i, q in
                                        enumerate(bufs["_queues"])}
                if dev.type == "cuda":
                    bufs["_copy_stream"] = torch.cuda.Stream(dev)
                    bufs["_burst_events"] = (
                        torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                self.__dict__.update(bufs)      # all of them, or none
            elif dev.type == "cuda":
                # A drain the last run left in flight reads a queue this
                # run writes.
                torch.cuda.current_stream(dev).wait_stream(
                    self._copy_stream)
            if fresh_table and self._seen is None:
                self._seen = fpset.empty(self._seen_cap, dev)
            elif fresh_table:
                fpset.clear(self._seen)
        qcur, qnext, spare = self._queues
        self._free_q, self._inflight = [spare], []
        return qcur, qnext, self._seen if fresh_table else None

    def _keep_seen(self, seen):
        """``seen`` as the engine's table from here on (a growth's, a
        resumed run's); the graphs captured on another table go, since a
        graph writes the table it was captured on."""
        if seen is not self.__dict__.get("_seen"):
            self._drop_graphs()
            self._seen = seen
        return seen

    def _runner(self, qcur, qnext, seen, res):
        """One step on these buffers: a graph replay on the card (captured
        at first use; a capture that fails raises), the step itself on the
        CPU."""
        eager = self._eager(qcur, qnext, seen)
        if self.device.type != "cuda":
            return eager
        names = self._queue_names
        return self._graph_replay(
            (qcur.data_ptr(), qnext.data_ptr(), seen.keys.data_ptr()),
            eager, res, lambda: (f"{names.get(qcur.data_ptr(), '?')}>"
                                 f"{names.get(qnext.data_ptr(), '?')}, "
                                 f"seen {seen.capacity}"))

    def _eager(self, qcur, qnext, seen):
        """One step on these buffers, run as it is."""
        step, tbuf, cs = self._step, self._tbuf, self._cs
        return lambda: step(qcur, seen, qnext, tbuf, cs)

    def _graph_replay(self, key, eager, res, buffers=None):
        """A replay of ``eager``'s graph for the buffers ``key`` names
        (captured at first use, a ``capture`` span with the buffers,
        ``buffers()`` where given, and the allocator's deltas over it),
        which adds the launches the capture took to the wrappers'
        counts.  Each call counts a capture or a hit
        (``EngineResult.graph_captures`` / ``graph_hits``, the registry's
        ``engine/graph_captures`` / ``engine/graph_hits``)."""
        if key in self._graphs:
            res.graph_hits += 1
            self.metrics.counter("engine/graph_hits")
        else:
            tracer = self.tracer
            if tracer.enabled:
                t, mem0 = time.perf_counter(), device_memory_stats(
                    self.device)
            self._graphs[key] = self._capture(eager, res)
            res.graph_captures += 1
            self.metrics.counter("engine/graph_captures")
            if tracer.enabled:
                moved = alloc_delta(mem0, device_memory_stats(self.device))
                tracer.complete(
                    "capture", t,
                    buffers=buffers() if buffers is not None else str(key),
                    **{f"alloc_{k}": v for k, v in moved.items()})
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
        self._step.more(seen, self._cs)

    def _run_chunk(self, qcur, qnext, seen, cur_count: int, offset: int,
                   next_count: int, allowed: int, res) -> Tuple[list, float]:
        """Up to ``allowed`` batches of the level from ``offset``, as one
        JAX chunk call: returns the state words read once, and the
        seconds spent capturing (off the duration clock).  On the card
        the steps go out in bursts of at most the batches the level has
        left, so a burst wastes no step at a level's end unless progress
        limiting held a batch back; then a short burst follows.  Two CUDA
        events around each burst time it on the device, read after the
        burst's stats read has waited for it (``device_seconds``)."""
        t = time.perf_counter()
        try:
            run = self._runner(qcur, qnext, seen, res)
        finally:                    # a capture that fails is timed too
            captured = time.perf_counter() - t
            self._phase("capture", captured)
        self._write_ctl(offset, next_count, cur_count, allowed)
        tracer = self.tracer
        t_span = time.perf_counter()
        if self.device.type != "cuda":
            t = time.perf_counter()
            while bool(self._step.cond(seen, self._cs)):
                run()
                res.steps += 1
            t_f = time.perf_counter()
            self._phase("dispatch", t_f - t)
            st = self._cs.st.tolist()
            if tracer.enabled:
                tracer.interval("chunk", t_span, t_f, batches=st[ST_STEPS])
                tracer.complete("stats_fetch", t_f)
            return st, captured
        done, at, device_ms = 0, offset, 0.0
        ev0, ev1 = self._burst_events
        stream = torch.cuda.current_stream(self.device)
        while True:
            n = min(allowed - done, -(-(cur_count - at) // self._B))
            t = time.perf_counter()
            ev0.record(stream)
            self._dispatch(run, n, seen)
            ev1.record(stream)
            res.steps += n
            t_s = time.perf_counter()
            st = self._cs.st.tolist()          # the chunk's device sync
            self._phase("dispatch", t_s - t)
            self._phase("sync", time.perf_counter() - t_s)
            device_ms += ev0.elapsed_time(ev1)
            if not st[self._step.CUR + 2]:
                res.device_seconds += device_ms / 1e3
                if tracer.enabled:
                    # One chunk span a call (its bursts included) and the
                    # last stats read, as the JAX engine's chunk call.
                    tracer.complete("chunk", t_span,
                                    device_us=device_ms * 1e3,
                                    batches=st[ST_STEPS])
                    tracer.complete("stats_fetch", t_s)
                return st, captured
            done, at = st[ST_STEPS], st[ST_OFFSET]

    def _observe_chunk(self, qcur, qnext, seen, offset: int,
                       cur_counts) -> None:
        """Before a chunk call (between graph replays): the launch model
        at the first call with perf on, and the profiler's sample of the
        batch the call expands first.  Neither changes what the engine
        computes."""
        pf, prof = self._perf, self._profiler
        if pf is not None and pf.wants_model(self._xla_capture):
            t = time.perf_counter()
            step = self._eager(qcur, qnext, seen)

            def idle_step():
                self._write_idle_ctl()
                step()

            pf.measure(idle_step,
                       lambda: self._dispatch(lambda: None, 0, seen))
            self._phase("profile", time.perf_counter() - t)
        if prof is not None and prof.want():
            t = time.perf_counter()
            B = self._B
            with self._span("profile"):
                prof.sample(qcur[offset:offset + B],
                            (offset + torch.arange(B, device=self.device))
                            < cur_counts[0])
            self._phase("profile", time.perf_counter() - t)

    def _spill(self, qnext, counts, spill_next):
        """Land the drain in flight, start draining the ``counts[0]``
        rows of ``qnext`` to the host and return the spare queue to go
        on with.  On the card the copy runs on a copy stream into pinned
        memory, behind the next chunks."""
        self._resolve_spill(spill_next)
        with self._span("spill"):
            count, ev = counts[0], None
            if self.device.type == "cuda":
                if self._pinned is None:
                    self._pinned = torch.empty(
                        qnext.shape, dtype=qnext.dtype, pin_memory=True)
                cur = torch.cuda.current_stream(self.device)
                self._copy_stream.wait_stream(cur)
                with torch.cuda.stream(self._copy_stream):
                    self._pinned[:count].copy_(qnext[:count],
                                               non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(self._copy_stream)
            self._inflight.append((qnext, count, ev))
            return self._free_q.pop()

    def _spill_sync(self, qnext, counts, spill_next):
        """The ingest's drain: the ``counts[0]`` rows of ``qnext`` to the
        host pool at once."""
        with self._span("spill"):
            spill_next.append(host_rows(qnext[:counts[0]]))

    def _resolve_spill(self, spill_next):
        """Land the drain in flight in the spill pool; its queue becomes
        the spare."""
        while self._inflight:
            buf, count, ev = self._inflight.pop(0)
            with self._span("spill"):
                if ev is None:
                    spill_next.append(host_rows(buf[:count]))
                else:
                    with self._span("spill_wait"):
                        ev.synchronize()
                    spill_next.append(self._pinned[:count].numpy(),
                                      copy=True)
            self._free_q.append(buf)

    def _land_spills(self, spill_next):
        """The level's end: the drain in flight lands in the pool."""
        t_s = time.perf_counter()
        self._resolve_spill(spill_next)
        self._phase("spill", time.perf_counter() - t_s)

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
        (``_finish``).  ``EngineResult.phases`` covers the call from here
        to ``run_end``."""
        t_entry = time.perf_counter()
        if (init_states is None) == (resume is None):
            raise ValueError("need exactly one of init_states or resume")
        cfg, mt = self.config, self.metrics
        self._result = None
        self._failed = []           # attempts that ran out of memory
        self._open_residual("setup", t_entry)
        self._run_t0 = self._lvl_t0 = t_entry
        self._run_id = next_run_id()
        self._gc_watch = GcWatch(self.tracer).install()
        self._evlog = evlog = RunEventLog(self._events_path())
        self._phase_base = mt.phase_seconds()
        self._collision_base = mt.counter_value("engine/fp_collisions")
        self._hbm_watermark = 0
        self.coverage = None
        for obs in (self._profiler, self._perf):
            if obs is not None:
                obs.reset()
        if self.tracer.enabled:
            self.tracer.reset()             # one trace file, one run
            self.tracer.metadata("run_id", run_id=self._run_id)
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
        self._mem0 = device_memory_stats(self.device)
        evlog.emit(
            "run_start", engine=type(self).__name__, dims=repr(self.dims),
            batch=cfg.batch, sync_every=cfg.sync_every,
            record_trace=cfg.record_trace, resume=resume is not None,
            memory=self._mem0, trace_store=self.trace.kind,
            run_id=self._run_id, **self._run_start_fields())
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
        """The run's end (the ``finish`` phase and span), as the JAX
        engine's: the final coverage, the counterexample files, the
        statespace report, the chunk profile, the perf block, the
        capture's event, on an error the postmortem dump; then the run's
        allocator and garbage-collector counters, the span file written
        (once a run, here, also on an error) and ``run_end``; the flight
        recorder disarmed, the event log closed.  A failing render is
        reported and never hides the run's own verdict."""
        if self._residual is None or self._residual[0] != "finish":
            self._next_residual("finish")
        t_fin = self._residual[1]
        try:
            ce_path, pm_path = self._finish_outputs(err)
        finally:
            self._gc_watch.remove()
        # The graphs stay for the next run.  Every buffer a graph reads or
        # writes is the engine's (``_RUN_BUFFERS``): it lives as long as
        # the graph (``release`` and a growth drop the graphs first) and
        # is reset in place before a run (``_run_buffers``).  What a run
        # hands back is on the host (the violation and deadlock decoded,
        # the trace store filled from copies of the trace buffer), so no
        # graph can write a buffer that an earlier run's ``EngineResult``
        # or trace store still reads.
        mt, evlog, res = self.metrics, self._evlog, self._result
        failed = [f for f in self._failed if f is not res]
        if res is not None:
            res.device_seconds += sum(f.device_seconds for f in failed)
            res.graph_captures += sum(f.graph_captures for f in failed)
            res.graph_hits += sum(f.graph_hits for f in failed)
        mem = device_memory_stats(self.device)
        alloc = alloc_delta(self._mem0, mem)
        gcs = self._gc_watch.summary()
        mt.counter("alloc/retries", alloc.get("retries", 0))
        mt.counter("alloc/device_mallocs", alloc.get("device_mallocs", 0))
        mt.counter("gc/seconds", gcs["seconds"])
        if res is not None:
            res.run_id, res.alloc, res.gc = self._run_id, alloc, gcs
        tracer = self.tracer
        if tracer.enabled:
            tracer.complete("finish", t_fin, run_id=self._run_id)
            tracer.complete("run", self._run_t0, run_id=self._run_id,
                            engine=type(self).__name__,
                            stop_reason=getattr(res, "stop_reason", None),
                            invariants=list(self.inv_names),
                            graph_captures=getattr(res, "graph_captures",
                                                   None),
                            graph_hits=getattr(res, "graph_hits", None),
                            built=getattr(res, "built", None),
                            joint=getattr(res, "joint", None),
                            front_build=self.front_info().get("build"))
            tracer.write()
        end = dict(
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
            memory=mem, host_rss_peak_bytes=peak_host_rss_bytes(),
            devices_memory=all_device_memory_stats(self.device),
            run_id=self._run_id, alloc=alloc, gc=gcs,
            device_seconds=getattr(res, "device_seconds", None),
            graph_captures=getattr(res, "graph_captures", None),
            graph_hits=getattr(res, "graph_hits", None),
            built=getattr(res, "built", None),
            joint=getattr(res, "joint", None),
            front_build=self.front_info().get("build"),
            invariants=list(self.inv_names))
        # The phases end here: run_end carries them all, the failed
        # attempts' too (the registry has had them since).
        self._close_residual(time.perf_counter())
        if res is not None:
            for f in failed:
                for k, v in f.phases.items():
                    res.phases[k] = res.phases.get(k, 0.0) + v
        evlog.emit("run_end", **end, phase_seconds=phase_delta(
            mt.phase_seconds(), self._phase_base))
        _FLIGHT.set_live_evlog(None)
        _FLIGHT.disarm()        # ended or already dumped: no exit dump
        evlog.close()
        self._evlog = RunEventLog(None)

    def _finish_outputs(self, err):
        """What a run leaves besides ``run_end``: the coverage, the
        counterexample, the report, the profiler's and perf's blocks, the
        capture's event, a postmortem on an error.  Returns the
        counterexample's and the postmortem's paths (or None)."""
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
        return ce_path, pm_path

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
            failed = self._result
            steps += failed.steps
            # The failed attempt keeps its seconds (run() adds them to the
            # retry's phases); the rebuild is the retry's set-up.
            now = time.perf_counter()
            self._close_residual(now)
            self._failed.append(failed)
            self._residual = ("setup", now, 0.0)
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
        """The level loop of both engines (the module doc)."""
        dims, cfg = self.dims, self.config
        res = self._result = EngineResult(
            pipeline=self._plan_name, fused_stages=dict(self._plan),
            fused_reasons=dict(self._plan_reasons),
            device=self._device_name(),
            por_instances=(self._por_table.certified
                           if self._por_table else 0),
            family_groups=family_groups(dims))
        mt, evlog = self.metrics, self._evlog
        coverage = self.coverage = ActionCoverage(dims.family_names,
                                                  dims.family_sizes)
        resume = self._resume_source(resume)
        res.phases.update(dict.fromkeys(PHASES, 0.0))
        trace = self.trace = make_trace_store(cfg.trace_store)
        res.trace_store = trace.kind
        t_enter = time.perf_counter()
        self._start_level0()
        qcur, qnext, seen = self._run_buffers(resume is None)
        pending = SpillPool(cfg.spill_dir)      # host segments of this level
        spill_next = SpillPool(cfg.spill_dir)   # host segments of the next

        t0 = time.perf_counter()
        if resume is not None:
            seen, cur_counts, sizes = self._resume_into(resume, qcur,
                                                        pending, trace)
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
        else:
            rows_all = self._root_rows(init_states, res, trace, t_enter)
            if rows_all is None:
                return res
            t0 = time.perf_counter()
            counts, sizes, seen, spilled, t0 = self._ingest(
                rows_all, seen, qnext, pending, spill_next, res, t0)
            res.levels.append(sum(counts) + spilled)
            mt.gauge("engine/seen_capacity", self._seen_capacity(seen))
            mt.gauge("engine/seen_size", max(sizes))
            self._sample_skew(res, counts, sizes)
            self._emit_level_event(res, res.levels[-1])
            qcur, qnext = qnext, qcur
            cur_counts = counts
            pending, spill_next = spill_next, pending

        # The seen-set gauges, kept current a chunk (the progress line's
        # load and each level_stats row read them).
        mt.gauge("engine/seen_capacity", self._seen_capacity(seen))
        mt.gauge("engine/seen_size", max(sizes))
        self._batch_ema = 0.0       # measured seconds a batch
        last_progress = time.perf_counter()
        # A resumed run does not rewrite the snapshot it loaded (without
        # trace it would replace a trace-carrying file by an empty one),
        # and its interval clock starts at the restart.
        skip_ckpt_level = resume.diameter if resume is not None else -1
        last_ckpt = (time.perf_counter() if resume is not None
                     else float("-inf"))
        self._next_residual("loop")
        while (max(cur_counts) > 0 or self._host_left(pending)) \
                and res.violation is None \
                and res.stop_reason == "exhausted":
            if cfg.checkpoint_dir is not None \
                    and res.diameter % max(1, cfg.checkpoint_every) == 0 \
                    and res.diameter != skip_ckpt_level \
                    and self._any(time.perf_counter() - last_ckpt
                                  >= cfg.checkpoint_interval_seconds):
                t_h = time.perf_counter()
                self._write_checkpoint(qcur, cur_counts, pending, seen, res,
                                       trace, wall=t_h - t0)
                last_ckpt = time.perf_counter()
                self._phase("checkpoint", last_ckpt - t_h)
                evlog.emit("checkpoint", level=res.diameter,
                           distinct=res.distinct)
            if cfg.max_diameter is not None \
                    and res.diameter >= cfg.max_diameter:
                res.stop_reason = "diameter_budget"
                break
            next_counts = [0] * self.n_dev
            spilled = 0             # rows of the next level in host pools
            # Budgeted runs start each level with a one- or two-batch
            # probe and double the chunk from there (the JAX loop's ramp).
            calls_in_level = 0
            while True:
                offset = 0
                top = max(cur_counts)
                while offset < top:
                    allowed = self._CH
                    if cfg.max_seconds is not None:
                        remaining = cfg.max_seconds - (
                            time.perf_counter() - t0)
                        allowed = (max(1, min(
                            self._CH, int(remaining / (2 * self._batch_ema)),
                            2 << min(calls_in_level, 9)))
                            if self._batch_ema else 1)
                        over, allowed = self._budget(remaining <= 0, allowed)
                        if over:
                            res.stop_reason = "duration_budget"
                            break
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
                                        cur_counts)
                    t_call = time.perf_counter()
                    steps0 = res.steps
                    cap = self._xla_capture
                    with (cap.step() if cap is not None
                          else contextlib.nullcontext()):
                        rows, captured = self._chunk_call(
                            qcur, qnext, seen, cur_counts, offset,
                            next_counts, allowed, res)
                    t0 += captured
                    t_h = time.perf_counter()
                    if self._perf is not None:
                        self._perf.add_chunk(res.steps - steps0,
                                             t_h - t_call - captured)
                    res.chunks += 1
                    st = rows[0]
                    steps = st[ST_STEPS]
                    if steps:
                        per = (t_h - t_call - captured) / steps
                        self._batch_ema = (per if not self._batch_ema else
                                           max(per, 0.5 * self._batch_ema
                                               + 0.5 * per))
                    res.batches += steps
                    offset = st[ST_OFFSET]
                    next_counts = [r[ST_COUNT] for r in rows]
                    sizes = [r[ST_SEEN] for r in rows]
                    if len(rows) > 1:       # the words summed over shards
                        st = [sum(col) for col in zip(*rows)]
                    self._account_chunk(res, st, max(sizes),
                                        self._seen_capacity(seen),
                                        sum(next_counts))
                    inner = 0.0     # trace and spill, timed on their own
                    _FLIGHT.progress(
                        distinct=res.distinct, generated=res.generated,
                        diameter=res.diameter, frontier=top, offset=offset,
                        next_count=sum(next_counts), seen_size=max(sizes),
                        elapsed=round(time.perf_counter() - t0, 3))
                    if cfg.record_trace and st[ST_TCOUNT]:
                        t_t = time.perf_counter()
                        with self._span("trace_flush"):
                            self._flush_rows(rows)
                        inner = time.perf_counter() - t_t
                        self._phase("trace", inner)
                    self._check_faults(st)
                    seen, t0 = self._maybe_grow(seen, max(sizes), res, t0)
                    if max(next_counts) > self._QTH \
                            and (offset < top or self._host_left(pending)):
                        # Drain to the host (on one card behind the next
                        # chunks).
                        t_s = time.perf_counter()
                        qnext = self._spill(qnext, next_counts, spill_next)
                        spilled += sum(next_counts)
                        res.spills += 1
                        evlog.emit("spill", rows=sum(next_counts),
                                   level=res.diameter, where="chunk_loop")
                        next_counts = [0] * self.n_dev
                        self._phase("spill", time.perf_counter() - t_s)
                        inner += time.perf_counter() - t_s
                    # TLC's "queue" is the whole unexplored queue: the
                    # rest of this level and everything enqueued for the
                    # next, drains in flight too.
                    viol, dead = self._flagged(rows)
                    last_progress = self._verdict(
                        res, viol, dead,
                        lambda: (sum(max(0, c - offset) for c in cur_counts)
                                 + sum(next_counts)
                                 + self._host_rows(pending, spill_next)),
                        sum(cur_counts), max(sizes) / self._seen_capacity(
                            seen), t0, last_progress)
                    self._phase("host", time.perf_counter() - t_h - inner)
                    if res.stop_reason != "exhausted":
                        break
                if res.stop_reason != "exhausted" \
                        or not self._host_left(pending):
                    break
                t_s = time.perf_counter()
                cur_counts = self._upload(qcur, pending)
                self._phase("upload", time.perf_counter() - t_s)
            if res.stop_reason != "exhausted":
                break
            self._land_spills(spill_next)
            res.diameter += 1
            res.levels.append(sum(next_counts) + spilled)
            self._sample_skew(res, next_counts, sizes)
            self._emit_level_event(res, res.levels[-1])
            qcur, qnext = qnext, qcur
            cur_counts = next_counts
            pending, spill_next = spill_next, pending
        res.wall_seconds = time.perf_counter() - t0
        self._next_residual("finish")
        return res

    def _ingest(self, rows_all, seen, qnext, pending, spill_next, res, t0):
        """The roots in B-sized waves, round-robin across the shards (one
        shard: in order), each wave through ``_ingest_wave``, with the
        budgets, growth and spill between waves.  Returns every shard's
        next-level count and seen size, the table, the rows drained to
        the host pool and t0."""
        cfg, n, B = self.config, self.n_dev, self._B
        mt, evlog = self.metrics, self._evlog
        per = [rows_all[i::n] for i in range(n)]
        waves = max(-(-p.shape[0] // B) for p in per)
        counts, sizes, spilled = [0] * n, [0] * n, 0
        for c in range(waves):
            if c and cfg.max_seconds is not None \
                    and self._any(time.perf_counter() - t0 > cfg.max_seconds):
                res.stop_reason = "duration_budget"
                break
            if c and cfg.exit_conditions:
                # "queue" during ingest: enqueued rows, spilled rows and
                # the roots not yet ingested.
                hit = exit_condition_hit(
                    cfg.exit_conditions, res,
                    sum(counts) + self._host_rows(pending, spill_next)
                    + sum(max(0, p.shape[0] - c * B) for p in per))
                if hit:
                    res.stop_reason = hit
                    break
            t_h = time.perf_counter()
            n_new, counts, sizes, fail, bad = self._ingest_wave(
                [p[c * B:(c + 1) * B] for p in per], seen, qnext, counts)
            res.distinct += n_new
            if fail:
                raise RuntimeError("seen-set probe failure during "
                                   "ingest; raise seen_capacity")
            mt.counter("engine/distinct", n_new)
            seen, t0 = self._maybe_grow(seen, max(sizes), res, t0)
            if max(counts) > self._QTH:
                self._spill_sync(qnext, counts, spill_next)
                spilled += sum(counts)
                res.spills += 1
                evlog.emit("spill", rows=sum(counts), level=0,
                           where="ingest")
                counts = [0] * n
            self._phase("host", time.perf_counter() - t_h)
            if bad is not None:
                inv, row, fp = bad
                res.violation = Violation(self.inv_names[inv],
                                          self._decode_row(row), fp)
                res.stop_reason = "violation"
                evlog.emit("violation", invariant=res.violation.invariant,
                           fingerprint=hex(fp), level=0)
                break
        return counts, sizes, seen, spilled, t0

    # -- the loop's steps on one shard (the mesh overrides each) ---------
    #: The run's shards; the cross-process agreement of a host fact that
    #: steers the loop (one process agrees with itself).
    n_dev = 1
    _any = bool

    @staticmethod
    def _budget(over: bool, allowed: int):
        """The duration budget's stop and chunk size, agreed."""
        return over, allowed

    def _device_name(self) -> str:
        return str(self.device)

    def _resume_source(self, resume):
        """``run(resume=...)`` as this engine's ``ResumePoint``."""
        if isinstance(resume, str):
            resume = ckpt_mod.load(resume)
        if isinstance(resume, ckpt_mod.Checkpoint):
            check_resume_trace(self.config, resume)
            resume = self.resume_point(resume)
        return resume

    def _resume_into(self, resume, qcur, pending, trace):
        """A resume point's table (grown to at most half full), frontier
        (Q rows on the device, the rest in host segments) and trace.
        Returns the table, the counts and the seen sizes."""
        seen = resume.seen
        seen_size = int(seen.size[0])
        while seen_size > seen.capacity // 2:
            seen = fpset.grow(seen, 2 * seen.capacity)
        seen = self._keep_seen(seen)
        Q, fr = self._Q, resume.frontier
        rest = fr[Q:].cpu().numpy()     # one host copy, then pieces
        for i in range(0, rest.shape[0], Q):
            pending.append(rest[i:i + Q])
        fr = fr[:Q]
        qcur[:fr.shape[0]] = fr.to(self.device)
        if self.config.record_trace and resume.trace is not None:
            trace.add_batch(*resume.trace)
            trace.roots.update(resume.roots)
        return seen, [fr.shape[0]], [seen_size]

    def _ingest_wave(self, parts, seen, qnext, counts):
        """One wave of roots (``parts``: a shard's rows each) fingerprinted,
        inserted and the novel constraint-passing ones enqueued.  Returns
        the new keys, the counts, the seen sizes, whether a probe failed
        and the first new violating root as (invariant index, row,
        fingerprint) or None."""
        B, dev, part = self._B, self.device, parts[0]
        rows = torch.zeros((B, self._sw), dtype=ROW_DTYPE, device=dev)
        rows[:part.shape[0]] = part
        valid = torch.arange(B, device=dev) < part.shape[0]
        with self._span("ingest"):
            cands = unflatten_state(rows, self.dims)
            fph, fpl = self._fingerprint(cands)
            new, fail = insert(seen, pack(fph, fpl), valid)
            enq = new
            if self._constraint is not None:
                enq = new & self._constraint(cands)
            idx = enq.nonzero().squeeze(1)
            count = counts[0] + idx.shape[0]
            qnext[counts[0]:count] = rows[idx]
            n_new, fail = int(new.sum()), bool(fail)
        with self._span("trace_flush"):
            self._record(new, fph, fpl)
        bad = None
        if self._inv_id is not None:
            inv = self._inv_id(cands)
            viol = new & (inv >= 0)
            if bool(viol.any()):
                v = int(viol.to(torch.int32).argmax())
                bad = (int(inv[v]), rows[v],
                       (int(fph[v]) << 32) | int(fpl[v]))
        return n_new, [count], [int(seen.size[0])], fail, bad

    def _seen_capacity(self, seen) -> int:
        return seen.capacity

    def _chunk_call(self, qcur, qnext, seen, cur_counts, offset: int,
                    next_counts, allowed: int, res):
        """``_run_chunk``: its state words as the rows, one a shard."""
        st, captured = self._run_chunk(qcur, qnext, seen, cur_counts[0],
                                       offset, next_counts[0], allowed, res)
        return [st], captured

    def _flush_rows(self, rows):
        self._flush_trace(self._tbuf, rows[0][ST_TCOUNT])

    def _flagged(self, rows):
        """The violation ``(invariant index, ChunkState)`` and the
        deadlocked ``ChunkState`` the chunk stopped on, else None."""
        st, cs = rows[0], self._cs
        return ((st[ST_VINV], cs) if st[ST_VIOL] else None,
                cs if st[ST_DEAD] else None)

    def _host_left(self, pending) -> bool:
        """Whether host segments of this level wait (on any process)."""
        return bool(pending)

    def _host_rows(self, pending, spill_next) -> int:
        """The queue's rows on the host: both pools and drains in
        flight."""
        return (pending.total_rows() + spill_next.total_rows()
                + sum(c for _b, c, _e in self._inflight))

    def _upload(self, qcur, pending):
        """The next host segment to the device; returns the counts."""
        with self._span("upload"):
            seg = np.require(pending.pop(0), requirements=["C", "W"])
            qcur[:len(seg)] = torch.from_numpy(seg).to(self.device)
        return [len(seg)]

    def _sample_skew(self, res, counts, sizes) -> None:
        """The mesh's shard balance at a level boundary; one device has
        none."""

    def _account_chunk(self, res, st, seen_size: int, capacity: int,
                       next_count: int):
        """A chunk's counters (``ST_*`` words, summed over shards on the
        mesh) into the result, the registry and the coverage."""
        S, F = chunk_mod.N_SCALARS, len(self.dims.family_sizes)
        mt = self.metrics
        res.distinct += st[ST_NEW]
        res.generated += st[ST_GEN]
        built = st[chunk_mod.built_word(F)]
        joint = st[chunk_mod.built_word(F) + 1]
        res.built += built
        res.joint += joint
        mt.counter("engine/distinct", st[ST_NEW])
        mt.counter("engine/generated", st[ST_GEN])
        mt.counter("engine/built", built)
        mt.counter("engine/joint", joint)
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
                             and time.perf_counter() - last_progress
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
            last_progress = time.perf_counter()
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
                res.wall_seconds = time.perf_counter() - t_enter
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
        outputs on every lane of the grid (on v1: the full expansion,
        hashed in full)."""
        G, dev = self._G, self.device
        st = stack_states([encode_state(state, self.dims)], dev)
        if self._expand is not None:
            cands, en, _ovf = self._expand(st)
            succ = unflatten_state(cands.rows, self.dims)
            kh, kl = self._fingerprint(succ)
            fps = (kh.cpu().numpy().astype(np.uint64) << np.uint64(32)) \
                | kl.cpu().numpy().astype(np.uint64)
            return en[0].cpu().numpy(), fps, succ
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
