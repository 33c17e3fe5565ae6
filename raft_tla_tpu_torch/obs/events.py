"""Structured run events: one JSON line per engine lifecycle event.

The JAX package's ``obs/events.py``, kept as the port's own copy.  The
engines append one JSON object a line for ``run_start``,
``level_complete``, ``coverage``, ``statespace``, ``fpset_resize``,
``spill``, ``checkpoint``, ``degraded``, ``violation``, ``deadlock`` and
``run_end``, with the JAX engine's names and fields.  Every event carries
``ts`` (epoch seconds) and ``elapsed_seconds`` (since the log was
opened); level and end events add the per-phase seconds and the card's
memory (``device_memory_stats``: the CUDA caching allocator's counters
under the JAX field names, read on the host without waiting for the
device).  ``validate_run_events`` is the check a consumer runs on a
file.

Placement: ``EngineConfig.events_out`` names the file; unset, it lands
as ``events.jsonl`` next to the checkpoint directory, and with neither
there is no file.  ``RunEventLog(None)`` discards every event, so the
engines emit unconditionally.  The JAX log also mirrors each event into
the flight recorder's ring; that waits for ``obs/flight.py`` (ROADMAP
A6b).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

#: Event types a complete, healthy run always contains.
REQUIRED_EVENTS = ("run_start", "run_end")

#: Every event type the engines/tooling emit (documentation + the
#: validator's schema table).  Unknown types still validate — forward
#: compatibility — but known STRUCTURED types must carry their payload
#: field, so a half-written profiler/coverage emitter fails the
#: validator instead of shipping empty records.
KNOWN_EVENTS = (
    "run_start", "level_complete", "fpset_resize", "spill", "checkpoint",
    "violation", "deadlock", "run_end", "restart", "supervised_done",
    "supervise_giveup", "degraded", "analysis",
    # Deep-profiling layer (obs/profile.py, obs/coverage.py):
    "chunk_profile",    # per-stage chunk timings; payload: "stages"
    "coverage",         # TLC-style per-action counters; payload: "actions"
    # Flight-recorder / live-introspection layer (obs/flight.py,
    # obs/expose.py):
    "postmortem",       # a black-box dump was written; payload: "dump"
    "watch_attach",     # a live watcher attached; payload: "client"
    "xla_profile",      # device-profiler capture window; payload: "capture"
    # Semantic-observability layer (obs/report.py): the TLC-parity
    # statespace report, one per completed run.  ``run_end`` also gains
    # ``counterexample_path`` when a traced violation was rendered
    # (engine/explain.py).
    "statespace",       # TLC-parity run report; payload: "report"
    # Performance observatory (obs/perf.py, obs/roofline.py): launch
    # accounting + static roofline + fusion-advisor verdict, one per
    # completed --perf run; and the mesh's per-shard balance warning
    # (parallel/mesh.py skew telemetry).
    "perf",             # launch/roofline/advisor block; payload: "perf"
    "skew",             # shard imbalance warning; payload: "balance"
    # Swarm tier (engine/swarm.py): periodic walker progress.  Swarm
    # runs also attach the same ``swarm`` payload object to their
    # ``run_end`` (exhaustive run_ends carry none, so only the
    # progress event gets schema-table enforcement).
    "swarm_progress",   # walker-fleet progress; payload: "swarm"
    # Hunt observatory (obs/hunt.py): the run-end saturation /
    # walk-analytics report for swarm runs — the probabilistic sibling
    # of ``statespace``.
    "hunt",             # swarm coverage report; payload: "hunt"
)

#: Structured payload field each new event type must carry.
_EVENT_PAYLOAD_FIELDS = {"chunk_profile": "stages", "coverage": "actions",
                         "postmortem": "dump", "watch_attach": "client",
                         "xla_profile": "capture", "statespace": "report",
                         "perf": "perf", "skew": "balance",
                         "swarm_progress": "swarm", "hunt": "hunt"}


def device_memory_stats(device=None) -> dict:
    """The card's memory under the JAX probe's names: ``bytes_in_use``
    (the caching allocator's allocated bytes), ``peak_bytes_in_use``
    (their peak, ``torch.cuda.max_memory_allocated``) and ``bytes_limit``
    (the card's memory).  One read of the allocator's counters on the
    host (``memory_stats_as_nested_dict``; the flat ``memory_stats`` costs
    a sort of every counter), no wait for the device.  ``{}`` for a CPU
    device, or where no card is present, as the JAX probe gives for a
    device that reports nothing."""
    try:
        import torch
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return {}
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        allocated = torch.cuda.memory_stats_as_nested_dict(idx)[
            "allocated_bytes"]["all"]
        return {"bytes_in_use": int(allocated["current"]),
                "peak_bytes_in_use": int(allocated["peak"]),
                "bytes_limit": int(
                    torch.cuda.get_device_properties(idx).total_memory)}
    except Exception:
        return {}


def all_device_memory_stats(device=None) -> list:
    """One probe a visible card, in order, for a run on the card; a run
    on the CPU gives ``[{}]`` (one device reporting nothing), as the JAX
    probe does on its CPU platform."""
    try:
        import torch
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return [{}]
        return [device_memory_stats(torch.device("cuda", i))
                for i in range(torch.cuda.device_count())]
    except Exception:
        return [{}]


def peak_host_rss_bytes():
    """Peak resident set size of this process in bytes (ru_maxrss is KB
    on Linux, bytes on macOS — normalize to bytes), or None where the
    resource module is unavailable (non-POSIX)."""
    try:
        import resource
        import sys
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(peak) if sys.platform == "darwin" else int(peak) * 1024
    except Exception:
        return None


def events_path(events_out: Optional[str], checkpoint_dir: Optional[str],
                process_index: int = 0,
                process_count: int = 1) -> Optional[str]:
    """Resolve the event-log path for one controller.  ``events_out``
    wins; otherwise the file lands next to the checkpoints; None/None
    disables.  Under a process group each controller writes its own
    piece file (suffix before the extension), mirroring checkpoint
    pieces — merge for dashboards by concatenation, order by ``ts``."""
    path = events_out
    if path is None and checkpoint_dir is not None:
        path = os.path.join(checkpoint_dir, "events.jsonl")
    if path is None or process_count <= 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.p{process_index}of{process_count}{ext or '.jsonl'}"


class RunEventLog:
    """Append-only JSONL event writer; ``RunEventLog(None)`` discards
    every event.  Thread-safe: one line is written whole under a lock."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._f = None
        self._t0 = time.time()
        self._lock = threading.Lock()
        if path is not None:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            self._f = open(path, "a", encoding="utf-8")

    @property
    def enabled(self) -> bool:
        return self._f is not None

    def elapsed(self) -> float:
        """Seconds since the log was opened (the run's wall clock, which
        unlike the engines' duration clock never moves back for off-clock
        stalls)."""
        return time.time() - self._t0

    def emit(self, event: str, **fields) -> None:
        if self._f is None:
            return
        now = time.time()
        rec = {"event": event, "ts": round(now, 6),
               "elapsed_seconds": round(now - self._t0, 6)}
        rec.update(fields)
        # One line an event, flushed at once: a crashed run's log stays
        # readable up to the crash.
        with self._lock:
            f = self._f
            if f is None:
                return
            f.write(json.dumps(rec, default=str) + "\n")
            f.flush()

    def close(self) -> None:
        with self._lock:
            f, self._f = self._f, None
        if f is not None:
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def validate_and_cleanup(events_file: str, scratch_dir: Optional[str],
                         required=REQUIRED_EVENTS) -> int:
    """Bench-harness gate: validate a run's event log, removing
    ``scratch_dir`` whether validation succeeds or raises.  Returns the
    event count; raises like :func:`validate_run_events`."""
    import shutil
    try:
        return len(validate_run_events(events_file, required=required))
    finally:
        if scratch_dir is not None:
            shutil.rmtree(scratch_dir, ignore_errors=True)


def validate_run_events(path: str,
                        required=REQUIRED_EVENTS) -> list:
    """Parse a run event log and verify it is healthy: the file exists,
    every line is a JSON object with ``event`` and ``ts``, and every
    ``required`` event type appears.  Returns the parsed events; raises
    ``FileNotFoundError``/``ValueError`` otherwise."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"run event log missing: {path}")
    events = []
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{ln}: malformed event line ({e})")
            if not isinstance(rec, dict) or "event" not in rec \
                    or "ts" not in rec:
                raise ValueError(
                    f"{path}:{ln}: event record missing 'event'/'ts': "
                    f"{line[:120]}")
            payload = _EVENT_PAYLOAD_FIELDS.get(rec["event"])
            if payload is not None and not isinstance(
                    rec.get(payload), dict):
                raise ValueError(
                    f"{path}:{ln}: {rec['event']!r} event missing its "
                    f"{payload!r} payload object: {line[:120]}")
            events.append(rec)
    have = {e["event"] for e in events}
    missing = [r for r in required if r not in have]
    if missing:
        raise ValueError(
            f"{path}: incomplete run event log — missing {missing} "
            f"(saw {sorted(have)})")
    return events
