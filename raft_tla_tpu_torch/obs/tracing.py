"""Span tracing: Chrome trace-event JSON for Perfetto or chrome://tracing.

The JAX package's ``obs/tracing.py``, kept as the port's own copy.  A
``SpanTracer`` records nested spans (``with tracer.span("chunk"): ...``
blocks, or ``complete(name, start)`` for loop-shaped scopes) and writes
them as a Chrome trace-event array, so ``check --trace-out run.json``
opens in Perfetto with per-thread nesting intact.  ``SpanTracer(None)``
discards, so call sites never branch.

Wiring, as in the JAX package: attached to a ``MetricsRegistry``
(``registry.tracer``) it mirrors every ``phase_timer`` block into a
span; the engines add a ``run`` span, one ``level`` span a BFS level,
and the spans of their loop under the JAX engine's names (``root_check``,
``warmup``, ``ingest``, ``chunk``, ``stats_fetch``, ``trace_flush``,
``spill``, ``upload``, ``checkpoint``, ``profile``; ``swarm_chunk`` /
``swarm_fetch``; ``sim_chunk`` / ``sim_fetch``).  The single-device
engine adds ``setup``, ``finish``, one ``capture`` a CUDA graph, a
``gc`` span a Python collection of 1 ms or more and ``spill_wait``, and
writes the file once, at the run's end (an atomic rewrite).

Format: a JSON array of events; ``ph: "X"`` complete events carry ``ts``
and ``dur`` in microseconds, ``ph: "i"`` instants ``s: "t"``, ``ph:
"M"`` metadata names the process, the threads, the clock and the run.
``ts`` is on the Unix-epoch clock that ``torch.profiler`` stamps its
events with (``CLOCK``): one ``(time.perf_counter_ns(), time.time_ns())``
anchor taken at ``reset()``, then ``ts = anchor_unix + (perf -
anchor_perf)``, so time is monotonic within a file and a span lines up
with the device trace of the same process without a guessed offset.
Each file also carries ``trace_start_unix`` for merging files of several
processes.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

#: The clock of ``ts``, named in every file's ``clock`` metadata event.
CLOCK = "unix_epoch_us"


class SpanTracer:
    """Thread-safe span recorder; ``SpanTracer(None)`` discards.

    ``path`` is where :meth:`write` serializes to by default (the
    ``--trace-out`` file); recording is in-memory, flushed by the
    engines at run end (atomic rewrite; the single-device engine's
    ``_finish`` also runs on an error), so the hot loop never blocks on
    disk.
    """

    def __init__(self, path: Optional[str] = None,
                 process_name: str = "raft_tla_tpu_torch"):
        self.path = path
        self._process_name = process_name
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self.reset()

    def reset(self) -> None:
        """Drop everything recorded and restart the clock — one trace
        file describes ONE run, so warm/reused engines call this at
        every run start (at ``run``) instead of appending a
        second ``run`` span to the first run's events.  The supervisor's
        own tracer is deliberately never reset: its attempt/restart
        timeline spans the whole supervision episode."""
        with self._lock:
            self._events = []
            self._named_tids = set()
        # The anchor: perf_counter keeps time monotonic, the Unix clock
        # puts it on the profiler's.
        perf_ns, unix_ns = time.perf_counter_ns(), time.time_ns()
        self._shift_us = (unix_ns - perf_ns) / 1e3
        if self.path is not None:
            # Process metadata + the epoch anchor for cross-process merge.
            self._append({"name": "process_name", "ph": "M",
                          "pid": self._pid, "tid": 0,
                          "args": {"name": self._process_name}})
            self._append({"name": "trace_start_unix", "ph": "M",
                          "pid": self._pid, "tid": 0,
                          "args": {"unix_seconds": round(unix_ns / 1e9, 6)}})
            self._append({"name": "clock", "ph": "M", "pid": self._pid,
                          "tid": 0, "args": {
                              "name": CLOCK, "anchor_unix_ns": unix_ns,
                              "anchor_perf_counter_ns": perf_ns}})

    def metadata(self, name: str, **args) -> None:
        """A process-scope metadata event (``ph: "M"``), e.g. the run's
        id."""
        if self.path is None:
            return
        self._append({"name": name, "ph": "M", "pid": self._pid, "tid": 0,
                      "args": args})

    def unix_us(self, perf_counter: float) -> float:
        """A ``time.perf_counter()`` stamp on the file's clock (``ts``)."""
        return perf_counter * 1e6 + self._shift_us

    @property
    def enabled(self) -> bool:
        return self.path is not None

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # -- recording -----------------------------------------------------
    def _append(self, rec: dict) -> None:
        with self._lock:
            self._events.append(rec)

    def _tid(self) -> int:
        tid = threading.get_ident()
        if tid not in self._named_tids:
            self._named_tids.add(tid)
            self._append({"name": "thread_name", "ph": "M",
                          "pid": self._pid, "tid": tid,
                          "args": {"name": threading.current_thread().name}})
        return tid

    def _now_us(self) -> float:
        return self.unix_us(time.perf_counter())

    @contextmanager
    def span(self, name: str, **args):
        """Record the block as one complete (``ph: "X"``) event.  Nesting
        is implicit: Chrome/Perfetto stack same-thread spans by ts/dur."""
        if self.path is None:
            yield
            return
        start = time.perf_counter()
        try:
            yield
        finally:
            self.complete(name, start, **args)

    def complete(self, name: str, start_perf_counter: float, **args) -> None:
        """Record a span from an earlier ``time.perf_counter()`` stamp to
        now — the loop-shaped-scope form (level boundaries, supervisor
        attempts), where a ``with`` block can't bracket the region."""
        if self.path is None:
            return
        self.interval(name, start_perf_counter, time.perf_counter(),
                      **args)

    def interval(self, name: str, start_perf_counter: float,
                 end_perf_counter: float, **args) -> None:
        """Record a span between two ``time.perf_counter()`` stamps (a
        span measured elsewhere, such as a garbage collection's).  Its end
        is the end stamp on the file's clock, ``ts + dur`` exactly, so a
        span that ends at a stamp never passes one that starts there."""
        if self.path is None:
            return
        ts = round(self.unix_us(start_perf_counter), 3)
        end = round(self.unix_us(end_perf_counter), 3)
        rec = {"name": name, "ph": "X", "pid": self._pid,
               "tid": self._tid(), "ts": ts, "dur": end - ts}
        if args:
            rec["args"] = args
        self._append(rec)

    def instant(self, name: str, **args) -> None:
        """Point-in-time marker (``ph: "i"``, thread scope)."""
        if self.path is None:
            return
        rec = {"name": name, "ph": "i", "s": "t", "pid": self._pid,
               "tid": self._tid(), "ts": round(self._now_us(), 3)}
        if args:
            rec["args"] = args
        self._append(rec)

    # -- serialization -------------------------------------------------
    def write(self, path: Optional[str] = None) -> Optional[str]:
        """Serialize everything recorded so far as one Chrome trace JSON
        array (atomic tmp + rename; repeat calls rewrite — the engines
        call this at every run end, so the newest run always lands even
        if a later one crashes mid-write).  Returns the path written, or
        None when the tracer is disabled."""
        path = path or self.path
        if path is None:
            return None
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with self._lock:
            events = list(self._events)
        tmp = f"{path}.tmp{self._pid}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(events, f, default=str)
            f.write("\n")
        os.replace(tmp, path)
        return path


def validate_chrome_trace(path: str) -> list:
    """Validate a ``--trace-out`` file: it must parse as a JSON *array*
    of event objects each carrying ``name``/``ph`` (and ``ts`` for
    non-metadata phases) — the shape Perfetto accepts.  Returns the
    events; raises ``FileNotFoundError``/``ValueError`` otherwise.  The
    bench/CI tooling calls this next to ``validate_run_events`` so a
    trace regression fails as loudly as an event-log one."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"trace file missing: {path}")
    with open(path, encoding="utf-8") as f:
        try:
            events = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}: not valid JSON ({e})")
    if not isinstance(events, list):
        raise ValueError(
            f"{path}: Chrome trace must be a JSON array of events, got "
            f"{type(events).__name__} (the object-with-traceEvents form "
            f"is not what this tracer emits)")
    for i, rec in enumerate(events):
        if not isinstance(rec, dict) or "name" not in rec \
                or "ph" not in rec:
            raise ValueError(
                f"{path}: event {i} is not an object with 'name'/'ph': "
                f"{str(rec)[:120]}")
        if rec["ph"] != "M" and "ts" not in rec:
            raise ValueError(
                f"{path}: event {i} ({rec['name']!r}, ph={rec['ph']!r}) "
                f"missing 'ts'")
    return events
