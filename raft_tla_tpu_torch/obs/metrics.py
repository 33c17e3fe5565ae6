"""Metrics registry: counters, gauges, histograms and phase timing.

The JAX package's ``obs/metrics.py``, kept as the port's own copy: one
registry an engine writes its live counters into (``engine/distinct``,
``engine/seen_size``, ``coverage/<family>/generated``,
``statespace/*``, ...), read by ``snapshot()`` for ``--metrics-out``.
Thread-safe (a few dict operations under one lock) and free of any
device code.  Phase seconds live in histograms named ``phase/<name>``
whose ``total`` is the accumulated seconds; the engines observe into them
the same seconds they add to ``EngineResult.phases`` (one clock), and
``phase_seconds()`` projects that view for run events.  The JAX
registry's span-tracer mirror waits for ``obs/tracing.py`` (ROADMAP A6b).
"""

from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

# Histogram bucket upper bounds: geometric decades with a 1-2-5 ladder,
# 1 us .. 100 s — wide enough for both kernel dispatches and whole
# checkpoint writes.  Values are generic (a histogram may observe bytes
# or rows too); the ladder just has to be monotone.
_DEFAULT_BOUNDS = tuple(
    m * 10.0 ** e for e in range(-6, 3) for m in (1.0, 2.0, 5.0))

PHASE_PREFIX = "phase/"


class Histogram:
    """Lock-free value container; the registry serializes access."""

    __slots__ = ("count", "total", "min", "max", "bounds", "buckets")

    def __init__(self, bounds=_DEFAULT_BOUNDS):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.bounds = bounds
        self.buckets = [0] * (len(bounds) + 1)   # +1 overflow bucket

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        lo, hi = 0, len(self.bounds)
        while lo < hi:                    # first bound >= value
            mid = (lo + hi) // 2
            if self.bounds[mid] < value:
                lo = mid + 1
            else:
                hi = mid
        self.buckets[lo] += 1

    def summary(self) -> dict:
        out = {"count": self.count, "total": self.total}
        if self.count:
            out["min"] = self.min
            out["max"] = self.max
            out["mean"] = self.total / self.count
            # Only the occupied buckets, keyed by upper bound ("+inf" for
            # the overflow bucket) — compact in JSON snapshots.
            out["buckets"] = {
                ("+inf" if i == len(self.bounds)
                 else f"{self.bounds[i]:g}"): c
                for i, c in enumerate(self.buckets) if c}
        return out


class MetricsRegistry:
    """Named counters (monotone), gauges (last value wins), histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- writers -------------------------------------------------------
    def counter(self, name: str, inc: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + inc

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            h.observe(value)

    @contextmanager
    def phase_timer(self, name: str):
        """Accumulate wall seconds into the ``phase/<name>`` histogram.
        Phases are the host-side stages of an engine loop (chunk dispatch,
        stats fetch, spill drain, checkpoint, ...): non-overlapping by
        construction at the call sites, so their totals partition the
        loop's wall time."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(PHASE_PREFIX + name, time.perf_counter() - t0)

    # -- readers -------------------------------------------------------
    def counter_value(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def gauge_value(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def phase_seconds(self) -> Dict[str, float]:
        """{phase name: accumulated seconds} — the per-phase breakdown
        run events and bench JSON embed."""
        with self._lock:
            return {name[len(PHASE_PREFIX):]: h.total
                    for name, h in self._histograms.items()
                    if name.startswith(PHASE_PREFIX)}

    def snapshot(self) -> dict:
        """One JSON-ready dict of everything: what ``--metrics-out``
        writes."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {n: h.summary()
                               for n, h in self._histograms.items()},
            }


def phase_delta(now: Dict[str, float],
                base: Optional[Dict[str, float]]) -> Dict[str, float]:
    """Per-phase seconds accumulated since ``base`` (an earlier
    ``phase_seconds()`` snapshot) — used to scope phase breakdowns to one
    run or one BFS level on a registry that outlives both."""
    if not base:
        return dict(now)
    return {k: v - base.get(k, 0.0) for k, v in now.items()
            if v - base.get(k, 0.0) > 0.0}
