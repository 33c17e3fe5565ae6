"""The hunt observatory: saturation estimates and walk analytics of the
swarm tier.

The JAX package's ``obs/hunt.py``, kept as the port's own copy.  Every
ring-accepted visit of a swarm run is one observation of one species (a
64-bit fingerprint); the chunk classifies each on the device against two
persistent Bloom filters (``ops/walk_kernels.py bloom_*``) as *fresh*
(first observation) or *promote* (the second), so the host reads a few
counters a chunk.  From them:

- the Good-Turing unseen mass ``n1 / N`` (``n1 = fresh - promote``
  singletons over ``N`` accepted visits) and its complement, the
  saturation;
- the per-step novelty series (bounded, pair-folded), the final-depth
  histogram of restarted traces, the restart census (dead end, overflow,
  constraint, ring revisit, depth bound) and each action family's
  efficacy;
- the filter's load (its collision bias).

All of it is host arithmetic over counters already read: the hunt never
changes a walk (the swarm's results are bit-identical with it on or
off).  Surfaces: the ``hunt`` run event, ``SwarmResult.report["hunt"]``,
``hunt/*`` gauges, the flight ring's ``hunt`` records and the history
ledger's swarm entries.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

#: Restart-reason keys, in the engine's decision order (the first rule
#: that fires owns the restart).
RESTART_REASONS = ("deadend", "overflow", "constraint", "revisit",
                   "depth_bound")


def good_turing(fresh: int, promote: int, accepts: int) -> dict:
    """The Good-Turing block from the three device tallies.

    ``fresh`` species were observed at least once, of which ``promote``
    reached a second observation — so ``n1 = fresh - promote`` are
    singletons.  Turing's estimator: ``unseen_mass = n1 / N`` is the
    probability the next observation is a new species;
    ``saturation = 1 - unseen_mass`` is the sample coverage.  An empty
    sample is reported as fully unsaturated (the honest prior for a
    hunt that has seen nothing)."""
    n1 = max(0, int(fresh) - int(promote))
    n = int(accepts)
    unseen = (n1 / n) if n else 1.0
    return {
        "observations": n,
        "distinct_observed": int(fresh),
        "singletons": n1,
        "doubletons_plus": int(promote),
        "unseen_mass": round(unseen, 6),
        "saturation": round(1.0 - unseen, 6),
    }


class NoveltySeries:
    """Bounded per-step novelty curve: ``(step_end, novel, accepts)``
    buckets, pair-folded whenever the point budget is exceeded — a
    million-step hunt still renders as <= ``max_points`` buckets with
    exact totals (folding adds adjacent buckets, it never drops one)."""

    def __init__(self, max_points: int = 2048):
        if max_points < 2:
            raise ValueError(f"max_points must be >= 2, got {max_points}")
        self.max_points = max_points
        self._steps: List[int] = []     # bucket-end global step (exclusive)
        self._novel: List[int] = []
        self._accepts: List[int] = []

    def extend(self, k_end: int, novel: Sequence[int],
               accepts: Sequence[int]) -> None:
        """Append per-step counts for global steps ``[k_end - len,
        k_end)`` (one entry per lockstep step, summed over walks)."""
        n = len(novel)
        for i in range(n):
            self._steps.append(int(k_end) - n + i + 1)
            self._novel.append(int(novel[i]))
            self._accepts.append(int(accepts[i]))
        while len(self._steps) > self.max_points:
            self._fold()

    def _fold(self) -> None:
        self._steps = self._steps[1::2]
        self._novel = [a + b for a, b in
                       zip(self._novel[::2], self._novel[1::2])]
        self._accepts = [a + b for a, b in
                         zip(self._accepts[::2], self._accepts[1::2])]

    def points(self) -> List[List[int]]:
        """``[[step_end, novel, accepts], ...]`` — the raw buckets."""
        return [[s, f, a] for s, f, a in
                zip(self._steps, self._novel, self._accepts)]

    def rates(self, buckets: int = 0) -> List[List[float]]:
        """``[[step_end, novel_rate], ...]`` with ``novel_rate`` the
        fresh fraction of accepted visits per bucket; optionally
        re-folded down to <= ``buckets`` points (drift gating wants a
        fixed-width curve regardless of run length)."""
        steps, novel, acc = (list(self._steps), list(self._novel),
                             list(self._accepts))
        if buckets:
            while len(steps) > buckets:
                steps = steps[1::2]
                novel = [a + b for a, b in zip(novel[::2], novel[1::2])]
                acc = [a + b for a, b in zip(acc[::2], acc[1::2])]
        return [[s, round(f / a, 6) if a else 0.0]
                for s, f, a in zip(steps, novel, acc)]


class HuntAccumulator:
    """Host-side fold of the per-chunk device tallies — one instance
    per swarm run, fed once per (chunk, slice) dispatch.  Pure
    arithmetic; owns no device state."""

    def __init__(self, family_names: Sequence[str], max_depth: int,
                 bloom_cells: int = 0, max_points: int = 2048):
        self.family_names = list(family_names)
        self.max_depth = int(max_depth)
        self.bloom_cells = int(bloom_cells)
        self.series = NoveltySeries(max_points)
        self.accepts = 0
        self.fresh = 0
        self.promote = 0
        self.steps = 0                  # lockstep walk-steps observed
        self.reasons = {k: 0 for k in RESTART_REASONS}
        self.depth_hist = [0] * (self.max_depth + 1)
        f = len(self.family_names)
        self.fam_chosen = [0] * f
        self.fam_accept = [0] * f
        self.fam_fresh = [0] * f
        #: Final Bloom-filter load (occupied cell fraction), set once at
        #: run end from the fetched filter — the estimator-health knob.
        self.bloom_load: Optional[float] = None

    def add_slice(self, fresh: int, promote: int, reasons: Sequence[int],
                  depth_hist: Sequence[int], fam_chosen: Sequence[int],
                  fam_accept: Sequence[int],
                  fam_fresh: Sequence[int]) -> None:
        """Fold one dispatch's scalar/vector tallies (``reasons`` in
        :data:`RESTART_REASONS` order)."""
        self.fresh += int(fresh)
        self.promote += int(promote)
        for k, v in zip(RESTART_REASONS, reasons):
            self.reasons[k] += int(v)
        for i, v in enumerate(depth_hist):
            if i < len(self.depth_hist):
                self.depth_hist[i] += int(v)
        for i, v in enumerate(fam_chosen):
            self.fam_chosen[i] += int(v)
        for i, v in enumerate(fam_accept):
            self.fam_accept[i] += int(v)
        for i, v in enumerate(fam_fresh):
            self.fam_fresh[i] += int(v)

    def add_steps(self, k_end: int, walk_steps: int,
                  novel_per_step: Sequence[int],
                  accept_per_step: Sequence[int]) -> None:
        """Fold one chunk round's per-step series (summed over slices):
        ``walk_steps`` is walks x steps this round; the series arrays
        cover global steps ``[k_end - len, k_end)``."""
        self.steps += int(walk_steps)
        self.accepts += sum(int(a) for a in accept_per_step)
        self.series.extend(k_end, novel_per_step, accept_per_step)

    # -- projections ---------------------------------------------------
    def estimate(self) -> dict:
        return good_turing(self.fresh, self.promote, self.accepts)

    def snapshot(self) -> dict:
        """The compact live block riding ``swarm_progress`` payloads,
        flight-recorder ``hunt`` records, and the ``hunt/*`` gauges."""
        est = self.estimate()
        recent = self.series.rates(buckets=8)
        return {
            "saturation": est["saturation"],
            "unseen_mass": est["unseen_mass"],
            "distinct_observed": est["distinct_observed"],
            "singletons": est["singletons"],
            "observations": est["observations"],
            "novel_rate_recent": recent[-1][1] if recent else 0.0,
            "revisit_rate": (round(self.reasons["revisit"] / self.steps, 6)
                             if self.steps else 0.0),
        }


def build_report(acc: HuntAccumulator,
                 violation_at_seconds: Optional[float] = None,
                 wall_seconds: float = 0.0) -> dict:
    """Assemble the hunt report dict — the swarm sibling of
    obs/report.py's statespace report, from one finished run's
    accumulator."""
    est = acc.estimate()
    total_restarts = sum(acc.reasons.values())
    # Depth distribution of completed traces, with summary quantiles.
    hist = list(acc.depth_hist)
    n_traces = sum(hist)
    mean_depth = (sum(i * c for i, c in enumerate(hist)) / n_traces
                  if n_traces else 0.0)
    p50 = p90 = 0
    if n_traces:
        cum = 0
        for i, c in enumerate(hist):
            cum += c
            if not p50 and cum * 2 >= n_traces:
                p50 = i
            if cum * 10 >= n_traces * 9:
                p90 = i
                break
    families = []
    for i, name in enumerate(acc.family_names):
        chosen = acc.fam_chosen[i] if i < len(acc.fam_chosen) else 0
        accepted = acc.fam_accept[i] if i < len(acc.fam_accept) else 0
        fresh = acc.fam_fresh[i] if i < len(acc.fam_fresh) else 0
        families.append({
            "family": name,
            "chosen": int(chosen),
            "accepted": int(accepted),
            "fresh": int(fresh),
            "fresh_rate": round(fresh / chosen, 6) if chosen else 0.0,
        })
    bloom: dict = {}
    if acc.bloom_cells:
        bloom["cells"] = acc.bloom_cells
        if acc.bloom_load is not None:
            bloom["load"] = round(acc.bloom_load, 6)
            # Two-probe filter: collision (false-positive) probability
            # ~= load^2 — the fraction of genuinely-fresh observations
            # the estimator may have misfiled as repeats.
            bloom["collision_probability"] = round(acc.bloom_load ** 2, 8)
    return {
        "saturation": est["saturation"],
        "unseen_mass": est["unseen_mass"],
        "distinct_observed": est["distinct_observed"],
        "singletons": est["singletons"],
        "doubletons_plus": est["doubletons_plus"],
        "observations": est["observations"],
        "steps": acc.steps,
        "novel_rate": (round(est["distinct_observed"] / est["observations"],
                             6) if est["observations"] else 0.0),
        "revisit_rate": (round(acc.reasons["revisit"] / acc.steps, 6)
                         if acc.steps else 0.0),
        "novelty_curve": acc.series.rates(),
        "depth": {"histogram": hist, "traces": n_traces,
                  "mean": round(mean_depth, 4), "p50": p50, "p90": p90},
        "restarts": {"total": total_restarts, **dict(acc.reasons)},
        "families": families,
        "bloom": bloom,
        "time_to_violation_seconds": violation_at_seconds,
        "wall_seconds": round(float(wall_seconds), 6),
    }


def feed_metrics(report: dict, metrics) -> None:
    """Mirror the report's scalar spine into ``hunt/*`` gauges (the
    Prometheus names: ``raft_hunt_saturation`` etc. via obs/expose.py's
    prefix rule) — gauges, idempotent across re-reports."""
    metrics.gauge("hunt/saturation", report["saturation"])
    metrics.gauge("hunt/unseen_mass", report["unseen_mass"])
    metrics.gauge("hunt/distinct_observed", report["distinct_observed"])
    metrics.gauge("hunt/singletons", report["singletons"])
    metrics.gauge("hunt/novel_rate", report["novel_rate"])
    metrics.gauge("hunt/revisit_rate", report["revisit_rate"])
    if report.get("time_to_violation_seconds") is not None:
        metrics.gauge("hunt/time_to_violation_seconds",
                      report["time_to_violation_seconds"])


def render_report(report: dict) -> str:
    """The human block printed at a swarm run's end (after the CLI's
    summary line) — headline saturation, then the depth/restart/family
    tables."""
    lines = [
        f"hunt: {report['distinct_observed']:,} distinct states observed "
        f"in {report['observations']:,} accepted visits "
        f"({report['steps']:,} walk-steps); saturation "
        f"{report['saturation']:.4f} (unseen mass "
        f"{report['unseen_mass']:.4f}, {report['singletons']:,} "
        f"singletons)",
    ]
    if report.get("time_to_violation_seconds") is not None:
        lines.append(f"  first counterexample at "
                     f"{report['time_to_violation_seconds']:.3f}s")
    curve = report.get("novelty_curve") or []
    if curve:
        tail = curve[-1]
        lines.append(f"  novelty rate: {report['novel_rate']:.4f} overall"
                     f", {tail[1]:.4f} in the last bucket "
                     f"(step {tail[0]:,})")
    d = report.get("depth") or {}
    if d.get("traces"):
        lines.append(f"  trace depth: mean {d['mean']:.2f}, p50 "
                     f"{d['p50']}, p90 {d['p90']} over {d['traces']:,} "
                     f"completed traces")
    r = report.get("restarts") or {}
    if r.get("total"):
        parts = ", ".join(f"{k}={r[k]:,}" for k in RESTART_REASONS
                          if r.get(k))
        lines.append(f"  restarts: {r['total']:,} ({parts})")
    fams = report.get("families") or []
    live = [f for f in fams if f["chosen"]]
    if live:
        best = max(live, key=lambda f: f["fresh"])
        lines.append("  family        chosen    accepted       fresh  "
                     "fresh-rate")
        for f in live:
            lines.append(f"  {f['family']:<12s} {f['chosen']:9,d} "
                         f"{f['accepted']:11,d} {f['fresh']:11,d}  "
                         f"{f['fresh_rate']:10.4f}")
        lines.append(f"  most productive family: {best['family']} "
                     f"({best['fresh']:,} fresh states)")
    bloom = report.get("bloom") or {}
    if bloom.get("load") is not None:
        lines.append(f"  estimator filter: {bloom['cells']:,} cells at "
                     f"load {bloom['load']:.4f} (collision p "
                     f"{bloom['collision_probability']:.2e})")
    return "\n".join(lines)


def summarize(report: Optional[dict]) -> dict:
    """The compact projection the run-history ledger stores per swarm
    run (obs/history.py ``kind=swarm`` entries)."""
    if not report:
        return {}
    fams = report.get("families") or []
    live = [f for f in fams if f.get("fresh")]
    best = max(live, key=lambda f: f["fresh"]) if live else None
    return {
        "saturation": report["saturation"],
        "unseen_mass": report["unseen_mass"],
        "distinct_observed": report["distinct_observed"],
        "novel_rate": report["novel_rate"],
        "revisit_rate": report["revisit_rate"],
        "novelty_curve": _refold(report.get("novelty_curve") or [], 8),
        "depth_p50": (report.get("depth") or {}).get("p50"),
        "time_to_violation_seconds":
            report.get("time_to_violation_seconds"),
        "best_family": best["family"] if best else None,
    }


def _refold(curve: List[List[float]], buckets: int) -> List[List[float]]:
    """Fold a rendered rate curve down to <= ``buckets`` points for the
    ledger (rates averaged pairwise — close enough for drift gating; the
    exact counts live only in the full report)."""
    pts = [list(p) for p in curve]
    while len(pts) > buckets:
        pts = [[b[0], round((a[1] + b[1]) / 2.0, 6)]
               for a, b in zip(pts[::2], pts[1::2])]
    return pts
