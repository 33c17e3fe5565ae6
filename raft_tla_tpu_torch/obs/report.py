"""TLC-parity run report: the statistics block at the end of a run.

The JAX package's ``obs/report.py``, kept as the port's own copy.
``build_report`` folds a finished ``EngineResult``, the run's
``ActionCoverage`` and the per-level rows the engine appends at each
level boundary into one JSON-able dict:

- ``collision``: TLC's "calculated (optimistic)" fingerprint-collision
  probability ``distinct * (generated - distinct) / 2**64``, and the
  collisions the run observed (replay mismatches; 0 on a healthy run);
- ``diameter``, ``distinct``, ``generated``, ``verdict``, ``stop_reason``;
- ``levels``: frontier width, cumulative distinct and generated, seen-set
  size and load at each level boundary;
- ``out_degree``: mean enabled successors an expanded parent, in all and
  per family;
- ``seen_set``: final load, capacity, growths;
- ``family_groups``: the base families grouped by parameter grid.

Host arithmetic over counters the level loop has already read, so the
report cannot change what the engine computes.  Surfaces: the
``statespace`` run event, ``EngineResult.report``, the ``fp collision
prob`` and ``widest level`` lines of ``format_result``, the stderr block
of a run with progress lines, and the ``statespace/*`` gauges.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# The report reads the groups from EngineResult.family_groups; the
# function is kept under this name too.
from ..models.dims import family_groups  # noqa: F401

#: 2^64 as a float — the fingerprint space TLC's probability formula
#: divides by (the engines' dual 32+32-bit key is 64 bits too).
_FP_SPACE = float(1 << 64)


def collision_probability(distinct: int, generated: int) -> float:
    """TLC's "calculated (optimistic)" fingerprint-collision estimate:
    every one of the ``generated - distinct`` duplicate hits was decided
    by fingerprint equality alone, each with a ``distinct / 2**64``
    chance of being a masked genuinely-new state."""
    dupes = max(0, generated - distinct)
    return (distinct / _FP_SPACE) * dupes


def build_report(result, coverage=None, level_stats=None,
                 seen_capacity: Optional[int] = None,
                 seen_size: Optional[int] = None,
                 observed_collisions: int = 0) -> dict:
    """Assemble the TLC-parity report dict from a finished run.

    ``result`` duck-types :class:`~..engine.bfs.EngineResult` (distinct /
    generated / diameter / levels / stop_reason / violation / deadlock);
    ``coverage`` is the run's :class:`.coverage.ActionCoverage` (None on
    trace-only callers); ``level_stats`` the engines' per-level snapshot
    list (each ``{"level", "frontier", "distinct", "generated",
    "seen_size", "seen_capacity"}``) — levels missing from it (resumed
    prefixes) still appear in the table with width only."""
    levels: List[int] = list(getattr(result, "levels", []) or [])
    by_level: Dict[int, dict] = {int(d.get("level", -1)): d
                                 for d in (level_stats or [])}
    table = []
    for lvl, width in enumerate(levels):
        row = {"level": lvl, "frontier": int(width)}
        extra = by_level.get(lvl)
        if extra is not None:
            row["distinct"] = int(extra.get("distinct", 0))
            row["generated"] = int(extra.get("generated", 0))
            cap = int(extra.get("seen_capacity", 0) or 0)
            size = int(extra.get("seen_size", 0) or 0)
            if cap:
                row["seen_size"] = size
                row["seen_load"] = round(size / cap, 4)
        table.append(row)
    peak = max(range(len(levels)), key=lambda i: levels[i],
               default=None) if levels else None

    distinct = int(getattr(result, "distinct", 0))
    generated = int(getattr(result, "generated", 0))
    verdict = ("violation" if getattr(result, "violation", None) is not None
               else "deadlock" if getattr(result, "deadlock", None)
               is not None else "ok")

    out_degree: dict = {}
    if coverage is not None and coverage.expanded:
        exp = coverage.expanded
        out_degree = {
            "expanded_parents": exp,
            "mean": round(coverage.total_generated / exp, 4),
            "per_family": {n: round(coverage.generated[n] / exp, 4)
                           for n in coverage.names},
        }

    seen: dict = {}
    if seen_capacity:
        seen["capacity"] = int(seen_capacity)
        # Final load from the run's live seen-set gauges (the table
        # itself holds MORE keys than enqueued states: constraint-
        # violating states are inserted but never expanded).
        seen["final_load"] = round(
            (seen_size if seen_size is not None else distinct)
            / seen_capacity, 4)
    growths = list(getattr(result, "growth_stalls", ()) or ())
    if growths:
        seen["growths"] = [[int(c), float(s)] for c, s in growths]
    # The load CURVE rides the level table (seen_load per boundary);
    # summarize its endpoint here for the one-line rendering.
    loads = [r["seen_load"] for r in table if "seen_load" in r]
    if loads:
        seen["load_curve_final"] = loads[-1]

    # The families grouped by parameter grid (EngineResult.family_groups).
    fam_groups = [dict(g) for g in
                  (getattr(result, "family_groups", None) or [])]

    return {
        "distinct": distinct,
        "generated": generated,
        "diameter": int(getattr(result, "diameter", 0)),
        "stop_reason": getattr(result, "stop_reason", None),
        "verdict": verdict,
        "family_groups": fam_groups,
        "collision": {
            "calculated": collision_probability(distinct, generated),
            "formula": "distinct * (generated - distinct) / 2^64",
            "observed_dual_key": int(observed_collisions),
        },
        "levels": table,
        "frontier_peak": ({"level": peak, "frontier": levels[peak]}
                          if peak is not None else None),
        "out_degree": out_degree,
        "seen_set": seen,
    }


def feed_metrics(report: dict, metrics) -> None:
    """Mirror the report's scalar spine into ``statespace/*`` gauges so
    ``--metrics-out`` snapshots carry it
    (gauges — idempotent across re-reports, like coverage)."""
    metrics.gauge("statespace/collision_probability",
                  report["collision"]["calculated"])
    metrics.gauge("statespace/collisions_observed",
                  report["collision"]["observed_dual_key"])
    metrics.gauge("statespace/diameter", report["diameter"])
    peak = report.get("frontier_peak") or {}
    if peak:
        metrics.gauge("statespace/frontier_peak", peak["frontier"])
    od = report.get("out_degree") or {}
    if od:
        metrics.gauge("statespace/mean_out_degree", od["mean"])
    seen = report.get("seen_set") or {}
    if "final_load" in seen:
        metrics.gauge("statespace/seen_load", seen["final_load"])


def _fmt_prob(p: float) -> str:
    return f"{p:.2e}" if p else "0"


def render_report(report: dict) -> str:
    """The TLC-style stderr block (the ``MCraft.cfg`` run-end shape):
    headline counts + collision estimate, then the per-level table and
    the out-degree/seen-set summaries."""
    col = report["collision"]
    lines = [
        f"state space: {report['generated']:,} states generated, "
        f"{report['distinct']:,} distinct states found, diameter "
        f"{report['diameter']} ({report['verdict']}, "
        f"stop: {report['stop_reason']})",
        f"  fingerprint collision probability: calculated (optimistic) "
        f"{_fmt_prob(col['calculated'])}"
        f"; observed dual-key collisions: {col['observed_dual_key']}",
    ]
    table = report.get("levels") or []
    if table:
        lines.append("  level  frontier     distinct    generated  "
                     "fpset-load")
        for row in table:
            d = (f"{row['distinct']:12,d}" if "distinct" in row
                 else f"{'--':>12s}")
            g = (f"{row['generated']:12,d}" if "generated" in row
                 else f"{'--':>12s}")
            load = (f"{row['seen_load']:10.3f}" if "seen_load" in row
                    else f"{'--':>10s}")
            lines.append(f"  {row['level']:5d} {row['frontier']:9,d} "
                         f"{d} {g}  {load}")
        peak = report.get("frontier_peak")
        if peak:
            lines.append(f"  widest level: {peak['level']} "
                         f"({peak['frontier']:,} states)")
    od = report.get("out_degree") or {}
    if od:
        widest = max(od["per_family"], key=od["per_family"].get)
        lines.append(
            f"  out-degree: mean {od['mean']:.2f} over "
            f"{od['expanded_parents']:,} expanded parents; widest family "
            f"{widest} ({od['per_family'][widest]:.2f})")
    seen = report.get("seen_set") or {}
    if seen.get("capacity"):
        g = (f", {len(seen['growths'])} growth(s)"
             if seen.get("growths") else "")
        lines.append(f"  seen-set: final load {seen['final_load']:.3f} "
                     f"of {seen['capacity']:,} keys{g}")
    groups = report.get("family_groups") or []
    if groups:
        total_k = sum(g["kernels"] for g in groups)
        parts = ", ".join(f"{g['group']}={g['kernels']}k/{g['lanes']}l"
                          for g in groups)
        lines.append(f"  expansion groups: {len(groups)} stacked groups, "
                     f"{total_k} member kernels ({parts})")
    return "\n".join(lines)


def summarize(report: Optional[dict]) -> dict:
    """The compact projection of a report that a run-history entry keeps
    (the JAX package's ``obs/history.py``, not yet ported)."""
    if not report:
        return {}
    peak = report.get("frontier_peak") or {}
    od = report.get("out_degree") or {}
    out = {
        "collision_calculated": report["collision"]["calculated"],
        "diameter": report["diameter"],
        "verdict": report["verdict"],
        "levels": len(report.get("levels") or []),
        "frontier_peak": peak.get("frontier"),
        "mean_out_degree": od.get("mean"),
    }
    groups = report.get("family_groups") or []
    if groups:
        out["family_groups"] = {g["group"]: g["kernels"] for g in groups}
    return out
