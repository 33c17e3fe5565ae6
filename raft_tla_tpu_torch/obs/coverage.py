"""TLC-style action coverage: per action family generated, distinct,
disabled and POR-pruned counts.

The JAX package's ``obs/coverage.py``, kept as the port's own copy.  The
chunk step already keeps these counts on the device in its state words
(``engine/chunk.py``: per family the enabled lanes, the novel lanes and
the POR-pruned lanes, and the parents expanded), and the level loop reads
them with the one stats read a chunk makes, so coverage adds no host–device
sync.  ``generated`` per family is the series the engine accumulates
into ``EngineResult.action_counts``; ``distinct`` sums to the run's
distinct count past the roots; ``disabled`` is ``expanded parents x
family size - generated - pruned``, host arithmetic.  Consumers: the
``coverage`` run events, the ``coverage/<family>/*`` gauges, the
stderr table at run end and the statespace report's out-degree.
"""

from __future__ import annotations

from typing import Dict, List, Sequence


class ActionCoverage:
    """Per-action-family coverage accumulator (one per engine run)."""

    def __init__(self, family_names: Sequence[str],
                 family_sizes: Sequence[int]):
        self.names: List[str] = list(family_names)
        self.sizes: List[int] = [int(s) for s in family_sizes]
        self.generated: Dict[str, int] = {n: 0 for n in self.names}
        self.distinct: Dict[str, int] = {n: 0 for n in self.names}
        #: Enabled lanes the partial-order reduction masked out before
        #: fingerprinting (analysis/por.py; zero with POR off) — the
        #: reduced-vs-full accounting: a pruned guard evaluation was
        #: TRUE, so it belongs to neither ``generated`` nor
        #: ``disabled``.
        self.pruned: Dict[str, int] = {n: 0 for n in self.names}
        #: Parents actually expanded (each evaluates every instance's
        #: guard once) — the base for the disabled counts.
        self.expanded = 0

    def add_chunk(self, expanded: int, gen_counts, new_counts,
                  pruned_counts=None) -> None:
        """Fold one chunk call's packed per-family stats in.
        ``gen_counts``/``new_counts``/``pruned_counts`` are the
        per-family vectors from the chunk stats (any int sequence),
        ``expanded`` the parents the call advanced past."""
        self.expanded += int(expanded)
        for name, g, d in zip(self.names, gen_counts, new_counts):
            g, d = int(g), int(d)
            if g:
                self.generated[name] += g
            if d:
                self.distinct[name] += d
        if pruned_counts is not None:
            for name, p in zip(self.names, pruned_counts):
                p = int(p)
                if p:
                    self.pruned[name] += p

    def seed_generated(self, action_counts: Dict[str, int]) -> None:
        """Resume support: continue the generated series from a
        checkpoint's ``action_counts`` so the run-end table still
        matches ``generated_by_action`` exactly.  Distinct/expanded are
        not checkpointed and restart from zero — a resumed run's
        distinct column covers the post-resume portion only."""
        for name, c in action_counts.items():
            if name in self.generated:
                self.generated[name] += int(c)

    def disabled(self, name: str) -> int:
        size = self.sizes[self.names.index(name)]
        # Clamped: a resumed run's expanded counter restarts at zero
        # while generated resumes from the checkpoint, which would
        # otherwise push this negative.  Pruned lanes had a TRUE guard,
        # so they are subtracted from the disabled base too.
        return max(0, self.expanded * size - self.generated[name]
                   - self.pruned[name])

    @property
    def total_generated(self) -> int:
        return sum(self.generated.values())

    @property
    def total_distinct(self) -> int:
        return sum(self.distinct.values())

    @property
    def total_pruned(self) -> int:
        return sum(self.pruned.values())

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """JSON-ready ``{family: {generated, distinct, disabled,
        pruned}}`` — the payload of ``coverage`` events and
        ``EngineResult.coverage``."""
        return {n: {"generated": self.generated[n],
                    "distinct": self.distinct[n],
                    "disabled": self.disabled(n),
                    "pruned": self.pruned[n]}
                for n in self.names}

    def feed_metrics(self, metrics) -> None:
        """Mirror the totals into registry gauges (idempotent — gauges,
        not counters, so a progress-interval refresh never double-counts)
        for ``--metrics-out`` snapshots."""
        for n in self.names:
            metrics.gauge(f"coverage/{n}/generated", self.generated[n])
            metrics.gauge(f"coverage/{n}/distinct", self.distinct[n])
            metrics.gauge(f"coverage/{n}/disabled", self.disabled(n))
            metrics.gauge(f"coverage/{n}/pruned", self.pruned[n])
        metrics.gauge("coverage/expanded_states", self.expanded)

    def render_table(self) -> str:
        """The TLC-parity run-end report (stderr): one row per action
        family, sorted by generated, with the distinct ratio that tells
        a user which actions are churning duplicates.  A ``pruned``
        column appears only when the run's POR mask dropped anything, so
        full-expansion renders are byte-identical to the pre-POR
        format."""
        rows = sorted(self.names, key=lambda n: -self.generated[n])
        width = max([len(n) for n in self.names] + [6])
        por = self.total_pruned > 0
        prun_hdr = f" {'pruned':>12s}" if por else ""
        lines = [f"coverage (actions: {len(self.names)}, parents "
                 f"expanded: {self.expanded:,}"
                 + (f", POR pruned: {self.total_pruned:,}" if por else "")
                 + "):",
                 f"  {'action':{width}s} {'generated':>12s} "
                 f"{'distinct':>12s} {'disabled':>14s}{prun_hdr} "
                 f"{'new%':>6s}"]
        for n in rows:
            g, d = self.generated[n], self.distinct[n]
            pct = f"{100.0 * d / g:5.1f}%" if g else "    --"
            prun = f" {self.pruned[n]:12,d}" if por else ""
            lines.append(f"  {n:{width}s} {g:12,d} {d:12,d} "
                         f"{self.disabled(n):14,d}{prun} {pct:>6s}")
        lines.append(f"  {'total':{width}s} {self.total_generated:12,d} "
                     f"{self.total_distinct:12,d}")
        return "\n".join(lines)
