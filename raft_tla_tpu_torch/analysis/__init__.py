"""Static model analysis — proofs and lints that never run the state space.

The v1 action kernels (``models/actions.py``) are branch-free PyTorch
functions on fixed shapes over the ``StateBatch`` encoding, so the *model
itself* is analyzable: each kernel is traced once to an aten graph on
the CPU (``torch.fx``), and four passes share one graph evaluator
(``interp.py``) and one findings/report spine (``report.py``) — the JAX
package's ``analysis/``, re-derived from the port's own kernels:

- :mod:`.effects` — per-action ELEMENT-WISE (slot/column-granular)
  read/write masks: the element-granular action dependence matrix,
  guard-independence, dead packed lanes, and the versioned footprint
  serialization downstream tooling decodes instead of re-tracing;
- :mod:`.bounds` — interval abstract interpretation of every kernel to
  a reachable-envelope fixpoint: proves each packed lane wide enough (or
  names the witness action that overflows it) and flags integer wrap;
- :mod:`.lint` — what wrecks throughput on the card: host syncs and
  dynamic shapes in the traced chunk step, fingerprint and seen-set
  insert, nondeterministic float accumulation, accidental narrowing;
  an AST check that the host level loop only blocks on device data at
  its timed sync points; and an analyzer-vs-analyzer read-set
  self-check;
- :mod:`.por` — static partial-order reduction: per-instance ample-set
  certificates proved from the element-wise effects (closure, invariant
  visibility, cycle proviso), packed into the table ``EngineConfig.por``
  applies; closure blocks are classified by a concrete
  non-commutation witness search.

``run_analysis`` executes the passes and aggregates one
:class:`~.report.Report`; the ``analyze`` CLI subcommand consumes its
JSON.  Findings feed the telemetry spine (obs/): an ``analysis`` run
event per pass and ``analysis/errors`` / ``analysis/warnings`` counters.
Analysis traces on the CPU whatever the run's device.
"""

from __future__ import annotations

from typing import List, Optional

from .report import ERROR, INFO, Report, WARNING  # noqa: F401

#: Pass registry, in execution order.
PASSES = ("effects", "bounds", "lint", "por")

#: Inter-pass data dependencies: ``lint``'s read-set self-check and
#: ``por``'s certificates consume the effects pass's live summary.
#: ``resolve_passes`` inserts prerequisites automatically so a user can
#: run ``analyze --passes por`` without spelling out the pipeline.
PASS_DEPS = {"lint": ("effects",), "por": ("effects",)}


def resolve_passes(requested) -> tuple:
    """Close the requested pass list under :data:`PASS_DEPS` and return
    it in registry (topological) order.  Unknown names raise — a typo
    must never produce a silent no-op run."""
    requested = tuple(requested)
    unknown = [p for p in requested if p not in PASSES]
    if unknown or not requested:
        raise ValueError(
            f"unknown analysis pass(es) "
            f"{', '.join(unknown) or '(none given)'}; registered: "
            f"{', '.join(PASSES)}")
    want = set(requested)
    # PASS_DEPS is one level deep today; iterate to a fixpoint anyway so
    # a deeper chain added later cannot silently under-resolve.
    while True:
        more = {d for p in want for d in PASS_DEPS.get(p, ())} - want
        if not more:
            break
        want |= more
    return tuple(p for p in PASSES if p in want)


def run_analysis(dims, bounds=None, init_states=None,
                 passes=PASSES, allowlist: Optional[List[str]] = None,
                 lane_caps=None, invariant_names=None,
                 metrics=None, evlog=None) -> Report:
    """Run the requested passes over one model.

    ``bounds`` is the cfg's CONSTRAINT bounds (models/invariants.Bounds),
    ``init_states`` concrete roots to seed the bounds fixpoint and the
    POR closure-refutation probe pool (None or randomized-smoke roots
    fall back to the declared domain envelope / the model's probe
    states), ``lane_caps`` overrides the bounds pass's lane capacities
    (``analyze --shrink-lane``), ``invariant_names`` the cfg's INVARIANT
    list for the POR visibility condition (None = the conservative full
    registry).  ``passes`` is closed under :data:`PASS_DEPS` — asking
    for ``por`` alone runs ``effects`` first.  ``metrics``
    (MetricsRegistry) and ``evlog`` (RunEventLog) receive the per-pass
    telemetry when given."""
    passes = resolve_passes(passes)
    report = Report(model={"dims": repr(dims),
                           "model_class": type(dims).__name__},
                    allowlist=allowlist)
    # The effects summary is shared downstream: lint's read-set
    # self-check and por's certificates consume the SAME matrices the
    # effects pass serialized (no re-tracing within one invocation).
    eff_summary = None
    for name in passes:
        if name == "effects":
            from . import effects
            eff_summary, findings = effects.analyze(dims)
            summary = effects.summary_json(eff_summary)
        elif name == "bounds":
            from . import bounds as bounds_mod
            summary, findings = bounds_mod.analyze(
                dims, bounds=bounds, init_states=init_states,
                lane_caps=lane_caps)
        elif name == "lint":
            from . import lint
            summary, findings = lint.analyze(dims, effect_summary=eff_summary)
        elif name == "por":
            from . import por
            summary, findings = por.analyze(
                dims, bounds=bounds, invariant_names=invariant_names,
                effect_summary=eff_summary, init_states=init_states)
        else:
            raise ValueError(f"unknown analysis pass {name!r}; "
                             f"registered: {PASSES}")
        report.extend(findings)
        report.summarize_pass(name, summary)
        counts = report.severity_counts(name)
        if metrics is not None:
            metrics.counter("analysis/errors", counts[ERROR])
            metrics.counter("analysis/warnings", counts[WARNING])
        if evlog is not None:
            evlog.emit("analysis", pass_name=name,
                       severity_counts=counts,
                       witness=report.first_witness(name))
    return report
