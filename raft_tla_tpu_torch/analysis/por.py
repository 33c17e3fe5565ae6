"""Static partial-order reduction: ample-set certificates from the
dependence matrices, and the table the engines apply.

The effects pass (``effects.py``) proves, per action instance,
element-wise read and write masks and folds them into the action
dependence matrix.  This pass consumes those matrices and asks, for every
instance ``g``: *is the singleton ``{g}`` a valid ample set at every state
where ``g`` is enabled?*  If yes, the engine may expand ONLY ``g`` from
such a state and provably misses no invariant verdict.  Four side
conditions, each proved statically or the instance is conservatively
widened to "never ample" (a WARNING, never a silent claim):

- **C0 non-emptiness** — structural: the engine applies the reduction
  only at states whose enabled set contains a certified instance.
- **C1 closure (stubbornness)** — ``g`` must be independent of EVERY
  other instance (``effects.independent`` row complete off-diagonal):
  element-disjoint writes and neither touches what the other reads, so
  ``{g}`` is a persistent set wherever ``g`` is enabled.  Anything
  weaker is unsound: a dependent action merely *disabled right now* can
  become enabled along a deferred path and observe ``g``'s writes.
- **C2 invariant visibility** — ``g``'s writes must be disjoint from
  the read set of every checked predicate: the configured INVARIANTs
  (``models/invariants.py`` TypeOK and the ``models/safety.py`` suite by
  default) AND the cfg CONSTRAINT, read sets traced through the same
  taint interpreter as the effects pass.
- **C3 cycle proviso** — ``g`` must be provably *self-disabling*: the
  kernel's guard, re-evaluated under the interval domain on ``g``'s own
  successor envelope, must be must-false, so an ample-only path executes
  each certified instance at most once and no cycle of the reduced graph
  consists solely of ample steps.

On the base Raft alphabet this is an honest negative result, and a
proven one: every instance fails C1, and the closure-refutation search
exhibits, for every instance that can execute, a concrete two-action
non-commutation witness — running the v1 kernels (``build_expand``) on
type-correct probe states — so the block is inherent to the alphabet
(``Receive`` can address any server and its reply allocation scans the
whole bag), not analyzer imprecision.  The ``blocked_by`` /
``blocking_elements`` tables stay the worklist for model variants and
simpler alphabets, where the same pass can certify.

:class:`PorTable` is the device-consumable artifact: a per-instance
``ample_mask`` and ``priority`` (lowest value, then lowest ``g``, wins
when several certified instances are enabled in one state), and
``predicates``, every state predicate the visibility condition was
proved against.  Its payload and sha256 fingerprint are the JAX
package's (``raft_tla_tpu/analysis/por.py``), so a table either package
builds for the same model is accepted by both and carries the same
fingerprint, and a hand-edited one is refused.  ``check_table`` is the
engine-side admission check.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import lane_map
from .interp import (IntervalDomain, TaintDomain, _ival, eval_graph,
                     param_args, read_mask, trace_predicate, traced_kernels)
from .report import ERROR, Finding, INFO, WARNING

PASS = "por"

#: v2: certificates are proved from ELEMENT-granular (slot/column)
#: footprints and the payload records the granularity; v1 artifacts are
#: refused at load and must be regenerated.
TABLE_VERSION = 2
GRANULARITY = "element"
#: C0-C3 condition names, report order.
CONDITIONS = ("nonempty", "closure", "visibility", "proviso")
#: The name under which a table lists the cfg's CONSTRAINT predicate.
CONSTRAINT_PREDICATE = "CONSTRAINT"


@dataclasses.dataclass
class PorTable:
    model: str
    n_instances: int
    ample_mask: np.ndarray          # [G] bool
    priority: np.ndarray            # [G] int32
    predicates: Tuple[str, ...]
    version: int = TABLE_VERSION
    granularity: str = GRANULARITY

    def __post_init__(self):
        self.ample_mask = np.asarray(self.ample_mask, bool)
        self.priority = np.asarray(self.priority, np.int32)
        if self.ample_mask.shape != (self.n_instances,) \
                or self.priority.shape != (self.n_instances,):
            raise ValueError("table arrays must be [n_instances]")

    @property
    def certified(self) -> int:
        return int(self.ample_mask.sum())

    def payload(self) -> dict:
        return {"version": self.version, "model": self.model,
                "granularity": self.granularity,
                "n_instances": self.n_instances,
                "predicates": sorted(self.predicates),
                "ample_mask": [int(b) for b in self.ample_mask],
                "priority": [int(p) for p in self.priority]}

    @property
    def fingerprint(self) -> str:
        blob = json.dumps(self.payload(), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()

    def to_json(self) -> dict:
        out = self.payload()
        out["fingerprint"] = self.fingerprint
        return out

    @classmethod
    def from_json(cls, d: dict) -> "PorTable":
        if d.get("version") != TABLE_VERSION \
                or d.get("granularity", GRANULARITY) != GRANULARITY:
            raise ValueError(
                f"POR table version {d.get('version')!r} "
                f"(granularity {d.get('granularity')!r}) != supported "
                f"{TABLE_VERSION}/{GRANULARITY!r} — certificates proved "
                "under a coarser footprint encoding; regenerate with "
                "`analyze --passes por`")
        table = cls(model=d["model"], n_instances=int(d["n_instances"]),
                    ample_mask=np.asarray(d["ample_mask"], bool),
                    priority=np.asarray(d["priority"], np.int32),
                    predicates=tuple(d["predicates"]))
        if d.get("fingerprint") != table.fingerprint:
            raise ValueError(
                "POR table fingerprint mismatch (edited by hand, or "
                "truncated): the certificate no longer matches its "
                "payload; regenerate with `analyze --passes por "
                "--por-artifact FILE`")
        return table

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")


def load_table(path: str) -> PorTable:
    with open(path) as f:
        return PorTable.from_json(json.load(f))


def check_table(table: PorTable, dims, invariant_names=None,
                has_constraint: bool = False) -> None:
    """Engine-side admission: model signature, instance count and
    predicate coverage.  ``ValueError`` on any mismatch: a reduction
    certified for another model, or for fewer predicates than the run
    checks, is never applied."""
    if table.model != repr(dims):
        raise ValueError(
            f"POR table was certified for model {table.model!r}, "
            f"engine runs {repr(dims)!r}")
    if table.n_instances != dims.n_instances:
        raise ValueError(
            f"POR table covers {table.n_instances} action instances, "
            f"model has {dims.n_instances}")
    missing = sorted(set(invariant_names or []) - set(table.predicates))
    if missing:
        raise ValueError(
            f"POR table visibility was not proved against checked "
            f"invariant(s) {missing}; certified predicates: "
            f"{sorted(table.predicates)}")
    if has_constraint and CONSTRAINT_PREDICATE not in table.predicates:
        raise ValueError(
            "POR table was certified without a CONSTRAINT predicate "
            "but the run applies one; constraint reads gate "
            "expansion and must be part of the visibility condition")


# ---------------------------------------------------------------------------
# Predicate read sets (invariant-visibility inputs)


def predicate_read_sets(dims, predicates) -> Tuple[Dict[str, Dict],
                                                   List[str]]:
    """``{name: {field: element mask}}`` for ``[(name, kernel)]``, via
    the taint domain (sound: a dropped dependency would be an interp
    bug — the lint pass's read-set self-check guards the same property
    on the action kernels).  Element-wise since the taint domain tracks
    per-element masks; an invariant that reads only some lanes of a
    field no longer blocks visibility for writes to the others.  Also
    returns the domain's imprecision notes."""
    from .effects import _state_taints, _strip
    domain = TaintDomain()
    state = _state_taints(dims)
    out: Dict[str, Dict] = {}
    for name, kernel in predicates:
        res = eval_graph(trace_predicate(kernel, dims), list(state), domain)
        out[name] = _strip(read_mask(res[0]))
    return out, list(domain.notes)


# ---------------------------------------------------------------------------
# C3: self-disabling proof (interval domain)


def _envelope_intervals(dims, bounds=None):
    """Declared per-field domains (lane_map.field_domains — the same
    widening envelope the bounds pass uses), intersected with the cfg's
    CONSTRAINT clamps, as interval-domain state values (one parent row,
    the traced graphs' shapes)."""
    domains = lane_map.field_domains(dims)
    clamps = lane_map.constraint_bounds(dims, bounds)
    shapes = lane_map.field_shapes(dims)
    out = []
    for f in lane_map.FIELDS:
        lo, hi = domains[f]
        lo = np.broadcast_to(np.asarray(lo, np.int64), shapes[f])
        hi = np.broadcast_to(np.asarray(hi, np.int64), shapes[f])
        if f in clamps:
            clo, chi = clamps[f]
            lo = np.maximum(lo, clo)
            hi = np.minimum(hi, chi)
        out.append(_ival(lo[None], hi[None], torch.int64))
    return out


def _memo(cache):
    """The parameter-only node values ``eval_graph`` shares across the
    evaluations of one pass (kept in the envelope cache), or None."""
    return None if cache is None else cache.setdefault("memo", {})


def _on_envelope(graph, params, env_state, cache=None):
    """The family graph's outputs on the envelope for one parameter row
    (interval domain) and the domain's notes; ``cache`` (a dict keyed by
    the graph and the row) shares them between the proviso proof and
    the vacuity check."""
    key = (id(graph), tuple(int(v) for v in params))
    if cache is not None and key in cache:
        return cache[key]
    domain = IntervalDomain()
    outs = eval_graph(graph, list(env_state) + param_args(params), domain,
                      memo=_memo(cache), n_state=len(lane_map.FIELDS))
    got = (outs, list(domain.notes))
    if cache is not None:
        cache[key] = got
    return got


def self_disabling(graph, params, env_state,
                   cache=None) -> Tuple[bool, List[str]]:
    """Prove the instance's guard false on its own successors.

    Evaluates the family graph once on the reachable envelope (successor
    intervals over-approximate every ``g``-successor of every state in
    the envelope), then re-evaluates the same graph on those successor
    intervals and requires the ``enabled`` output to be must-false.
    Conservative both ways: an imprecision widens the guard toward
    "maybe enabled" and the proof simply fails."""
    outs, notes = _on_envelope(graph, params, env_state, cache)
    domain = IntervalDomain()
    outs2 = eval_graph(graph, list(outs[2:]) + param_args(params), domain,
                       memo=_memo(cache), n_state=len(lane_map.FIELDS))
    en2 = outs2[0]
    proved = bool(np.all(np.asarray(en2.hi) == 0))
    return proved, notes + [n for n in domain.notes if n not in notes]


@dataclasses.dataclass
class Certificate:
    """Per-instance ample-set certificate: condition -> (proved, why)."""

    grid_index: int
    family: str
    label: str
    conditions: Dict[str, Tuple[bool, str]]

    @property
    def ample(self) -> bool:
        return all(ok for ok, _why in self.conditions.values())

    def blocking(self) -> List[str]:
        return [c for c in CONDITIONS if not self.conditions[c][0]]


# ---------------------------------------------------------------------------
# Closure refutation: machine-checked impossibility witnesses
#
# A family blocked on C1 by the dependence matrix could in principle be
# an analyzer artifact (over-approximate footprints) — the precision
# worklist — or INHERENT: the actions genuinely do not commute, so no
# sound footprint abstraction at any granularity can ever certify the
# singleton.  The distinction is decided concretely: for each blocked
# instance the pass searches a small pool of type-correct probe states
# (``models.pystate.probe_states`` + the run's roots) for a two-action
# non-commutation witness — a state where both actions are enabled and
# either one disables the other or the diamond closes on different
# states.  The check executes the COMPILED kernels (``build_expand``,
# the exact programs the engine runs) on concrete states; a found
# witness is therefore a semantic refutation of independence, not an
# abstract-domain claim.  Instances whose guard is must-false on the
# declared domain envelope (interval proof) are vacuous: they can never
# execute, so no witness exists or is needed — a certificate for them
# could never prune anything.
#
# Probe states need not be reachable: C1's independence requirement is
# a property over the declared state domain (the same envelope every
# other condition is proved against), so any type-correct witness
# refutes it for every sound analyzer.


@dataclasses.dataclass
class ClosureRefutation:
    """Per-instance outcome of the witness search."""

    label: str
    #: "witnessed" (concrete non-commutation found), "vacuous" (guard
    #: must-false on the declared envelope), or "open" (no witness in
    #: the probe pool — genuine precision worklist).
    status: str
    #: witnessed: the conflicting instance, the witness kind
    #: ("disables", "disabled-by", "diamond") and the probe state index.
    conflicts_with: Optional[str] = None
    kind: Optional[str] = None
    probe_state: Optional[int] = None

    def to_json(self) -> dict:
        out = {"label": self.label, "status": self.status}
        if self.conflicts_with is not None:
            out.update(conflicts_with=self.conflicts_with, kind=self.kind,
                       probe_state=self.probe_state)
        return out


def _canonical_state(fields_np, k: int) -> tuple:
    """Hashable canonical view of row ``k`` of a ``StateBatch``'s fields
    (numpy arrays, ``lane_map.FIELDS`` order): plain fields verbatim, the
    message bag as a sorted multiset of occupied (row, count) pairs —
    slot-permutation invariant, so two orders of a commuting pair that
    allocate reply slots differently still compare equal."""
    fields = {f: a[k] for f, a in zip(lane_map.FIELDS, fields_np)}
    msg, cnt = fields.pop("msg"), fields.pop("msg_cnt")
    occ = cnt > 0
    bag = sorted((tuple(int(x) for x in row), int(c))
                 for row, c in zip(msg[occ], cnt[occ]))
    plain = tuple((f, tuple(np.asarray(v).reshape(-1).tolist()))
                  for f, v in sorted(fields.items()))
    return plain, tuple(bag)


def _vacuous_instances(dims, env, cache=None) -> Dict[int, bool]:
    """{grid index: guard is must-false on the declared envelope} — the
    interval-domain proof that an instance can never execute (e.g. the
    ``AppendEntries(i, i)`` grid corners, whose guard is
    parameter-concrete False)."""
    out: Dict[int, bool] = {}
    kernels = {name: graph for name, graph, _p in traced_kernels(dims)}
    for g in range(dims.n_instances):
        fam_code, params = dims.instance_info(g)
        graph = kernels[dims.family_names[fam_code]]
        outs, _notes = _on_envelope(graph, tuple(params.values()), env,
                                    cache)
        out[g] = bool(np.all(np.asarray(outs[0].hi) == 0))
    return out


def closure_refutations(dims, probe_pool, env,
                        cache=None) -> List[ClosureRefutation]:
    """Run the witness search over ``probe_pool`` (PyStates).  Returns
    one :class:`ClosureRefutation` per action instance.  The kernels run
    on the CPU: probe states are a handful."""
    from ..models.actions import build_expand
    from ..models.schema import encode_state, stack_states, unflatten_state

    G = dims.n_instances
    labels = [dims.describe_instance(g) for g in range(G)]
    vac = _vacuous_instances(dims, env, cache)
    out: Dict[int, ClosureRefutation] = {
        g: ClosureRefutation(labels[g], "vacuous")
        for g in range(G) if vac[g]}

    expand = build_expand(dims, "cpu")

    def step(st):
        """(successor rows, enabled, overflow) of every instance of every
        parent; a successor its row cannot hold counts as an overflow,
        as the engines fold it."""
        cands, en, ovf = expand(st)
        ovf = ovf | (en & ~cands.pack_ok)
        return cands.rows, (en & ~ovf).numpy(), ovf.numpy()

    for si, ps in enumerate(probe_pool):
        if len(out) == G:
            break
        rows, en, _ovf = step(stack_states([encode_state(ps, dims)], "cpu"))
        en = en[0]
        if not en.any():
            continue
        rows2, en2, ovf2 = step(unflatten_state(rows, dims))
        en2, ovf2 = en2.reshape(G, G), ovf2.reshape(G, G)
        c2 = [x.numpy() for x in unflatten_state(rows2, dims)]
        canon: Dict[Tuple[int, int], tuple] = {}

        def second(g, h):
            if (g, h) not in canon:
                canon[(g, h)] = _canonical_state(c2, g * G + h)
            return canon[(g, h)]

        for g in range(G):
            if g in out or not en[g]:
                continue
            for h in range(G):
                if h == g or not en[h]:
                    continue
                # Disabling counts only when the second step is cleanly
                # disabled, not when its ENCODING overflowed (an
                # overflow lane reports enabled=False with the overflow
                # flag set — that is a capacity artifact, not semantics).
                if not en2[g, h] and not ovf2[g, h]:
                    out[g] = ClosureRefutation(
                        labels[g], "witnessed", labels[h], "disables", si)
                    break
                if not en2[h, g] and not ovf2[h, g]:
                    out[g] = ClosureRefutation(
                        labels[g], "witnessed", labels[h], "disabled-by",
                        si)
                    break
                if not (en2[g, h] and en2[h, g]) \
                        or ovf2[g, h] or ovf2[h, g]:
                    continue
                if second(g, h) != second(h, g):
                    out[g] = ClosureRefutation(
                        labels[g], "witnessed", labels[h], "diamond", si)
                    break
    for g in range(G):
        if g not in out:
            out[g] = ClosureRefutation(labels[g], "open")
    return [out[g] for g in range(G)]


# ---------------------------------------------------------------------------
# The pass


def _mask_overlap(writes: Dict[str, np.ndarray],
                  reads: Dict[str, np.ndarray]) -> List[Tuple[str,
                                                              np.ndarray]]:
    """Element-wise intersection of a write and a read footprint:
    ``[(field, overlap mask), ...]`` for the fields that clash."""
    out = []
    for f, m in writes.items():
        r = reads.get(f)
        if r is not None and bool((m & r).any()):
            out.append((f, m & r))
    return out


def element_label(field: str, mask: np.ndarray) -> str:
    """Human-readable label of the first blocking element of a mask —
    the ``(family, field, slot)`` triple rendering the worklist uses.
    A fully-set mask reads as the whole field."""
    if mask.all():
        return f"{field}[*]"
    idx = np.unravel_index(int(np.flatnonzero(mask.reshape(-1))[0]),
                           mask.shape)
    if mask.ndim == 2 and mask[idx[0]].all():
        return f"{field}[{idx[0]},*]"
    return f"{field}[{','.join(str(int(k)) for k in idx)}]"


def _build_certificates(dims, summary, read_sets, bounds, cache=None,
                        provisos=None):
    """One :class:`Certificate` per action instance (``cache``: the
    envelope evaluations, shared with the closure refutation;
    ``provisos``: the proviso proofs by (family, parameter row), kept by
    the caller when it outlives one call)."""
    from .effects import conflict_elements
    instances = summary.instances
    G = len(instances)
    indep = summary.independent
    env = _envelope_intervals(dims, bounds)
    kernels = {name: (graph, params)
               for name, graph, params in traced_kernels(dims)}
    # Per-(family, param row) proviso proofs — instances of one family
    # share a graph, so memoize on the concrete parameter tuple.
    proviso_cache: Dict[Tuple, Tuple[bool, List[str]]] = \
        {} if provisos is None else provisos

    certs: List[Certificate] = []
    for g, inst in enumerate(instances):
        conds: Dict[str, Tuple[bool, str]] = {}
        # C0: the engine masks only states where this instance is
        # enabled, so the chosen ample set is non-empty by construction.
        conds["nonempty"] = (True, "ample applied only where enabled")

        dep = [h for h in range(G) if h != g and not indep[g, h]]
        if dep:
            dep_fams = sorted({instances[h].family for h in dep})
            # Name the first blocking element — the precision worklist's
            # exact next step for this instance.
            kind, fld, mask = conflict_elements(inst, instances[dep[0]])[0]
            conds["closure"] = (
                False, "statically dependent on instance(s) of "
                       f"{', '.join(dep_fams)} — a deferred dependent "
                       "action could observe this instance's writes; "
                       f"first blocking element: {kind} on "
                       f"{element_label(fld, mask)} vs "
                       f"{instances[dep[0]].label}")
        else:
            conds["closure"] = (True, "independent of every other "
                                      "instance (persistent singleton)")

        vis = []
        blockers = set()
        for name, reads in read_sets.items():
            clash = _mask_overlap(inst.writes, reads)
            if clash:
                blockers.add(name)
                vis.extend(element_label(f, m) for f, m in clash)
        if vis:
            conds["visibility"] = (
                False, f"writes {', '.join(sorted(set(vis)))} read by "
                       f"checked predicate(s) {', '.join(sorted(blockers))}")
        else:
            conds["visibility"] = (True, "writes invisible to every "
                                         "checked predicate")

        graph, params_arrays = kernels[inst.family]
        row = tuple(int(np.asarray(p)[g - dims.family_offsets[
            dims.family_names.index(inst.family)]])
            for p in params_arrays)
        key = (inst.family, row)
        if key not in proviso_cache:
            proviso_cache[key] = self_disabling(graph, row, env, cache)
        proved, _notes = proviso_cache[key]
        conds["proviso"] = (
            (True, "guard proved false on own successors "
                   "(self-disabling)") if proved else
            (False, "cannot prove the guard false on the instance's own "
                    "successors — an ample chain could ignore deferred "
                    "actions"))
        certs.append(Certificate(grid_index=g, family=inst.family,
                                 label=inst.label, conditions=conds))
    return certs


def _verify_certified(certs, summary, read_sets, dims,
                      bounds) -> List[Finding]:
    """Defense-in-depth re-check of every CERTIFIED instance against the
    raw inputs: C1 straight off the dependence matrix, C2 off the
    predicate read sets, and C3 by re-running the self-disabling proof
    with the instance parameters re-derived through ``instance_info``
    (independent of ``_build_certificates``' offset arithmetic and its
    memoization).
    Any failure is an ERROR — the pass then exits nonzero rather than
    emitting a table whose side conditions do not hold."""
    findings = []
    G = len(summary.instances)
    if any(c.ample for c in certs):
        env = _envelope_intervals(dims, bounds)
        kernels = {name: graph
                   for name, graph, _p in traced_kernels(dims)}
    for cert in certs:
        if not cert.ample:
            continue
        g = cert.grid_index
        fam_code, params = dims.instance_info(g)
        row = tuple(params.values())
        proviso_ok, _n = self_disabling(
            kernels[dims.family_names[fam_code]], row, env)
        visible = any(_mask_overlap(summary.instances[g].writes, reads)
                      for reads in read_sets.values())
        ok = int(summary.independent[g].sum()) == G - 1 \
            and not visible \
            and proviso_ok
        if not ok:
            findings.append(Finding(
                PASS, ERROR, "certificate-unsound",
                witness=cert.label,
                message=f"certificate for {cert.label} fails re-"
                        "verification against the dependence matrix / "
                        "predicate read sets / proviso proof — refusing "
                        "to emit the reduction table"))
    return findings


def analyze(dims, bounds=None, invariant_names=None, invariants=None,
            constraint=None, effect_summary=None, init_states=None,
            refute=True, provisos=None) -> Tuple[dict, List[Finding]]:
    """Run the POR pass.  Returns ``(summary_json, findings)``; the
    packed table rides in ``summary_json["table"]``.

    ``invariants`` (name -> kernel dict) takes precedence over
    ``invariant_names`` (registry lookup; None = the conservative full
    suite); ``constraint`` is the evaluated CONSTRAINT kernel (falls
    back to one built from ``bounds``).  ``effect_summary`` reuses the
    effects pass's live result when both passes run in one invocation.
    ``init_states`` (PyStates) extend the probe pool of the closure
    refutation search; ``refute=False`` skips that search (pure
    trace-time analysis, e.g. for variant models without probe
    states).  ``provisos`` (a dict) keeps the proviso proofs for a
    later call on the same dims and bounds."""
    from ..models.invariants import CONSTRAINT_PREDICATE, \
        checkable_predicates
    from . import effects

    findings: List[Finding] = []
    if effect_summary is None:
        effect_summary, _eff_findings = effects.analyze(dims)

    if invariants is not None:
        predicates = list(invariants.items())
        if constraint is not None:
            predicates.append((CONSTRAINT_PREDICATE, constraint))
    else:
        predicates = checkable_predicates(
            dims, invariant_names=invariant_names, bounds=bounds,
            constraint=constraint)
    read_sets, notes = predicate_read_sets(dims, predicates)
    for note in notes:
        findings.append(Finding(
            PASS, INFO, "analysis-imprecision",
            message="predicate read-set extraction fell back to a "
                    f"conservative rule ({note}); read sets remain "
                    "sound but may over-approximate"))

    env_cache: Dict = {}
    certs = _build_certificates(dims, effect_summary, read_sets, bounds,
                                env_cache, provisos)
    findings.extend(_verify_certified(certs, effect_summary, read_sets,
                                      dims, bounds))

    # Closure refutation (machine-checked impossibility) for instances
    # the dependence matrix blocks on C1: concrete non-commutation
    # witnesses split "blocked by analyzer imprecision" (worklist) from
    # "blocked inherently" (no footprint precision can ever certify).
    refutations: Dict[str, ClosureRefutation] = {}
    blocked_closure = [c for c in certs if "closure" in c.blocking()]
    if refute and blocked_closure:
        from ..models.pystate import probe_states
        pool = list(init_states or []) + probe_states(dims)
        env = _envelope_intervals(dims, bounds)
        refutations = {r.label: r
                       for r in closure_refutations(dims, pool, env,
                                                    env_cache)}

    # Aggregate per family: one WARNING per widened family (conservative
    # toward full expansion), one INFO per certified family, one INFO
    # per family whose closure block is fully witnessed (impossible).
    by_family: Dict[str, List[Certificate]] = {}
    for c in certs:
        by_family.setdefault(c.family, []).append(c)
    fam_json = {}
    instances = effect_summary.instances
    by_label = {i.label: k for k, i in enumerate(instances)}
    for fam, group in by_family.items():
        n_cert = sum(c.ample for c in group)
        blocked: Dict[str, int] = {}
        for c in group:
            for cond in c.blocking():
                blocked[cond] = blocked.get(cond, 0) + 1
        fam_json[fam] = {"instances": len(group), "certified": n_cert,
                         "blocked_by": blocked}
        # Top blocking elements for the worklist rendering: count, per
        # (other family, element) pair, how many of this family's
        # dependence conflicts anchor there.
        triples: Dict[Tuple[str, str, str], int] = {}
        for c in group:
            g = by_label[c.label]
            ia = instances[g]
            for h in np.flatnonzero(~effect_summary.independent[g]):
                if h == g:
                    continue
                ib = instances[int(h)]
                for kind, fld, m in effects.conflict_elements(ia, ib):
                    key = (ib.family, element_label(fld, m), kind)
                    triples[key] = triples.get(key, 0) + 1
        fam_json[fam]["blocking_elements"] = [
            {"family": f, "element": e, "kind": k, "pairs": n}
            for (f, e, k), n in sorted(triples.items(),
                                       key=lambda kv: -kv[1])[:5]]
        if fam == "Receive" and refute and blocked.get("closure"):
            # The mtype/(i, j) case-split (the taint twin of bounds.py's
            # Receive split): every case's server-field writes are
            # row-local to that case's dest — machine-readable evidence
            # that the whole-field union is forced by reachable message
            # headers, not by analyzer widening.
            cases = effects.receive_case_effects(dims)
            server_rows = {f: s for f, s in
                           lane_map.field_shapes(dims).items()
                           if f not in ("msg", "msg_cnt")}
            row_local = 0
            for (_t, i, _j), fp in cases.items():
                rows = {int(r) for f, m in fp["writes"].items()
                        if f in server_rows for r in np.nonzero(m)[0]}
                row_local += rows <= {i}
            fam_json[fam]["case_split"] = {
                "slot": 0, "cases": len(cases),
                "server_writes_row_local": row_local,
                "example": {
                    f"mtype={t},i={i},j={j}":
                        sorted(element_label(f, m)
                               for f, m in fp["writes"].items())
                    for (t, i, j), fp in list(cases.items())[:1]},
            }
        if refutations:
            # Only closure-BLOCKED instances need (or can have) a
            # witness: a certified instance is independent of
            # everything, so no non-commutation witness exists and
            # counting it as "open" would mislabel a partially
            # certified family as precision worklist.
            rs = [refutations[c.label] for c in group
                  if "closure" in c.blocking()]
            fam_json[fam]["closure_refutation"] = {
                "witnessed": sum(r.status == "witnessed" for r in rs),
                "vacuous": sum(r.status == "vacuous" for r in rs),
                "open": [r.label for r in rs if r.status == "open"],
                "witnesses": [r.to_json() for r in rs
                              if r.status == "witnessed"][:3],
            }
        if n_cert == len(group):
            findings.append(Finding(
                PASS, INFO, "por-certified", field=fam,
                message=f"all {len(group)} instance(s) of {fam} carry a "
                        "proved ample certificate",
                details={"instances": len(group)}))
        else:
            first = next(c for c in group if not c.ample)
            cond = first.blocking()[0]
            findings.append(Finding(
                PASS, WARNING, "por-widened", field=fam,
                witness=first.label,
                message=f"{fam}: {len(group) - n_cert}/{len(group)} "
                        f"instance(s) widened to full expansion — "
                        f"{cond} unproved: "
                        f"{first.conditions[cond][1]}",
                details={"blocked_by": blocked}))
        if refutations and blocked.get("closure"):
            ref = fam_json[fam]["closure_refutation"]
            if not ref["open"]:
                wit = ref["witnesses"][0] if ref["witnesses"] else None
                findings.append(Finding(
                    PASS, INFO, "por-impossible", field=fam,
                    witness=wit["label"] if wit else None,
                    message=f"{fam}: the closure block is INHERENT, not "
                            "analyzer imprecision — every instance has "
                            "a concrete two-action non-commutation "
                            "witness (or a proof it can never execute)"
                            + (f"; e.g. {wit['label']} vs "
                               f"{wit['conflicts_with']} "
                               f"({wit['kind']})" if wit else ""),
                    details=ref))

    mask = np.array([c.ample for c in certs], bool)
    priority = np.arange(len(certs), dtype=np.int32)
    table = PorTable(model=repr(dims), n_instances=len(certs),
                     ample_mask=mask, priority=priority,
                     predicates=tuple(name for name, _k in predicates))
    summary = {
        "n_instances": len(certs),
        "certified": table.certified,
        "predicates": {name: sorted(fields)
                       for name, fields in read_sets.items()},
        "predicate_elements": {
            name: {f: int(m.sum()) for f, m in fields.items()}
            for name, fields in read_sets.items()},
        "families": fam_json,
        "closure_refutation": _refutation_totals(certs, refutations),
        "table": table.to_json(),
    }
    return summary, findings


def _refutation_totals(certs, refutations) -> dict:
    """Top-level witness-search tally over the closure-BLOCKED
    instances only (certified instances have no witness to find)."""
    rs = [refutations[c.label] for c in certs
          if refutations and "closure" in c.blocking()]
    return {
        "ran": bool(refutations),
        "witnessed": sum(r.status == "witnessed" for r in rs),
        "vacuous": sum(r.status == "vacuous" for r in rs),
        "open": sorted(r.label for r in rs if r.status == "open"),
    }


@functools.lru_cache(maxsize=4)
def _model_proofs(dims, bounds):
    """``(effect summary, proviso proofs)`` of one model: the parts of a
    certification that depend on its dims and bounds alone, and most of
    its time.  Kept so that a repeat build of the same model (a served
    ``"por": true`` job, a degradation rebuild) re-derives only the
    predicate read sets; tests drop it with ``cache_clear()``."""
    from . import effects
    summary, _findings = effects.analyze(dims)
    return summary, {}


def build_table(dims, bounds=None, invariant_names=None, invariants=None,
                constraint=None) -> PorTable:
    """One-call table construction (the engine's ``por=True`` path).
    Raises if any certificate fails its side conditions — the same gate
    as the CLI's nonzero exit."""
    effect_summary, provisos = _model_proofs(dims, bounds)
    summary, findings = analyze(
        dims, bounds=bounds, invariant_names=invariant_names,
        invariants=invariants, constraint=constraint,
        effect_summary=effect_summary, provisos=provisos,
        # The witness search classifies blocked instances but never
        # changes the mask — skip it on the engine-construction path.
        refute=False)
    errors = [f for f in findings if f.severity == ERROR]
    if errors:
        raise ValueError(f"POR certification failed: {errors[0].message}")
    return PorTable.from_json(summary["table"])
