"""Effect extraction: per-action read/write sets from the kernel graphs.

Each v1 action-family kernel is traced once to an aten graph
(``interp.trace_family``) and re-evaluated per instance under the taint
domain with that instance's concrete parameters.  The result, per action instance, is ELEMENT-WISE
(slot/column-granular) since the taint domain tracks per-element
dependency masks:

- ``guard_reads`` — per field, the element mask the ``enabled``
  predicate may depend on;
- ``reads``      — per field, the element mask any non-identity output
  depends on (guards, overflow, and every written field's new value —
  identity pass-through of an unchanged lane is NOT a read);
- ``writes``     — per written field, the element-wise mask of lanes
  that can differ from the parent state (exact down to the instance's
  own server row where the kernel's index masks are parameter-concrete;
  conservatively whole-field where the write target is state-dependent,
  e.g. ``Receive``'s reply-slot allocation scan).

From these the pass derives the action dependence matrix (instances
whose effects provably commute at ELEMENT granularity), the provably
independent guard/effect pairs POR-style optimizations need, and the
dead-lane check (state elements no action ever writes).  Everything is
sound w.r.t. the traced kernels: an unhandled primitive degrades to
"may read/write everything it touched" and is reported, never dropped.
Masks are over the fields' own shapes (the traced graphs carry one
parent row; its axis is dropped here).

The per-instance footprints are serialized into the analyze report as a
VERSIONED hex encoding (``FOOTPRINTS_VERSION``); POR/BLEST tooling
decodes them with :func:`footprints_from_json` instead of re-tracing.
The encoding is the JAX package's (``analysis/effects.py``): a summary
either package wrote decodes in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Tuple

import numpy as np

from . import lane_map
from .interp import (Taint, TaintDomain, _dunion, eval_graph, param_args,
                     read_mask, state_taint, traced_kernels)
from .report import Finding, INFO, WARNING

PASS = "effects"

#: Version of the serialized per-instance footprint encoding in
#: ``summary_json`` (bumped when the mask semantics or packing change;
#: consumers reject a mismatch instead of misreading slot masks).
FOOTPRINTS_VERSION = 2

Masks = Dict[str, np.ndarray]           # field -> bool mask (field shape)


@dataclasses.dataclass
class InstanceEffect:
    grid_index: int
    family: str
    label: str
    guard_reads: Masks
    reads: Masks
    writes: Masks

    @property
    def write_fields(self) -> FrozenSet[str]:
        return frozenset(self.writes)

    @property
    def read_fields(self) -> FrozenSet[str]:
        return frozenset(self.reads)

    @property
    def guard_read_fields(self) -> FrozenSet[str]:
        return frozenset(self.guard_reads)


@dataclasses.dataclass
class EffectSummary:
    instances: List[InstanceEffect]
    #: family -> {"reads", "writes", "guard_reads"} field-name sets
    #: (the coarse view; element masks live on the instances).
    families: Dict[str, Dict[str, FrozenSet[str]]]
    #: [G, G] bool — True where the two instances provably commute at
    #: element granularity (element-disjoint writes, and neither writes
    #: an element the other reads).
    independent: np.ndarray
    #: [G, G] bool — True where neither instance writes an element the
    #: other's GUARD reads (enabledness commutes; the weaker relation
    #: partial-order reduction needs).
    guard_independent: np.ndarray
    #: field -> bool mask of elements written by no action instance.
    dead_lanes: Dict[str, np.ndarray]


def _state_taints(dims) -> List[Taint]:
    """The 13 state inputs of one parent row (traced shapes)."""
    shapes = lane_map.field_shapes(dims)
    return [state_taint(f, (1,) + shapes[f]) for f in lane_map.FIELDS]


def _strip(masks: Masks) -> Masks:
    """Traced (one-row) masks -> masks over the fields' own shapes."""
    return {f: m.reshape(m.shape[1:]) for f, m in masks.items()}


def _write_reads(out: Taint, changed: np.ndarray) -> Masks:
    """Element-wise reads that determine a written field's new value and
    where it lands: the value-level half in full, the positional half
    only at the CHANGED positions — identity pass-through of an
    untouched lane is not a read (the distinction the lint self-check
    draws syntactically)."""
    pos = {}
    for f, m in out.pdeps.items():
        pos[f] = (m & changed) if m.shape == changed.shape else m
    return _dunion(out.vdeps, pos)


def _extract_effect(outs) -> Dict[str, Masks]:
    """(guard_reads, reads, writes) element masks from one kernel
    evaluation's outputs — THE extraction rule, shared by the
    per-instance pass and the Receive case-split so the two can never
    drift apart."""
    en, ovf = outs[0], outs[1]
    writes: Masks = {}
    reads = _dunion(read_mask(en), read_mask(ovf))
    for f, out in zip(lane_map.FIELDS, outs[2:]):
        mask = out.diff if out.origin == f else np.ones(out.shape, bool)
        if mask.any():
            writes[f] = mask
            reads = _dunion(reads, _write_reads(out, mask))
    return {"guard_reads": _strip(read_mask(en)), "reads": _strip(reads),
            "writes": _strip(writes)}


def _instance_effect(dims, domain, state, graph, name, g, params_row
                     ) -> InstanceEffect:
    args = state + param_args(params_row)
    eff = _extract_effect(eval_graph(graph, args, domain))
    return InstanceEffect(
        grid_index=g, family=name, label=dims.describe_instance(g),
        guard_reads=eff["guard_reads"], reads=eff["reads"],
        writes=eff["writes"])


def analyze(dims) -> Tuple[EffectSummary, List[Finding]]:
    """Run effect extraction over the full action-instance grid."""
    kernels = traced_kernels(dims)
    assert tuple(k[0] for k in kernels) == dims.family_names
    findings: List[Finding] = []
    domain = TaintDomain()
    state = _state_taints(dims)
    instances: List[InstanceEffect] = []

    for (name, graph, params), off in zip(kernels, dims.family_offsets):
        grids = np.stack([np.asarray(p) for p in params], axis=-1) \
            if params else np.zeros((1, 0), np.int64)
        for k in range(grids.shape[0]):
            instances.append(_instance_effect(
                dims, domain, state, graph, name, off + k, grids[k]))

    families: Dict[str, Dict[str, FrozenSet[str]]] = {}
    for inst in instances:
        fam = families.setdefault(
            inst.family, {"reads": frozenset(), "writes": frozenset(),
                          "guard_reads": frozenset()})
        fam["reads"] |= inst.read_fields
        fam["writes"] |= inst.write_fields
        fam["guard_reads"] |= inst.guard_read_fields

    independent, guard_independent = _dependence_matrices(instances)
    dead = _dead_lanes(dims, instances)
    for f, mask in dead.items():
        if mask.all():
            findings.append(Finding(
                PASS, WARNING, "dead-field", field=f,
                message=f"state field {f!r} is written by no action "
                        "instance — a dead lane in the packed encoding"))
        elif mask.any():
            findings.append(Finding(
                PASS, INFO, "dead-lanes", field=f,
                message=f"{int(mask.sum())}/{mask.size} elements of "
                        f"field {f!r} are written by no action instance",
                details={"unwritten": int(mask.sum())}))
    for note in domain.notes:
        findings.append(Finding(
            PASS, INFO, "analysis-imprecision",
            message=f"taint analysis fell back to a conservative rule "
                    f"({note}); read/write sets remain sound but may "
                    "over-approximate"))
    return (EffectSummary(instances=instances, families=families,
                          independent=independent,
                          guard_independent=guard_independent,
                          dead_lanes=dead),
            findings)


# ---------------------------------------------------------------------------
# Receive case-split (the taint twin of the bounds pass's per-type split)


def receive_case_effects(dims, slot: int = 0) -> Dict[Tuple[int, int, int],
                                                      Dict[str, Masks]]:
    """Per-(mtype, dest ``i``, source ``j``) footprints of ``Receive`` on
    one slot: re-evaluates the traced kernel with the slot's message
    HEADER columns (type / source / dest — ``lane_map.msg_col_name``
    0..2) pinned to the case, the same split ``bounds.py`` applies via
    ``lane_map.msg_type_domains``.  Each case's server-field footprint
    is row-local to its ``i`` (that is the slot-local write mask the POR
    worklist asks for), and the union over cases reproduces the
    instance's conservative whole-field footprint — which is the
    machine-readable explanation of WHY the union cannot shrink: the
    header columns are state, so every (mtype, i, j) case is reachable
    for any slot content."""
    kernels = {name: (graph, params)
               for name, graph, params in traced_kernels(dims)}
    graph, _params = kernels["Receive"]
    n = dims.n_servers
    n_types = len(lane_map.msg_type_domains(dims))
    out: Dict[Tuple[int, int, int], Dict[str, Masks]] = {}
    for t in range(n_types):
        for i in range(n):
            for j in range(n):
                state = _state_taints(dims)
                mi = lane_map.FIELDS.index("msg")
                m = state[mi]
                lo, hi = m.lo.copy(), m.hi.copy()
                # Case assumption: the header equals these constants
                # (and still equals the input field — diff stays False).
                for col, v in ((0, t + 1), (1, j + 1), (2, i + 1)):
                    lo[0, slot, col] = hi[0, slot, col] = v
                state[mi] = Taint(m.vdeps, m.pdeps, m.origin, m.diff,
                                  lo, hi, m.dtype)
                domain = TaintDomain()
                args = state + param_args([slot])
                out[(t, i, j)] = _extract_effect(
                    eval_graph(graph, args, domain))
    return out


# ---------------------------------------------------------------------------
# Dependence matrices


def conflict_elements(ia: InstanceEffect, ib: InstanceEffect
                      ) -> List[Tuple[str, str, np.ndarray]]:
    """The element-level evidence that two instances do NOT commute:
    ``[(kind, field, mask), ...]`` with kind in ``write/write``,
    ``write/read`` (a writes what b reads) and ``read/write``."""
    out: List[Tuple[str, str, np.ndarray]] = []
    for f, m in ia.writes.items():
        mb = ib.writes.get(f)
        if mb is not None and bool((m & mb).any()):
            out.append(("write/write", f, m & mb))
        rb = ib.reads.get(f)
        if rb is not None and bool((m & rb).any()):
            out.append(("write/read", f, m & rb))
    for f, m in ib.writes.items():
        ra = ia.reads.get(f)
        if ra is not None and bool((m & ra).any()):
            out.append(("read/write", f, m & ra))
    return out


def _dependence_matrices(instances) -> Tuple[np.ndarray, np.ndarray]:
    G = len(instances)
    indep = np.zeros((G, G), bool)
    gindep = np.zeros((G, G), bool)

    def _overlap(wa: Masks, rb: Masks) -> bool:
        for f, m in wa.items():
            mb = rb.get(f)
            if mb is not None and bool((m & mb).any()):
                return True
        return False

    for a in range(G):
        ia = instances[a]
        for b in range(a, G):
            ib = instances[b]
            # Full independence at element granularity: element-disjoint
            # writes AND neither writes an element the other reads.
            ok = not (_overlap(ia.writes, ib.writes)
                      or _overlap(ia.writes, ib.reads)
                      or _overlap(ib.writes, ia.reads))
            indep[a, b] = indep[b, a] = ok and a != b
            gok = not (_overlap(ia.writes, ib.guard_reads)
                       or _overlap(ib.writes, ia.guard_reads))
            gindep[a, b] = gindep[b, a] = gok and a != b
    return indep, gindep


def _dead_lanes(dims, instances) -> Dict[str, np.ndarray]:
    shapes = lane_map.field_shapes(dims)
    written = {f: np.zeros(shapes[f], bool) for f in lane_map.FIELDS}
    for inst in instances:
        for f, m in inst.writes.items():
            written[f] |= m
    return {f: ~w for f, w in written.items()}


# ---------------------------------------------------------------------------
# Serialization


def _pack_matrix_hex(mat: np.ndarray) -> List[str]:
    """[G,G] bool -> one hex bitmask string per row (bit h = column h).
    Stable, compact serialization for the analyze report — the POR pass
    and future BLEST-style batching consume this artifact instead of
    re-tracing the kernels."""
    out = []
    for row in np.asarray(mat, bool):
        out.append(_pack_mask_hex(row))
    return out


def _pack_mask_hex(mask: np.ndarray) -> str:
    """Flattened (row-major) bool mask -> hex bitmask (bit k = element
    k of the C-ordered flattening)."""
    v = 0
    for k in np.flatnonzero(np.asarray(mask, bool).reshape(-1)):
        v |= 1 << int(k)
    return format(v, "x")


def _unpack_mask_hex(hexmask: str, shape) -> np.ndarray:
    flat = np.zeros(int(np.prod(shape)) if shape else 1, bool)
    v = int(hexmask, 16)
    while v:
        k = v.bit_length() - 1
        flat[k] = True
        v &= ~(1 << k)
    return flat.reshape(shape)


def _unpack_matrix_hex(rows: List[str], G: int) -> np.ndarray:
    mat = np.zeros((G, G), bool)
    for g, hexrow in enumerate(rows):
        mat[g] = _unpack_mask_hex(hexrow, (G,))
    return mat


def matrices_from_json(summary: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(independent, guard_independent) matrices from a serialized
    effects report (``summary_json`` output) — the stable consumer-side
    decoder for POR/BLEST tooling.  Rejects a report whose footprint
    encoding version is unknown (slot-level masks would be misread)."""
    ver = summary.get("footprints_version")
    if ver is not None and ver != FOOTPRINTS_VERSION:
        raise ValueError(
            f"effects report footprint encoding v{ver} != supported "
            f"v{FOOTPRINTS_VERSION}; regenerate with "
            "`analyze --passes effects`")
    G = summary["n_instances"]
    return (_unpack_matrix_hex(summary["independent_hex"], G),
            _unpack_matrix_hex(summary["guard_independent_hex"], G))


def footprints_from_json(summary: dict) -> List[Dict[str, Masks]]:
    """Per-instance element footprints (reads/writes/guard_reads masks)
    from a serialized effects report.  Requires the versioned slot-level
    encoding (``footprints_version`` >= 2) — a field-granular legacy
    report has no element masks to decode."""
    ver = summary.get("footprints_version")
    if ver != FOOTPRINTS_VERSION:
        raise ValueError(
            f"effects report carries footprint encoding v{ver}, need "
            f"v{FOOTPRINTS_VERSION} (slot-level masks); regenerate with "
            "`analyze --passes effects`")
    shapes = {f: tuple(s) for f, s in summary["field_shapes"].items()}
    out: List[Dict[str, Masks]] = []
    for fp in summary["footprints"]:
        out.append({kind: {f: _unpack_mask_hex(h, shapes[f])
                           for f, h in fp[kind].items()}
                    for kind in ("reads", "writes", "guard_reads")})
    return out


def summary_json(summary: EffectSummary) -> dict:
    """Compact JSON view: per-family sets, matrix statistics, the
    family-level independent pairs, the full per-instance dependence /
    guard-independence matrices (hex row bitmasks + instance labels —
    decode with :func:`matrices_from_json`) and the versioned
    per-instance element footprints (:func:`footprints_from_json`)."""
    fams = {name: {k: sorted(v) for k, v in d.items()}
            for name, d in summary.families.items()}
    G = len(summary.instances)
    pairs = G * (G - 1) // 2
    fam_of = [i.family for i in summary.instances]
    fam_names = sorted({f for f in fam_of})
    fam_indep = []
    for i, fa in enumerate(fam_names):
        for fb in fam_names[i:]:
            idx_a = [k for k, f in enumerate(fam_of) if f == fa]
            idx_b = [k for k, f in enumerate(fam_of) if f == fb]
            sub = summary.independent[np.ix_(idx_a, idx_b)]
            if fa == fb:
                if len(idx_a) > 1 and bool(
                        sub[~np.eye(len(idx_a), dtype=bool)].all()):
                    fam_indep.append([fa, fb])
            elif bool(sub.all()):
                fam_indep.append([fa, fb])
    shapes = {}
    for inst in summary.instances:
        for masks in (inst.reads, inst.writes, inst.guard_reads):
            for f, m in masks.items():
                shapes[f] = list(m.shape)
    return {
        "n_instances": G,
        "families": fams,
        "instances": [i.label for i in summary.instances],
        "independent_hex": _pack_matrix_hex(summary.independent),
        "guard_independent_hex": _pack_matrix_hex(
            summary.guard_independent),
        "independent_pairs": int(np.triu(summary.independent, 1).sum()),
        "guard_independent_pairs": int(
            np.triu(summary.guard_independent, 1).sum()),
        "total_pairs": pairs,
        "independent_family_pairs": fam_indep,
        "footprints_version": FOOTPRINTS_VERSION,
        "field_shapes": shapes,
        "footprints": [
            {"reads": {f: _pack_mask_hex(m)
                       for f, m in inst.reads.items()},
             "writes": {f: _pack_mask_hex(m)
                        for f, m in inst.writes.items()},
             "guard_reads": {f: _pack_mask_hex(m)
                             for f, m in inst.guard_reads.items()}}
            for inst in summary.instances],
        "dead_lane_counts": {f: int(m.sum())
                             for f, m in summary.dead_lanes.items()
                             if m.any()},
    }
