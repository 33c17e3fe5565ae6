"""Interval bound analysis: trace-time proofs of packed-lane safety.

The lane audit (``models/dims.py``) checks *declared* domain maxima at
construction and ``schema.pack_ok`` stops a run when a runtime-growing
value outgrows its lane.  This pass closes the gap between the two: it
abstract-interprets every v1 action kernel's aten graph over
element-wise integer intervals (``interp.IntervalDomain``),
iterates reachable per-field intervals to a fixpoint under the model's
constraints, and checks every action's *successor* intervals against
the packed-lane capacities (``lane_map.lane_capacities``) — so a lane
that can overflow is reported at ``analyze`` time with a named witness
action instead of at depth 40 of a run on the card.

Method notes (all surfaced in the report, never silently assumed):

- The abstract state is reduced by the model's server/slot symmetry
  (one interval per field element class: per message column, per log
  lane, scalar for server-indexed fields) and only representative
  instances are evaluated — sound because the kernels are equivariant
  under server/slot permutation and the reduced state is permutation-
  invariant by construction.
- ``Receive`` is case-split on the received message's type using the
  declared per-type payload domains (``lane_map.msg_type_domains``):
  payload columns are unions (mmatchIndex shares column 5 with
  mprevLogTerm), and without the split a term bound smears into index
  arithmetic and nothing converges.
- Fields whose interval has not converged after ``watch_rounds``
  (unbounded growth like ``term``; the nextIndex/mmatchIndex exchange
  cycle, which provably has no finite non-relational invariant) are
  widened to the declared domain envelope (``lane_map.field_domains``)
  and reported; a field whose one-step image then still escapes the
  envelope yields an INFO "not inductive" note rather than a silent
  clamp.
- Severity: a lane overflow is an ERROR when it is silent-corruption
  class (no runtime guard) or when the cfg's own CONSTRAINT bounds
  admit it (e.g. ``MaxTerm = 300`` — every run would hard-stop on the
  pack guard); unbounded pack-guarded growth without a constraint is a
  WARNING (the runtime guard turns it into a clean abort).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import lane_map
import torch

from .interp import (IntervalDomain, _ival, eval_graph, param_args,
                     traced_kernels)
from .report import ERROR, Finding, INFO, WARNING

PASS = "bounds"
_I64 = np.int64

#: Reduced abstract-state shapes: intervals per symmetry class.
_REDUCED_AXES = {  # field -> axes of the full shape joined away
    "term": (0,), "role": (0,), "voted_for": (0,), "log_len": (0,),
    "commit": (0,), "votes_resp": (0,), "votes_gran": (0,),
    "log_term": (0,), "log_val": (0,),
    "next_idx": (0, 1), "match_idx": (0, 1),
    "msg": (0,), "msg_cnt": (0,),
}


@dataclasses.dataclass
class BoundsResult:
    intervals: Dict[str, Tuple[np.ndarray, np.ndarray]]   # reduced (lo, hi)
    rounds: int
    widened: List[str]
    converged: bool


def _reduce(field: str, lo: np.ndarray, hi: np.ndarray):
    ax = _REDUCED_AXES[field]
    return lo.min(axis=ax), hi.max(axis=ax)


def _reduced_shape(field: str, dims) -> tuple:
    shp = lane_map.field_shapes(dims)[field]
    ax = _REDUCED_AXES[field]
    return tuple(d for i, d in enumerate(shp) if i not in ax)


def _expand_field(field: str, lo, hi, shapes):
    shp = shapes[field]
    if field in ("msg",):
        return (np.broadcast_to(lo[None, :], shp),
                np.broadcast_to(hi[None, :], shp))
    if field in ("log_term", "log_val"):
        return (np.broadcast_to(lo[None, :], shp),
                np.broadcast_to(hi[None, :], shp))
    return np.broadcast_to(lo, shp), np.broadcast_to(hi, shp)


def _join(a, b):
    return np.minimum(a[0], b[0]), np.maximum(a[1], b[1])


def _clamp(lo, hi, c_lo, c_hi):
    """Intersect an interval with a clamp window, keeping it non-empty
    (an empty intersection collapses to the nearer clamp bound — the
    conservative direction for a reachability envelope)."""
    lo2 = np.clip(lo, c_lo, c_hi)
    hi2 = np.clip(hi, c_lo, c_hi)
    return np.minimum(lo2, hi2), np.maximum(lo2, hi2)


def _seed_state(dims, init_states) -> Dict[str, Tuple]:
    """Reduced intervals joining the (concrete) initial states; falls
    back to the declared domain envelope when roots are unavailable or
    randomized (smoke configs)."""
    from ..models.schema import encode_state
    if not init_states:
        dom = lane_map.field_domains(dims)
        return {f: (np.broadcast_to(np.asarray(dom[f][0], _I64),
                                    _reduced_shape(f, dims)).copy(),
                    np.broadcast_to(np.asarray(dom[f][1], _I64),
                                    _reduced_shape(f, dims)).copy())
                for f in lane_map.FIELDS}
    state = None
    for s in init_states:
        enc = encode_state(s, dims)
        red = {}
        for f in lane_map.FIELDS:
            arr = np.asarray(getattr(enc, f), _I64)
            red[f] = _reduce(f, arr, arr)
        state = red if state is None else {
            f: _join(state[f], red[f]) for f in lane_map.FIELDS}
    return state


def _rep_instances(dims, max_extra: int = 16):
    """Representative (family, k) instances: one per symmetry class of
    the base grid (plus all-v for ClientRequest and both i==j / i!=j
    for the (i,j) families); every instance of variant extras, capped."""
    n, v = dims.n_servers, dims.n_values
    reps: List[Tuple[int, int]] = []
    truncated = []
    for fi, name in enumerate(dims.family_names):
        size = dims.family_sizes[fi]
        if fi in (2, 6):                    # RequestVote / AppendEntries
            ks = [0, 1] if n > 1 else [0]   # (i=0,j=0) and (i=0,j=1)
        elif fi == 4:                       # ClientRequest: all values
            ks = list(range(min(v, size)))
        elif fi < 10:                       # other base families
            ks = [0]
        else:                               # variant extras
            ks = list(range(min(size, max_extra)))
            if size > max_extra:
                truncated.append(name)
        reps.extend((fi, k) for k in ks)
    return reps, truncated


def _param_values(params, k: int) -> List[np.ndarray]:
    return [np.asarray(p)[k].astype(np.int64) for p in params]


def analyze(dims, bounds=None, init_states=None,
            lane_caps: Optional[Dict] = None,
            max_rounds: int = 64, watch_rounds: int = 12
            ) -> Tuple[dict, List[Finding]]:
    """Run the fixpoint and the lane checks.  ``lane_caps`` overrides
    ``lane_map.lane_capacities(dims)`` (tests shrink a lane with it).
    Returns (summary dict, findings)."""
    kernels = traced_kernels(dims)
    findings: List[Finding] = []
    caps = dict(lane_map.lane_capacities(dims))
    if lane_caps:
        # Scalar overrides broadcast to the reference capacity's shape —
        # 'msg' capacities are per-column [W] arrays and _check_lane
        # indexes them by column, so a bare (0, HI) must fan out to W.
        for f, (olo, ohi) in lane_caps.items():
            ref_lo, ref_hi = caps[f]
            caps[f] = (np.broadcast_to(np.asarray(olo, _I64),
                                       np.shape(ref_lo)),
                       np.broadcast_to(np.asarray(ohi, _I64),
                                       np.shape(ref_hi)))
    shapes = lane_map.field_shapes(dims)
    domain = IntervalDomain()
    dom_env = lane_map.field_domains(dims)
    cons = lane_map.constraint_bounds(dims, bounds)
    type_doms = lane_map.msg_type_domains(dims)

    graphs = {}
    for (name, graph, params), off in zip(kernels, dims.family_offsets):
        graphs[name] = (graph, params, off)
    reps, truncated = _rep_instances(dims)
    for name in truncated:
        findings.append(Finding(
            PASS, INFO, "instances-truncated",
            message=f"variant family {name!r} analyzed on the first 16 "
                    "instances only"))

    state = _seed_state(dims, init_states)
    widened: List[str] = []
    memo: Dict = {}         # parameter-only nodes, once per instance

    def input_intervals(st) -> Dict[str, Tuple]:
        out = {}
        for f in lane_map.FIELDS:
            lo, hi = st[f]
            if f in widened:
                lo, hi = _clamp(lo, hi, *dom_env[f])
            if f in cons:
                lo, hi = _clamp(lo, hi, *cons[f])
            out[f] = (lo, hi)
        return out

    def eval_rep(fi, k, inp, msg_override=None):
        """Evaluate one representative instance on reduced input
        intervals; returns (enabled, succ field intervals) or None."""
        name = dims.family_names[fi]
        graph, params, _off = graphs[name]
        args = []
        for f in lane_map.FIELDS:
            lo, hi = _expand_field(f, *inp[f], shapes)
            if f == "msg" and msg_override is not None:
                lo = np.array(lo)
                hi = np.array(hi)
                lo[0], hi[0] = msg_override
            # One parent row: the traced graphs' leading axis.
            args.append(_ival(lo[None], hi[None], torch.int64))
        args += param_args(_param_values(params, k))
        outs = eval_graph(graph, args, domain, memo=memo,
                          n_state=len(lane_map.FIELDS))
        en = outs[0]
        if int(en.hi.max()) == 0:
            return None                      # provably disabled
        return en, [_ival(v.lo[0], v.hi[0], v.dtype) for v in outs[2:]]

    def successors(inp):
        """All (label, {field: (lo, hi) reduced}) for the reps, with the
        Receive type split applied."""
        out = []
        for fi, k in reps:
            name = dims.family_names[fi]
            off = graphs[name][2]
            label = dims.describe_instance(off + k)
            if name == "Receive":
                m_lo, m_hi = inp["msg"]
                for t, (t_lo, t_hi) in enumerate(type_doms):
                    if m_hi[0] < t + 1 or m_lo[0] > t + 1:
                        continue             # no such message in flight
                    row = _clamp(m_lo, m_hi, t_lo, t_hi)
                    r = eval_rep(fi, k, inp, msg_override=row)
                    if r is not None:
                        out.append((f"{label}[mtype={t}]", r[1]))
            else:
                r = eval_rep(fi, k, inp)
                if r is not None:
                    out.append((label, r[1]))
        return out

    rounds = 0
    converged = False
    while rounds < max_rounds:
        rounds += 1
        inp = input_intervals(state)
        new_state = {f: (state[f][0].copy(), state[f][1].copy())
                     for f in lane_map.FIELDS}
        for _label, succ in successors(inp):
            for f, val in zip(lane_map.FIELDS, succ):
                red = _reduce(f, val.lo, val.hi)
                new_state[f] = _join(new_state[f], red)
        # A widened field's STATE jumps straight to the declared envelope
        # (classic widening-to-top over the declared domain): clamping
        # alone would let a +1-per-round lane (term) crawl toward 255 one
        # fixpoint round at a time and never converge.  One-step escapes
        # beyond the envelope are surfaced by the not-inductive check in
        # the final round, never silently swallowed.
        for f in widened:
            shp = _reduced_shape(f, dims)
            new_state[f] = (
                np.broadcast_to(np.asarray(dom_env[f][0], _I64), shp).copy(),
                np.broadcast_to(np.asarray(dom_env[f][1], _I64), shp).copy())
        changed = [f for f in lane_map.FIELDS
                   if not (np.array_equal(new_state[f][0], state[f][0])
                           and np.array_equal(new_state[f][1],
                                              state[f][1]))]
        state = new_state
        if not changed:
            converged = True
            break
        if rounds >= watch_rounds:
            for f in changed:
                if f not in widened:
                    widened.append(f)

    for f in sorted(widened):
        findings.append(Finding(
            PASS, INFO, "widened", field=f,
            message=f"interval for field {f!r} did not converge in "
                    f"{watch_rounds} rounds; widened to the declared "
                    f"domain envelope {_env_str(dom_env[f])}"))
    if not converged:
        findings.append(Finding(
            PASS, ERROR, "no-fixpoint",
            message=f"interval fixpoint not reached in {max_rounds} "
                    "rounds even after widening — analysis defect, "
                    "bounds unproven"))

    # -- final check round: every rep's successor vs lane capacity ----
    # The check asks the operative question: starting from any state that
    # FITS the packed lanes (input intersected with the capacities), which
    # action's one-step image escapes them?  That names the *raising*
    # action as the witness (Timeout for a shrunken term lane, not
    # whichever family happens to come first carrying an already-
    # overflowed parent value).  Per-lane policy:
    #
    # - GROWTH lanes (term/log_term/msg_cnt and the term-carrying message
    #   columns) keep their raw HIGH side — growth past the lane is the
    #   finding, graded WARNING/ERROR by _check_lane's guard/cfg logic;
    # - every other lane's image is intersected with the declared domain
    #   envelope: a one-step escape there is guard imprecision the
    #   interval domain cannot resolve, reported as a not-inductive INFO
    #   (so a wrong field_domains entry is surfaced, never trusted
    #   silently), while an envelope that itself exceeds the lane still
    #   flags as the real overflow it is;
    # - LOW sides are floored at the envelope on all lanes: the packed
    #   fields are unsigned (column 4 excepted, its envelope says so) and
    #   negative lows only arise from guarded-decrement imprecision.
    inp = input_intervals(state)
    chk_inp = {}
    for f in lane_map.FIELDS:
        c_lo, c_hi = caps[f]
        chk_inp[f] = _clamp(*inp[f], np.asarray(c_lo, _I64),
                            np.asarray(c_hi, _I64))
    W = dims.msg_width
    msg_growth = np.array([_growth_guarded("msg", c, dims)
                           for c in range(W)])
    reported = set()
    for label, succ in successors(chk_inp):
        for f, val in zip(lane_map.FIELDS, succ):
            red_lo, red_hi = _reduce(f, val.lo, val.hi)
            e_lo = np.asarray(dom_env[f][0], _I64)
            e_hi = np.asarray(dom_env[f][1], _I64)
            if (bool(np.any(red_lo < e_lo)) or bool(np.any(red_hi > e_hi))) \
                    and ("noninductive", f) not in reported:
                reported.add(("noninductive", f))
                findings.append(Finding(
                    PASS, INFO, "not-inductive", field=f,
                    witness=label,
                    message=f"one action step escapes the declared "
                            f"domain envelope of {f!r} "
                            f"({_env_str(dom_env[f])} -> "
                            f"{_env_str((red_lo, red_hi))}); excess "
                            "is within the packed lane, bounded by "
                            "guards the interval domain cannot see"))
            chk_lo = np.maximum(red_lo, np.broadcast_to(e_lo, red_lo.shape))
            if f == "msg":
                chk_hi = np.where(msg_growth, red_hi,
                                  np.minimum(red_hi, e_hi))
            elif _growth_guarded(f, None, dims):
                chk_hi = red_hi
            else:
                chk_hi = np.minimum(red_hi, np.broadcast_to(
                    e_hi, red_hi.shape))
            chk_lo = np.minimum(chk_lo, chk_hi)   # keep non-empty
            _check_lane(dims, bounds, f, chk_lo, chk_hi, caps, label,
                        reported, findings)
    for prim in sorted(set(domain.wraps)):
        findings.append(Finding(
            PASS, ERROR, "int32-wrap",
            message=f"kernel arithmetic ({prim}) can exceed the traced "
                    "integer dtype's range — silent wraparound on "
                    "device"))
    for note in sorted(set(domain.notes)):
        findings.append(Finding(
            PASS, INFO, "analysis-imprecision",
            message=f"interval analysis fell back to a conservative "
                    f"rule ({note})"))

    summary = {
        "rounds": rounds, "converged": converged,
        "widened": sorted(widened),
        "intervals": {f: _env_str(state[f]) for f in lane_map.FIELDS},
        "constraints": {f: _env_str(c) for f, c in cons.items()},
    }
    return summary, findings


def _env_str(pair) -> str:
    lo, hi = (np.asarray(pair[0], _I64), np.asarray(pair[1], _I64))
    if lo.ndim == 0 or lo.size == 1:
        return f"[{int(lo.min())}, {int(hi.max())}]"
    return (f"[{int(lo.min())}, {int(hi.max())}] "
            f"(per-lane hi: {hi.tolist()})")


def _guard_bound(field: str, col: Optional[int], dims) -> Optional[int]:
    """The runtime pack guard's bound for this growth lane (the value
    ``schema.pack_ok`` stops the run past), or None when the lane has
    no growth guard.  Per pack_ok (term/msg_cnt/mterm at
    255, the sign-extended column 4 at 127) plus the audit docstring's
    sender-mterm argument for the term-carrying payload columns."""
    if field in ("term", "log_term", "msg_cnt"):
        return 255
    if field == "msg" and col is not None:
        L = dims.max_log
        if col == 4:
            return 127
        if col in (3, 5) or 6 <= col < 6 + L:
            return 255
    return None


def _growth_guarded(field: str, col: Optional[int], dims) -> bool:
    return _guard_bound(field, col, dims) is not None


def _bounded_by_cfg(field: str, col: Optional[int], bounds) -> bool:
    """Does a cfg CONSTRAINT bound this lane's driving quantity?  If so,
    an overflow is reachable inside the *intended* state space."""
    if bounds is None:
        return False
    if field in ("term", "log_term", "msg"):   # term-carrying lanes
        return bounds.max_term is not None
    if field == "msg_cnt":
        return bounds.max_msg_count is not None
    return False


def _check_lane(dims, bounds, field, lo, hi, caps, label, reported,
                findings) -> None:
    cap_lo, cap_hi = caps[field]
    cap_lo = np.asarray(cap_lo, _I64)
    cap_hi = np.asarray(cap_hi, _I64)
    over = (lo < cap_lo) | (hi > cap_hi)
    if not bool(np.any(over)):
        return
    if field == "msg":                      # reduced to per-column [W]
        for col in np.flatnonzero(over):
            col = int(col)
            key = (field, col)
            if key in reported:
                continue
            reported.add(key)
            # The runtime pack guard covers the lane only when the lane
            # really holds the guard's bound — a narrower lane overflows
            # BELOW the guard's trigger, silently.
            gb = _guard_bound(field, col, dims)
            guarded = gb is not None and int(cap_hi[col]) >= gb
            sev = ERROR if (not guarded
                            or _bounded_by_cfg(field, col, bounds)) \
                else WARNING
            findings.append(Finding(
                PASS, sev, "lane-overflow", field=f"msg[{col}]",
                witness=label,
                message=f"message column {col} "
                        f"({lane_map.msg_col_name(col, dims)}) can reach "
                        f"[{int(lo[col])}, {int(hi[col])}] but its "
                        f"packed lane holds [{int(cap_lo[col])}, "
                        f"{int(cap_hi[col])}]"
                        + ("" if sev == ERROR else
                           " (runtime pack guard aborts, no aliasing)")))
        return
    key = (field, None)
    if key in reported:
        return
    reported.add(key)
    gb = _guard_bound(field, None, dims)
    guarded = gb is not None and int(cap_hi.max()) >= gb
    sev = ERROR if (not guarded or _bounded_by_cfg(field, None, bounds)) \
        else WARNING
    findings.append(Finding(
        PASS, sev, "lane-overflow", field=field, witness=label,
        message=f"field {field!r} can reach [{int(lo.min())}, "
                f"{int(hi.max())}] but its packed lane holds "
                f"[{int(cap_lo.min())}, {int(cap_hi.max())}]"
        + ("" if sev == ERROR else
           " (runtime pack guard aborts, no aliasing)")))
