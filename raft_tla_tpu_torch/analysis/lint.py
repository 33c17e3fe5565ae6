"""Hot-loop lint: what wrecks throughput on the card, in the traced step
and in the host loop.

Three halves, one pass:

- **Graph lint**: trace the chunk step (``engine/chunk.py`` ``ChunkStep``,
  the per-batch program the engines replay as a CUDA graph thousands of
  times a second, on the v1, v3 and v4 plans), the fingerprint and the
  seen-set insert with ``make_fx`` on the CPU at tiny capacities.  Each
  hand-written kernel's wrapper stands in for one launch there (its plain
  CPU version runs outside the trace and is listed as a launch), so the
  graph holds the PyTorch ops the card runs around the kernels.  Then
  walk every node for ops that silently wreck device throughput: a host
  sync (``.item()``, ``.tolist()``, ``int(tensor)`` — ``make_fx`` refuses
  them as ``aten._local_scalar_dense``; ERROR: it breaks CUDA-graph
  capture), dynamic shapes (``nonzero``, ``masked_select``, ``unique``,
  boolean-mask indexing; ERROR), nondeterministic float accumulation
  (``index_add``, ``scatter_add``, ``scatter_reduce``, an accumulating
  ``index_put`` on floats; WARNING — the engines' bit-identical
  cross-engine contract assumes integer determinism), and
  dtype-narrowing converts (the uint8 row packing is an INFO count; any
  *other* integer narrowing is a WARNING, because that is exactly how a
  lane silently loses bits).

- **Host-loop AST lint**: the steady-state loop (``engine/chunk.py``,
  and ``engine/bfs.py``'s ``_run_impl``, the level loop of both engines,
  with the roots' ingest, the chunk call, the dispatch, the spill and
  the other per-shard steps it calls, ``BFS_LOOP_SCOPE``) must fetch
  device data only at sanctioned sync points; any other blocking read
  (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize()``, an event's ``.synchronize()``,
  ``np.asarray``/``np.array``) inside a loop serializes the dispatch
  queue.  Sanctioned means: timed as the loop's ``sync`` phase (the
  statements from the timer's start to the ``_phase("sync", ...)`` call
  that reads it), inside a ``with ...span(...)`` or ``phase_timer(...)``
  block (every such sync is visible in the trace or the phase
  breakdown), or inside a branch that exits the loop (violation /
  deadlock reporting runs once).

- **Read-set self-check**: analyzer-vs-analyzer consistency — any state
  lane a kernel graph demonstrably reads (consumed by a non-moving op on
  the way to the outputs) must be inside the read set the effects pass
  reports for that family.  A mismatch means the taint interpreter
  dropped a dependency, which would make the POR certificates unsound —
  ERROR.

Everything here runs on the CPU: no card, no kernel build.
"""

from __future__ import annotations

import ast
import contextlib
import functools
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .interp import TRACE_LOCK, _packet, make_graph
from .report import ERROR, Finding, INFO, WARNING

PASS = "lint"

#: Ops whose output shape depends on the data (a host round trip to size
#: the result, and no CUDA-graph capture).
_DYNAMIC = frozenset({"nonzero", "masked_select", "unique", "_unique",
                      "_unique2", "unique_consecutive", "unique_dim",
                      "argwhere", "nonzero_numpy"})
#: Ops that read a device value on the host.
_HOST_SYNC = frozenset({"_local_scalar_dense", "item"})
#: Accumulations whose result depends on their order for floats.
_ORDER_SENSITIVE = frozenset({"index_add", "index_add_", "scatter_add",
                              "scatter_add_", "scatter_reduce",
                              "scatter_reduce_", "index_reduce",
                              "index_reduce_", "_index_put_impl_",
                              "index_put", "index_put_"})


# ---------------------------------------------------------------------------
# Graph lint


def _dtype_of(a) -> Optional[torch.dtype]:
    val = a.meta.get("val") if isinstance(a, torch.fx.Node) else None
    return getattr(val, "dtype", None)


def _int_bits(dtype) -> Optional[int]:
    if dtype is None or dtype == torch.bool or dtype.is_floating_point \
            or dtype.is_complex:
        return None
    return torch.iinfo(dtype).bits


def lint_graph(gm, kernel: str) -> Tuple[dict, List[Finding]]:
    """Lint one traced ``GraphModule``.  Returns (summary, findings)."""
    findings: List[Finding] = []
    n_nodes = 0
    pack_narrows = 0
    narrow: Dict[str, int] = {}
    seen_codes = set()

    def once(code, qual, sev, msg):
        if (code, qual) in seen_codes:
            return
        seen_codes.add((code, qual))
        findings.append(Finding(PASS, sev, code, field=kernel, message=msg))

    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        n_nodes += 1
        name = _packet(node)
        if name in _HOST_SYNC:
            once("host-sync", name, ERROR,
                 f"traced kernel {kernel!r} reads a device value on the "
                 f"host ({name}) — a host round trip every batch, and no "
                 "CUDA-graph capture")
        if name in _DYNAMIC or (name in ("index", "index_put", "index_put_")
                                and any(_dtype_of(i) == torch.bool
                                        for i in (node.args[1]
                                                  if len(node.args) > 1
                                                  else ())
                                        if i is not None)):
            once("dynamic-shape", name, ERROR,
                 f"kernel {kernel!r}: op {name!r} has a data-dependent "
                 "output shape — a host round trip to size it, and no "
                 "CUDA-graph capture")
        if name in _ORDER_SENSITIVE:
            src = [a for a in node.args if isinstance(a, torch.fx.Node)]
            dts = {_dtype_of(a) for a in src}
            accum = name not in ("index_put", "index_put_") or (
                len(node.args) > 3 and node.args[3]) \
                or node.kwargs.get("accumulate", False)
            if accum and any(d is not None and d.is_floating_point
                             for d in dts):
                once("nondet-reduction", name, WARNING,
                     f"kernel {kernel!r}: float {name} — accumulation "
                     "order is not fixed on the card, breaking the "
                     "engines' bit-identical cross-engine contract")
        if name == "_to_copy":
            in_b = _int_bits(_dtype_of(node.args[0]))
            out_dt = _dtype_of(node)
            out_b = _int_bits(out_dt)
            if in_b is not None and out_b is not None and out_b < in_b:
                if out_dt == torch.uint8:
                    pack_narrows += 1       # the row packing, by design
                else:
                    conv = f"{_dtype_of(node.args[0])}->{out_dt}".replace(
                        "torch.", "")
                    narrow[conv] = narrow.get(conv, 0) + 1
    for conv, cnt in sorted(narrow.items()):
        findings.append(Finding(
            PASS, WARNING, "narrowing-convert", field=kernel,
            message=f"kernel {kernel!r}: {cnt} integer-narrowing "
                    f"convert(s) {conv} outside the uint8 row packing — "
                    "a lane silently loses bits if the value can exceed "
                    "the target width",
            details={"convert": conv, "count": cnt}))
    if pack_narrows:
        findings.append(Finding(
            PASS, INFO, "packing-converts", field=kernel,
            message=f"kernel {kernel!r}: {pack_narrows} intentional "
                    "uint8 row-packing convert(s) (pack-guarded)",
            details={"count": pack_narrows}))
    return {"nodes": n_nodes, "packing_converts": pack_narrows}, findings


def trace_for_lint(fn, inputs, kernel: str):
    """``(GraphModule or None, findings)``: ``fn`` traced by ``make_fx``
    on the CPU.  A trace the tracer refuses because the function reads a
    device value on the host is itself the finding (ERROR)."""
    try:
        return make_graph(fn, inputs), []
    except RuntimeError as e:
        text = str(e)
        if "_local_scalar_dense" not in text and "data-dependent" not in text:
            raise
        return None, [Finding(
            PASS, ERROR, "host-sync", field=kernel,
            message=f"traced kernel {kernel!r} reads a device value on the "
                    "host (.item(), .tolist(), int()/bool() of a tensor: "
                    "aten._local_scalar_dense) — a host round trip every "
                    "batch, and no CUDA-graph capture")]


def kernel_sites():
    """``((owner, attribute, label), ...)``: the plain version each
    hand-written kernel's wrapper calls on a CPU tensor, where a trace
    puts a stand-in for the kernel (this lint, and the roofline's traffic
    walk in ``obs/roofline.py``).  The front's keys half shares the whole
    front's label; its build half, which runs inside the tail, has its
    own."""
    from ..ops import (chunk_front_cuda, compact_cuda, enqueue_cuda,
                       fpset_cuda, fused_tail_cuda)
    return ((compact_cuda, "compact_plain", "compact"),
            (fpset_cuda, "insert_plain", "fpset_insert"),
            (fused_tail_cuda, "insert_enqueue_plain", "fused_tail"),
            (enqueue_cuda, "enqueue_plain", "enqueue"),
            (chunk_front_cuda.Front, "plain", "chunk_front"),
            (chunk_front_cuda.Front, "keys_plain", "chunk_front"),
            (chunk_front_cuda.Front, "build_plain", "chunk_front_build"))


@contextlib.contextmanager
def kernels_as_launches(log: List[str]):
    """While tracing, each hand-written kernel's wrapper stands for one
    launch: its plain CPU version runs outside the trace (its host-side
    bookkeeping is not what the card runs) and its name is appended to
    ``log``."""
    from torch.fx.experimental.proxy_tensor import \
        disable_proxy_modes_tracing

    sites = kernel_sites()
    saved = []

    def leaf(orig, label):
        def launch(*a, **k):
            log.append(label)
            with disable_proxy_modes_tracing():
                return orig(*a, **k)
        return launch

    with TRACE_LOCK:
        try:
            for obj, attr, label in sites:
                orig = getattr(obj, attr)
                saved.append((obj, attr, orig))
                setattr(obj, attr, leaf(orig, label))
            yield log
        finally:
            for obj, attr, orig in saved:
                setattr(obj, attr, orig)


def _step_inputs(engine):
    from ..engine import chunk as chunk_mod
    from ..models.schema import state_width
    from ..ops import fpset
    dims = engine.dims
    sw = state_width(dims)
    qcur = torch.zeros((engine._Q + engine._PAD, sw), dtype=torch.uint8)
    tbuf = torch.zeros((engine._TA, chunk_mod.TRACE_ROW), dtype=torch.uint8)
    cs = chunk_mod.chunk_state(len(dims.family_sizes), sw, "cpu")
    seen = fpset.empty(engine.config.seen_capacity, "cpu")
    return [qcur, torch.zeros_like(qcur), tbuf, *cs, *seen], type(seen)


@functools.lru_cache(maxsize=4)
def traced_engine_kernels(dims, batch: int = 4):
    """The kernels the single-device engine runs, traced on the CPU at
    tiny capacities: ``((name, GraphModule or None, launches,
    findings), ...)`` for the fingerprint, the seen-set insert and the
    chunk step on the v1, v3 and v4 plans.  Memoized on ``dims``; tests
    drop it with ``traced_engine_kernels.cache_clear()``."""
    from ..engine import chunk as chunk_mod
    from ..engine.bfs import BFSEngine, EngineConfig
    from ..models.invariants import build_type_ok
    from ..ops import fpset, fpset_cuda
    from ..ops.fingerprint import build_fingerprint
    from .interp import state_inputs

    out = []
    fp = build_fingerprint(dims, "cpu")
    from ..models.schema import StateBatch
    gm, fs = trace_for_lint(lambda *a: fp(StateBatch(*a)), state_inputs(dims),
                            "fingerprint")
    out.append(("fingerprint", gm, (), tuple(fs)))

    seen = fpset.empty(1024, "cpu")
    log: List[str] = []
    with kernels_as_launches(log):
        gm, fs = trace_for_lint(
            lambda keys, valid, *s: fpset_cuda.insert(type(seen)(*s), keys,
                                                      valid),
            [torch.zeros(8, dtype=torch.int64),
             torch.zeros(8, dtype=torch.bool), *seen], "fpset_insert")
    out.append(("fpset_insert", gm, tuple(log), tuple(fs)))

    for plan in ("v1", "v3", "v4"):
        engine = BFSEngine(dims, invariants={"TypeOK": build_type_ok(dims)},
                           config=EngineConfig(
                               batch=batch, queue_capacity=64,
                               seen_capacity=1024, pipeline=plan,
                               record_trace=True),
                           device="cpu")
        inputs, seen_cls = _step_inputs(engine)

        def step(qcur, qnext, tbuf, st, vrow, vfp, drow, *s):
            engine._step(qcur, seen_cls(*s), qnext, tbuf,
                         chunk_mod.ChunkState(st, vrow, vfp, drow))
            return st

        log = []
        with kernels_as_launches(log):
            gm, fs = trace_for_lint(step, inputs, f"chunk_step_{plan}")
        out.append((f"chunk_step_{plan}", gm, tuple(log), tuple(fs)))
    return tuple(out)


# ---------------------------------------------------------------------------
# Analyzer-vs-analyzer read-set self-check
#
# The effects pass's read sets feed the POR certificates, so a taint
# dependency silently dropped by the interpreter would turn into an
# unsound reduction.  This check re-derives a SYNTACTIC read set per
# action family — every state placeholder consumed by at least one
# non-moving op on the way to the outputs — and flags any lane the graph
# demonstrably reads that the effects pass does not report.  Pure
# pass-through (an unchanged successor field flowing identically to an
# output) is not a read; that is exactly the distinction the taint
# domain draws, so the two analyzers must agree.

#: Ops that move values without consuming them.
_IDENTITY_OPS = frozenset({
    "unsqueeze", "squeeze", "view", "reshape", "_unsafe_view", "expand",
    "slice", "permute", "transpose", "t", "clone", "alias", "detach",
    "_to_copy", "lift_fresh_copy", "contiguous", "flip"})


def syntactic_real_reads(gm, n_state: int) -> set:
    """Indices (0..n_state-1) of state placeholders consumed by a
    non-moving op anywhere in the graph."""
    import operator
    reads: set = set()
    env: Dict = {}
    k = 0
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = frozenset([k]) if k < n_state else frozenset()
            k += 1
            continue
        if node.op != "call_function":
            continue
        srcs = [env.get(a, frozenset())
                for a in node.all_input_nodes]
        union = frozenset().union(*srcs) if srcs else frozenset()
        if node.target is operator.getitem or _packet(node) in _IDENTITY_OPS:
            env[node] = union
        else:
            reads.update(union)
            env[node] = union
    return reads


def read_set_check(dims, family_reads=None,
                   effect_summary=None) -> List[Finding]:
    """Flag any action kernel whose graph reads a packed lane outside
    the read set the effects pass reports for it.  ``family_reads``
    overrides the effects-derived ``{family: fields}`` map (tests plant
    a missing field there to prove the check fires).

    Membership is derived from the per-instance element masks
    (``.any()``), and two mask-level invariants of the extraction are
    re-checked per instance: the guard's read mask is contained in the
    full read mask, and every reported mask has the field's declared
    shape."""
    import numpy as np

    from . import lane_map
    from .interp import traced_kernels
    findings: List[Finding] = []
    if family_reads is None:
        if effect_summary is None:
            from . import effects
            effect_summary, _f = effects.analyze(dims)
        shapes = lane_map.field_shapes(dims)
        family_reads = {}
        for inst in effect_summary.instances:
            fam = family_reads.setdefault(inst.family, set())
            fam.update(f for f, m in inst.reads.items() if m.any())
            fam.update(f for f, m in inst.guard_reads.items() if m.any())
            bad_shape = sorted(
                f for masks in (inst.reads, inst.writes, inst.guard_reads)
                for f, m in masks.items() if m.shape != shapes[f])
            if bad_shape:
                findings.append(Finding(
                    PASS, ERROR, "footprint-shape-mismatch",
                    field=inst.family, witness=inst.label,
                    message=f"{inst.label}: footprint mask(s) for "
                            f"{', '.join(bad_shape)} do not match the "
                            "declared field shape — element-wise "
                            "intersections downstream would be wrong"))
            leaked = sorted(
                f for f, m in inst.guard_reads.items()
                if bool((m & ~inst.reads.get(f, np.zeros_like(m))).any()))
            if leaked:
                findings.append(Finding(
                    PASS, ERROR, "guard-read-leak",
                    field=inst.family, witness=inst.label,
                    message=f"{inst.label}: guard reads element(s) of "
                            f"{', '.join(leaked)} missing from the "
                            "full read mask — the dependence matrix "
                            "under-approximates (POR certificates "
                            "would be unsound)"))
    n_state = len(lane_map.FIELDS)
    for name, graph, _params in traced_kernels(dims):
        syn = {lane_map.FIELDS[k]
               for k in syntactic_real_reads(graph, n_state)}
        extra = sorted(syn - set(family_reads.get(name, frozenset())))
        if extra:
            findings.append(Finding(
                PASS, ERROR, "read-set-mismatch", field=name,
                message=f"kernel {name!r} syntactically reads state "
                        f"field(s) {', '.join(extra)} that the effects "
                        "pass does not report — the taint interpreter "
                        "dropped a dependency (POR certificates would "
                        "be unsound)",
                details={"extra_reads": extra}))
    return findings


# ---------------------------------------------------------------------------
# Host-loop AST lint

#: Methods whose call on a device tensor blocks until the device is done.
_BLOCKING_METHODS = ("item", "tolist", "cpu", "numpy", "synchronize")


def _is_blocking_read(call: ast.Call) -> Optional[str]:
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    base = f.value
    if isinstance(base, ast.Name) and base.id in ("np", "numpy") \
            and f.attr in ("asarray", "array"):
        return f"np.{f.attr}"
    if f.attr in _BLOCKING_METHODS:
        if f.attr == "synchronize" and isinstance(base, ast.Attribute) \
                and base.attr == "cuda":
            return "torch.cuda.synchronize()"
        return f".{f.attr}()"
    return None


def _call_name(expr) -> Optional[str]:
    if isinstance(expr, ast.Call):
        f = expr.func
        if isinstance(f, ast.Attribute):
            return f.attr
        if isinstance(f, ast.Name):
            return f.id
    return None


def _is_sanctioned_with(node: ast.With) -> bool:
    """A ``with`` whose block is timed or traced: ``phase_timer(...)``,
    ``span(...)`` or ``_span(...)``."""
    return any(_call_name(item.context_expr) in ("phase_timer", "span",
                                                 "_span")
               for item in node.items)


def _branch_exits(stmts: Sequence[ast.stmt]) -> bool:
    """Does this if-branch leave the loop (break/return/raise anywhere
    in its subtree)?"""
    for st in stmts:
        for n in ast.walk(st):
            if isinstance(n, (ast.Break, ast.Return, ast.Raise)):
                return True
    return False


def _sync_timed(stmts: Sequence[ast.stmt]) -> set:
    """Indices of the statements of a block timed as its ``sync`` phase:
    from the assignment of the timer a ``_phase("sync", <expr of T>)``
    call reads back to that call."""
    out = set()
    for k, st in enumerate(stmts):
        call = st.value if isinstance(st, ast.Expr) else None
        if _call_name(call) != "_phase" or not call.args \
                or not isinstance(call.args[0], ast.Constant) \
                or call.args[0].value != "sync":
            continue
        names = {n.id for a in call.args[1:] for n in ast.walk(a)
                 if isinstance(n, ast.Name)}
        start = k
        for j in range(k - 1, -1, -1):
            tgt = stmts[j]
            if isinstance(tgt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id in names
                    for t in tgt.targets):
                start = j
                break
        out.update(range(start, k + 1))
    return out


def _scan_block(stmts, in_loop: bool, sanctioned: bool, hits: list):
    timed = _sync_timed(stmts)
    for k, st in enumerate(stmts):
        ok = sanctioned or k in timed
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A nested def's loops are scanned in their own right (the
            # engines' nested helpers run inside the hot loop).
            _scan_block(st.body, in_loop, ok, hits)
        elif isinstance(st, (ast.While, ast.For, ast.AsyncFor)):
            for sub in ast.walk(st.test if isinstance(st, ast.While)
                                else st.iter):
                if isinstance(sub, ast.Call):
                    kind = _is_blocking_read(sub)
                    if kind and not ok:
                        hits.append((sub.lineno, kind))
            _scan_block(st.body, True, ok, hits)
            _scan_block(st.orelse, in_loop, ok, hits)
        elif isinstance(st, ast.With):
            _scan_block(st.body, in_loop, ok or _is_sanctioned_with(st),
                        hits)
        elif isinstance(st, ast.If):
            _scan_block(st.body, in_loop,
                        ok or (in_loop and _branch_exits(st.body)), hits)
            _scan_block(st.orelse, in_loop,
                        ok or (in_loop and _branch_exits(st.orelse)), hits)
        elif isinstance(st, ast.Try):
            for blk in (st.body, st.orelse, st.finalbody):
                _scan_block(blk, in_loop, ok, hits)
            for h in st.handlers:
                _scan_block(h.body, in_loop, ok, hits)
        elif in_loop and not ok:
            for n in ast.walk(st):
                if isinstance(n, ast.Call):
                    kind = _is_blocking_read(n)
                    if kind:
                        hits.append((n.lineno, kind))


def scan_host_loops(path: str, scope: Optional[Sequence[str]] = None
                    ) -> List[Finding]:
    """AST lint one file for blocking device reads inside loops outside
    sanctioned sync points.  ``scope`` restricts the scan to the named
    function defs (at any nesting depth); None scans the whole module.
    A named def with no loop of its own is a step the loop calls, and
    is scanned as inside a loop."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    roots: List[Tuple[Sequence[ast.stmt], bool]] = []
    if scope is None:
        roots.append((tree.body, False))
    else:
        want = set(scope)
        for n in ast.walk(tree):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and n.name in want:
                roots.append((n.body, not any(
                    isinstance(m, (ast.While, ast.For, ast.AsyncFor))
                    for m in ast.walk(n))))
    hits: List[Tuple[int, str]] = []
    for body, in_loop in roots:
        _scan_block(body, in_loop=in_loop, sanctioned=False, hits=hits)
    # One finding a line (``x.cpu().numpy()`` is one read).
    hits = sorted({ln: kind for ln, kind in reversed(hits)}.items())
    rel = os.path.relpath(path, start=os.getcwd()) \
        if os.path.isabs(path) else path
    return [Finding(
        PASS, ERROR, "blocking-read-in-loop", field=f"{rel}:{ln}",
        message=f"{rel}:{ln}: {kind} inside the hot loop outside a "
                "sanctioned sync point (the timed sync phase, a span or "
                "phase_timer block, or a loop-exit branch) — serializes "
                "the dispatch queue on the card")
        for ln, kind in hits]


#: The level loop's methods the host-loop scan covers in engine/bfs.py:
#: the loop, the roots' ingest, and the steps on one shard it calls.
BFS_LOOP_SCOPE = ("_run_impl", "_run_chunk", "_dispatch", "_spill",
                  "_resolve_spill", "_ingest", "_ingest_wave", "_spill_sync",
                  "_land_spills", "_resume_source", "_run_buffers",
                  "_resume_into", "_device_name", "_seen_capacity",
                  "_chunk_call", "_flush_rows", "_flagged", "_host_left",
                  "_host_rows", "_upload", "_write_checkpoint", "_budget",
                  "_sample_skew")


def _default_targets() -> List[Tuple[str, Optional[Tuple[str, ...]]]]:
    """(file, scope) pairs the default scan covers: the whole chunk
    module plus the single-device engine's level loop."""
    eng = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "engine")
    return [(os.path.join(eng, "chunk.py"), None),
            (os.path.join(eng, "bfs.py"), BFS_LOOP_SCOPE)]


# ---------------------------------------------------------------------------
# The pass


def analyze(dims, effect_summary=None) -> Tuple[dict, List[Finding]]:
    """Run all lint halves.  ``effect_summary`` reuses the effects
    pass's result for the read-set self-check when both passes run in
    one invocation."""
    findings: List[Finding] = []
    kernels: Dict[str, dict] = {}
    for name, gm, launches, traced_findings in traced_engine_kernels(dims):
        findings.extend(traced_findings)
        summ = {"launches": list(launches)}
        if gm is not None:
            s, fs = lint_graph(gm, name)
            summ.update(s)
            findings.extend(fs)
        kernels[name] = summ
    scanned = []
    for path, scope in _default_targets():
        findings.extend(scan_host_loops(path, scope))
        scanned.append(os.path.basename(path))
    rs = read_set_check(dims, effect_summary=effect_summary)
    findings.extend(rs)
    return {"kernels": kernels, "host_files": scanned,
            "read_set_mismatches": len(rs)}, findings
