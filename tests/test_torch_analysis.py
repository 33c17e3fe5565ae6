"""The port's static analyzer (``raft_tla_tpu_torch/analysis/``): the
lane map, the report, the graph evaluator, the effects, bounds and lint
passes, and ``check_packable``'s message, held to

- the JAX tests' literal pins (``tests/test_analysis.py``: the
  spec-derived per-family footprints, the element footprints, the
  independence pairs, the bounds proofs), imported rather than copied;
- the JAX oracle: every field element a real oracle successor changes
  lies inside the port's traced write mask for that instance;
- the live JAX package only where its output does not depend on the
  installed jax: the lane-map tables (seed, MCraft_bounded and
  reconfig3 dims), the report's JSON and text for the same findings, a
  JAX-written footprint summary decoded by the port and the reverse, and
  ``check_packable``'s text.

All at ``RaftDims(3, 2, 3, 4)`` (``tests/test_analysis.py``'s DIMS), on
the CPU; one analyzer run per module fixture.
"""

import json
import os
import textwrap

import numpy as np
import pytest
import torch

from raft_tla_tpu.analysis import lane_map as jlane_map
from raft_tla_tpu.analysis import report as jreport
from raft_tla_tpu.models import oracle as jorc
from raft_tla_tpu.models import schema as jschema
from raft_tla_tpu.models.dims import RaftDims as JDims
from raft_tla_tpu.models.pystate import init_state as jinit
from raft_tla_tpu.utils.cfg import load_config as jload
from raft_tla_tpu_torch.analysis import (bounds, effects, interp, lane_map,
                                         lint, resolve_passes, run_analysis)
from raft_tla_tpu_torch.analysis import report as preport
from raft_tla_tpu_torch.analysis.report import ERROR, INFO, WARNING
from raft_tla_tpu_torch.models import schema
from raft_tla_tpu_torch.models.dims import RaftDims
from raft_tla_tpu_torch.models.invariants import Bounds
from raft_tla_tpu_torch.models.pystate import init_state
from raft_tla_tpu_torch.utils.cfg import load_config
from tests.test_analysis import ORACLE_GUARD_READS, ORACLE_WRITES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = RaftDims(n_servers=3, n_values=2, max_log=3, n_msg_slots=4)
J_DIMS = JDims(n_servers=3, n_values=2, max_log=3, n_msg_slots=4)


@pytest.fixture(scope="module", autouse=True)
def _release_tracing_caches():
    """The traced graphs are memoized per dims; drop them at module
    teardown so they never tax later modules."""
    yield
    import gc
    import jax

    from raft_tla_tpu.analysis import interp as jinterp
    interp.traced_kernels.cache_clear()
    lint.traced_engine_kernels.cache_clear()
    jinterp.traced_kernels.cache_clear()
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def effect_summary():
    return effects.analyze(DIMS)


@pytest.fixture(scope="module")
def lint_result(effect_summary):
    return lint.analyze(DIMS, effect_summary=effect_summary[0])


def _field_taint(name, shape):
    return interp.state_taint(name, (1,) + shape)


def _trace(fn, *shapes):
    return interp.make_graph(fn, [torch.zeros(s, dtype=torch.int64)
                                  for s in shapes])


# ---------------------------------------------------------------------------
# lane map (a copy of the JAX module's, held to it)


def _dims_pair(which):
    if which == "seed":
        return DIMS, J_DIMS, None, None
    cfg = os.path.join(REPO, "configs", f"{which}.cfg")
    p, j = load_config(cfg), jload(cfg)
    return p.dims, j.dims, p.bounds, j.bounds


@pytest.mark.parametrize("which", ["seed", "MCraft_bounded", "reconfig3"])
def test_lane_map_tables_equal_jax(which):
    pd, jd, pb, jb = _dims_pair(which)

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (list, tuple)) and a and not isinstance(a[0],
                                                                   str):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), (a, b)

    assert lane_map.FIELDS == jlane_map.FIELDS
    assert lane_map.FIELD_WRITERS == jlane_map.FIELD_WRITERS
    assert lane_map.GROWTH_GUARDED == jlane_map.GROWTH_GUARDED
    same(lane_map.field_shapes(pd), jlane_map.field_shapes(jd))
    assert lane_map.row_layout(pd) == jlane_map.row_layout(jd)
    same(lane_map.lane_capacities(pd), jlane_map.lane_capacities(jd))
    same(lane_map.field_domains(pd), jlane_map.field_domains(jd))
    same(lane_map.msg_type_domains(pd), jlane_map.msg_type_domains(jd))
    same(lane_map.constraint_bounds(pd, pb),
         jlane_map.constraint_bounds(jd, jb))
    for c in range(pd.msg_width):
        assert lane_map.msg_col_name(c, pd) == jlane_map.msg_col_name(c, jd)
        assert lane_map.describe_lane("msg", (1, c), pd) \
            == jlane_map.describe_lane("msg", (1, c), jd)
    size = sum(s for _f, _o, s, _sh in lane_map.row_layout(pd))
    for off in (0, size // 2, size - 1):
        assert lane_map.decode_row_offset(pd, off) \
            == jlane_map.decode_row_offset(jd, off)


def test_fields_match_schema():
    assert lane_map.FIELDS == schema.StateBatch._fields
    layout = lane_map.row_layout(DIMS)
    assert layout[-1][1] + layout[-1][2] == schema.state_width(DIMS)
    f, idx = lane_map.decode_row_offset(DIMS, layout[3][1])
    assert f == "log_term" and idx == (0, 0)


# ---------------------------------------------------------------------------
# report (a copy of the JAX module's, held to it)


def _findings(mod):
    return [mod.Finding("bounds", mod.ERROR, "lane-overflow", field="term",
                        message="x", witness="Timeout(i=0)"),
            mod.Finding("bounds", mod.ERROR, "lane-overflow",
                        field="msg_cnt", message="y"),
            mod.Finding("lint", mod.WARNING, "narrowing-convert",
                        field="k", message="z", details={"count": 2}),
            mod.Finding("effects", mod.INFO, "dead-lanes", field="msg",
                        message="w", details={"unwritten": 1})]


def test_report_json_and_text_equal_jax(tmp_path):
    reps = []
    for mod in (jreport, preport):
        rep = mod.Report(model={"dims": repr(J_DIMS)},
                         allowlist=["lane-overflow:term"])
        rep.extend(_findings(mod))
        rep.summarize_pass("bounds", {"rounds": 3})
        rep.summarize_pass("por", {"certified": 0, "n_instances": 2})
        reps.append(rep)
    jrep, prep = reps
    assert prep.to_json() == jrep.to_json()
    assert prep.render_text() == jrep.render_text()
    assert not prep.ok and prep.first_witness() is None
    f0 = prep.to_json()["passes"]["bounds"]["findings"][0]
    assert f0["severity"] == WARNING and f0["allowlisted"]
    prep.write_json(str(tmp_path / "p.json"))
    jrep.write_json(str(tmp_path / "j.json"))
    assert (tmp_path / "p.json").read_text() \
        == (tmp_path / "j.json").read_text()


# ---------------------------------------------------------------------------
# check_packable: the JAX package's text, byte for byte


def _bad_roots(pd, jd):
    """(field, port root, JAX root) with one element out of its lane:
    above it, and below it, in every field."""
    pst = schema.encode_state(init_state(pd), pd)
    jst = jschema.encode_state(jinit(jd), jd)
    caps = lane_map.lane_capacities(pd)
    for f in lane_map.FIELDS:
        lo, hi = caps[f]
        pa, ja = np.array(getattr(pst, f)), np.array(getattr(jst, f))
        k = pa.size // 2
        col = np.unravel_index(k, pa.shape)[-1]
        top = (np.asarray(hi).reshape(-1)[col] if f == "msg" else hi) + 7
        bot = (np.asarray(lo).reshape(-1)[col] if f == "msg" else lo) - 3
        for v in (top, bot):
            p2, j2 = pa.copy(), ja.copy()
            p2.reshape(-1)[k] = v
            j2.reshape(-1)[k] = v
            yield f, pst._replace(**{f: p2}), jst._replace(**{f: j2})


@pytest.mark.parametrize("which", ["seed", "reconfig3"])
def test_check_packable_text_equals_jax(which):
    pd, jd, _pb, _jb = _dims_pair(which)
    n = 0
    for f, pst, jst in _bad_roots(pd, jd):
        with pytest.raises(ValueError) as pe:
            schema.check_packable(pst, pd)
        with pytest.raises(ValueError) as je:
            jschema.check_packable(jst, jd)
        assert str(pe.value) == str(je.value), f
        assert f"state field {f!r}" in str(pe.value)
        n += 1
    assert n == 2 * len(lane_map.FIELDS)


def test_check_packable_names_lane_and_writers():
    st = schema.encode_state(init_state(DIMS), DIMS)
    bad = st._replace(term=np.array([0, 300, 0]))
    with pytest.raises(ValueError, match=r"term.*Timeout, Receive"):
        schema.check_packable(bad, DIMS)
    msg = np.array(st.msg)
    msg[1, 4] = 200
    with pytest.raises(ValueError,
                       match=r"slot 1 column 4.*mlastLogTerm.*RequestVote"):
        schema.check_packable(st._replace(msg=msg), DIMS)


# ---------------------------------------------------------------------------
# the graph evaluator


def test_interp_gather_known_index_is_element_precise():
    """A gather at a parameter-concrete index reads exactly that element;
    a bounded state-dependent index reads its range (a flattened
    ``[N, L]`` field at ``i * L + clamp(k)`` reads row ``i``); an
    unbounded one the whole axis."""
    gm = _trace(lambda a, i: torch.gather(a, 1, i), (1, 5), (1, 1))
    arr = _field_taint("X", (5,))
    out = interp.eval_graph(gm, [arr, np.full((1, 1), 3)],
                            interp.TaintDomain())[0]
    assert interp.read_mask(out)["X"].tolist() == [[0, 0, 0, 1, 0]]

    def two_level(a, ln, i):
        x, n, m = a.shape
        k = torch.gather(ln, 1, i).clamp(0, m - 1)
        return torch.gather(a.reshape(x, n * m), 1, i * m + k)

    gm2 = _trace(two_level, (1, 3, 4), (1, 3), (1, 1))
    out2 = interp.eval_graph(gm2, [_field_taint("A", (3, 4)),
                                   _field_taint("L", (3,)),
                                   np.full((1, 1), 1)],
                             interp.TaintDomain())[0]
    rm = interp.read_mask(out2)
    assert rm["A"][0, 1].all() and not rm["A"][0, 0].any() \
        and not rm["A"][0, 2].any()
    assert rm["L"].tolist() == [[0, 1, 0]]

    gm3 = _trace(lambda a, y: torch.gather(a, 1, y), (1, 5), (1, 1))
    out3 = interp.eval_graph(gm3, [arr, _field_taint("Y", (1,))],
                             interp.TaintDomain())[0]
    assert interp.read_mask(out3)["X"].all()


def test_interp_select_point_update_masks():
    """where(arange == i, v, field): the write confined to element i, and
    the positional read restriction keeps the read at element i."""
    def set1(a, i):
        return torch.where(torch.arange(5)[None, :] == i, a + 1, a)

    gm = _trace(set1, (1, 5), (1, 1))
    out = interp.eval_graph(gm, [_field_taint("X", (5,)),
                                 np.full((1, 1), 2)],
                            interp.TaintDomain())[0]
    assert out.origin == "X"
    assert out.diff.tolist() == [[0, 0, 1, 0, 0]]
    reads = effects._write_reads(out, out.diff)
    assert reads["X"].tolist() == [[0, 0, 1, 0, 0]]
    # The same graph under intervals: a point update, exactly.
    iv = interp.eval_graph(
        gm, [interp.Interval(np.array([[0, 1, 2, 3, 4]]),
                             np.array([[0, 1, 2, 3, 9]]), torch.int64),
             np.full((1, 1), 4)], interp.IntervalDomain())[0]
    assert iv.lo.tolist() == [[0, 1, 2, 3, 5]]
    assert iv.hi.tolist() == [[0, 1, 2, 3, 10]]


def test_interp_unhandled_op_widens_and_notes():
    """An op without a rule widens to the whole footprint AND surfaces
    a note — conservatism is load-bearing."""
    gm = _trace(lambda a: torch.sort(a, -1).values[:, :1], (1, 5))
    dom = interp.TaintDomain()
    out = interp.eval_graph(gm, [_field_taint("X", (5,))], dom)[0]
    assert interp.read_mask(out)["X"].all()
    assert any("sort" in n for n in dom.notes)
    idom = interp.IntervalDomain()
    iv = interp.eval_graph(gm, [np.zeros((1, 5), np.int64)], idom)[0]
    assert iv.lo.tolist() == [[0]]          # all known: evaluated exactly
    iv = interp.eval_graph(gm, [interp.Interval(
        np.zeros((1, 5), np.int64), np.ones((1, 5), np.int64),
        torch.int64)], idom)[0]
    assert int(iv.hi.max()) == torch.iinfo(torch.int64).max
    assert any("sort" in n for n in idom.notes)


# ---------------------------------------------------------------------------
# effects: the JAX tests' pins


def test_family_write_sets_match_spec_footprints(effect_summary):
    summary, findings = effect_summary
    assert set(summary.families) == set(ORACLE_WRITES)
    for fam, expect in ORACLE_WRITES.items():
        assert summary.families[fam]["writes"] == expect, fam
    # Every op of the v1 kernels has a rule: no imprecision note.
    assert [f for f in findings if f.code == "analysis-imprecision"] == []


def test_family_guard_reads_match_spec_guards(effect_summary):
    summary, _ = effect_summary
    for fam, expect in ORACLE_GUARD_READS.items():
        assert summary.families[fam]["guard_reads"] == expect, fam


def test_field_writers_table(effect_summary):
    summary, _ = effect_summary
    traced = {f: set() for f in lane_map.FIELDS}
    for fam, d in summary.families.items():
        for f in d["writes"]:
            traced[f].add(fam)
    for f in lane_map.FIELDS:
        assert traced[f] == set(lane_map.FIELD_WRITERS[f]), f


def test_no_dead_lanes_on_base_model(effect_summary):
    summary, _ = effect_summary
    dead = {f: int(m.sum()) for f, m in summary.dead_lanes.items()}
    assert all(v == 0 for v in dead.values()), dead


def test_elementwise_instance_footprints(effect_summary):
    summary, _ = effect_summary
    by_label = {i.label: i for i in summary.instances}
    t1 = by_label["Timeout(i=1)"]
    for f, m in t1.reads.items():
        assert m.sum() == 1 and m[1], (f, m)
    dup = by_label["DuplicateMessage(slot=2)"]
    assert {f: m.tolist() for f, m in dup.reads.items()} \
        == {"msg_cnt": [0, 0, 1, 0]}
    assert {f: m.tolist() for f, m in dup.writes.items()} \
        == {"msg_cnt": [0, 0, 1, 0]}
    rcv = by_label["Receive(slot=0)"]
    assert rcv.reads["commit"].all() and rcv.writes["role"].all()


def test_elementwise_matrix_refines_field_granularity(effect_summary):
    summary, _ = effect_summary
    idx = {i.label: k for k, i in enumerate(summary.instances)}
    ind = summary.independent
    assert ind.shape == (DIMS.n_instances,) * 2
    assert not ind.diagonal().any() and (ind == ind.T).all()
    assert ind[idx["Timeout(i=0)"], idx["Timeout(i=1)"]]
    assert ind[idx["Restart(i=0)"], idx["AdvanceCommitIndex(i=1)"]]
    assert ind[idx["ClientRequest(i=0, v=1)"], idx["Timeout(i=2)"]]
    assert ind[idx["DuplicateMessage(slot=0)"],
               idx["DuplicateMessage(slot=3)"]]
    assert not ind[idx["Timeout(i=0)"], idx["Restart(i=0)"]]
    assert not ind[idx["Timeout(i=0)"], idx["Receive(slot=0)"]]
    a, b = idx["AdvanceCommitIndex(i=0)"], idx["DuplicateMessage(slot=1)"]
    assert summary.guard_independent[a, b] and ind[a, b]


def test_effects_differential_against_jax_oracle(effect_summary):
    """Soundness against the JAX package's reference interpreter: every
    element a real oracle transition changes lies inside the port's
    traced write mask of THAT instance (messages address their slot in
    the canonical, sorted bag encoding both packages share)."""
    summary, _ = effect_summary
    grid = {}
    for g in range(DIMS.n_instances):
        fam, params = DIMS.instance_info(g)
        grid[(fam, tuple(params.values()))] = g
    msg_fams = {DIMS.family_names.index(n) for n in
                ("Receive", "DuplicateMessage", "DropMessage")}
    frontier, seen, checked = [jinit(J_DIMS)], set(), 0
    for _level in range(3):
        nxt = []
        for s in frontier:
            enc_s = jschema.encode_state(s, J_DIMS)
            bag = sorted(s.messages)
            for (fam, params), succ in jorc.successors(s, J_DIMS):
                if fam in msg_fams:
                    key = (fam, (next(k for k, (m, _c) in enumerate(bag)
                                      if m == params[0]),))
                else:
                    key = (fam, tuple(params))
                inst = summary.instances[grid[key]]
                enc_t = jschema.encode_state(succ, J_DIMS)
                for f in lane_map.FIELDS:
                    delta = np.asarray(getattr(enc_s, f)) \
                        != np.asarray(getattr(enc_t, f))
                    if delta.any():
                        mask = inst.writes.get(f)
                        assert mask is not None and not (
                            delta & ~mask).any(), (inst.label, f)
                checked += 1
                if succ not in seen and len(seen) < 300:
                    seen.add(succ)
                    nxt.append(succ)
        frontier = nxt
    assert checked > 100


def test_footprints_cross_both_packages(effect_summary):
    """The versioned footprint encoding (v2, hex masks): the port's
    summary round-trips, a summary the JAX package wrote decodes in the
    port exactly as in the JAX package, and the reverse; both decoders
    refuse another version."""
    from raft_tla_tpu.analysis import effects as jeffects
    summary, _ = effect_summary
    sj = effects.summary_json(summary)
    json.dumps(sj)
    assert sj["footprints_version"] == jeffects.FOOTPRINTS_VERSION == 2
    for fp, inst in zip(effects.footprints_from_json(sj),
                        summary.instances):
        for kind in ("reads", "writes", "guard_reads"):
            masks = getattr(inst, kind)
            assert set(fp[kind]) == set(masks)
            for f, m in masks.items():
                assert (fp[kind][f] == m).all(), (inst.label, kind, f)
    ind, gind = effects.matrices_from_json(sj)
    assert (ind == summary.independent).all()
    assert (gind == summary.guard_independent).all()

    def same_decode(doc):
        a = effects.footprints_from_json(doc)
        b = jeffects.footprints_from_json(doc)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            for kind in x:
                assert set(x[kind]) == set(y[kind])
                for f in x[kind]:
                    assert (x[kind][f] == y[kind][f]).all()
        for m, n in zip(effects.matrices_from_json(doc),
                        jeffects.matrices_from_json(doc)):
            assert (m == n).all()

    same_decode(sj)                               # port-written
    jsum, _f = jeffects.analyze(J_DIMS)
    same_decode(jeffects.summary_json(jsum))      # JAX-written
    stale = dict(sj, footprints_version=1)
    for mod in (effects, jeffects):
        with pytest.raises(ValueError, match="footprint encoding"):
            mod.footprints_from_json(stale)
        with pytest.raises(ValueError, match="regenerate"):
            mod.matrices_from_json(stale)


def test_read_set_self_check_clean_and_planted(effect_summary):
    summary, _ = effect_summary
    assert lint.read_set_check(DIMS, effect_summary=summary) == []
    reads = {fam: d["reads"] | d["guard_reads"]
             for fam, d in summary.families.items()}
    reads["DuplicateMessage"] = reads["DuplicateMessage"] - {"msg_cnt"}
    findings = lint.read_set_check(DIMS, family_reads=reads)
    assert len(findings) == 1
    f = findings[0]
    assert f.severity == ERROR and f.code == "read-set-mismatch"
    assert f.field == "DuplicateMessage"
    assert f.details["extra_reads"] == ["msg_cnt"]


# ---------------------------------------------------------------------------
# bounds: the JAX tests' pins


@pytest.mark.parametrize("case", ["seed", "shrunk-term", "cfg-bounds",
                                  "cfg-admits-overflow"])
def test_bounds_pins(case):
    kw = {"seed": {},
          "shrunk-term": {"lane_caps": {"term": (0, 15)}},
          "cfg-bounds": {"bounds": Bounds(max_term=3, max_log_len=2,
                                          max_msg_count=3)},
          "cfg-admits-overflow": {"bounds": Bounds(max_term=300)}}[case]
    summary, findings = bounds.analyze(DIMS, init_states=[init_state(DIMS)],
                                       **kw)
    assert summary["converged"]
    errors = {f.field: f for f in findings if f.severity == ERROR}
    if case == "seed":
        assert errors == {}
        # Unbounded pack-guarded growth stays visible as a WARNING.
        assert "term" in {f.field for f in findings if f.severity == WARNING}
    elif case == "cfg-bounds":
        assert [f for f in findings if f.severity != INFO] == []
    else:
        # The lane overflows inside the (intended) state space: ERROR,
        # with the raising action named.
        assert set(errors) >= {"term"}
        assert errors["term"].code == "lane-overflow"
        assert errors["term"].witness.startswith("Timeout")
    assert not any(f.code == "int32-wrap" for f in findings)


# ---------------------------------------------------------------------------
# lint


def test_lint_clean_on_the_real_engine(lint_result):
    summary, findings = lint_result
    assert [f for f in findings if f.severity == ERROR] == []
    kernels = summary["kernels"]
    assert set(kernels) == {"fingerprint", "fpset_insert", "chunk_step_v1",
                            "chunk_step_v3", "chunk_step_v4"}
    # Each step's hand-written kernels stand for their launches.
    assert kernels["chunk_step_v3"]["launches"] == ["compact", "fused_tail",
                                                    "enqueue"]
    # v4: the front's keys, the fused tail with the front's build of the
    # new lanes inside it, the trace append.
    assert kernels["chunk_step_v4"]["launches"] == ["chunk_front",
                                                    "fused_tail",
                                                    "chunk_front_build",
                                                    "enqueue"]
    assert kernels["fpset_insert"]["launches"] == ["fpset_insert"]
    assert summary["host_files"] == ["chunk.py", "bfs.py"]
    assert summary["read_set_mismatches"] == 0
    # The row packing is an INFO count; the int64 -> int32 converts of
    # the chunk-state counters and the trace rows are surfaced.
    assert {f.code for f in findings if f.severity == INFO} \
        == {"packing-converts"}
    assert {f.code for f in findings if f.severity == WARNING} \
        <= {"narrowing-convert"}


def test_lint_flags_planted_item_in_the_level_loop(tmp_path):
    """A copy of the engine's level loop with one planted ``.item()``:
    exactly that line is an ERROR; the real file is clean."""
    src = os.path.join(REPO, "raft_tla_tpu_torch", "engine", "bfs.py")
    assert lint.scan_host_loops(src, lint.BFS_LOOP_SCOPE) == []
    lines = open(src, encoding="utf-8").read().split("\n")
    at = next(k for k, ln in enumerate(lines)
              if ln.strip().startswith("n = min(allowed - done"))
    indent = lines[at][:len(lines[at]) - len(lines[at].lstrip())]
    lines.insert(at + 1, indent + "probe = self._cs.st[0].item()")
    planted = tmp_path / "bfs.py"
    planted.write_text("\n".join(lines), encoding="utf-8")
    findings = lint.scan_host_loops(str(planted), lint.BFS_LOOP_SCOPE)
    assert len(findings) == 1
    f = findings[0]
    assert f.severity == ERROR and f.code == "blocking-read-in-loop"
    assert f.field.endswith(f":{at + 2}") and ".item()" in f.message


def test_lint_sanctions_timed_and_exit_reads(tmp_path):
    fixture = tmp_path / "hot_loop.py"
    fixture.write_text(textwrap.dedent("""\
        import time

        def drain(self, queue, mt):
            out = []
            while queue:
                x = queue.pop()
                out.append(x.tolist())               # unsanctioned
                t_s = time.time()
                out.append(x.cpu().numpy())          # timed sync phase
                self._phase("sync", time.time() - t_s)
                with mt.phase_timer("fetch"):
                    out.append(x.item())             # timed block
                with self._span("spill"):
                    ev.synchronize()                 # traced span
                if not out:
                    y = x.numpy()                    # exit branch
                    break
            return out
    """))
    findings = lint.scan_host_loops(str(fixture))
    assert [(f.code, f.field.rsplit(":", 1)[1]) for f in findings] \
        == [("blocking-read-in-loop", "7")]


def test_lint_graph_flags_host_sync_and_dynamic_shape():
    """A traced toy with ``nonzero``: a dynamic shape (ERROR); one with
    ``.item()``: the tracer refuses it, a host sync (ERROR); an int64
    -> int32 convert: a narrowing WARNING."""
    x = torch.arange(6, dtype=torch.int64)
    gm, fs = lint.trace_for_lint(lambda a: torch.nonzero(a > 2), [x], "toy")
    assert fs == []
    _s, findings = lint.lint_graph(gm, "toy")
    assert {f.code: f.severity for f in findings} \
        == {"dynamic-shape": ERROR}
    gm, fs = lint.trace_for_lint(lambda a: a[a > 2].sum(), [x], "toy2")
    _s, findings = lint.lint_graph(gm, "toy2")
    assert {f.code for f in findings if f.severity == ERROR} \
        == {"dynamic-shape"}
    gm, fs = lint.trace_for_lint(lambda a: a * int(a.sum().item()), [x],
                                 "toy3")
    assert gm is None
    assert [(f.code, f.severity) for f in fs] == [("host-sync", ERROR)]
    gm, _fs = lint.trace_for_lint(lambda a: (a + 1).to(torch.int32), [x],
                                  "toy4")
    _s, findings = lint.lint_graph(gm, "toy4")
    assert {f.code: f.severity for f in findings} \
        == {"narrowing-convert": WARNING}
    gm, _fs = lint.trace_for_lint(
        lambda v: torch.zeros(4).index_add_(0, v, torch.ones(6)),
        [torch.tensor([0, 1, 1, 2, 3, 3])], "toy5")
    _s, findings = lint.lint_graph(gm, "toy5")
    assert {f.code: f.severity for f in findings} \
        == {"nondet-reduction": WARNING}


def test_concurrent_traces_restore_the_tracer():
    """torch.fx's tracer patches ``torch.nn.Module`` while it traces, and
    ``kernels_as_launches`` the kernel wrappers; from many threads at
    once (more than the cores, a short switch interval, half of them
    bare traces) each trace still gets its graph and everything patched
    is restored afterwards."""
    import sys
    import threading

    from raft_tla_tpu_torch.ops import fpset_cuda
    module_call = torch.nn.Module.__call__
    insert_plain = fpset_cuda.insert_plain
    errors, graphs = [], []

    def work(k):
        try:
            if k % 2:
                gm = _trace(lambda a: (a + k) * 2, (1, 3))
            else:
                with lint.kernels_as_launches([]):
                    gm = _trace(lambda a: (a + k) * 2, (1, 3))
            graphs.append(len(gm.graph.nodes))
        except Exception as e:          # reported below, not lost
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(2 * (os.cpu_count() or 1) + 4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(graphs) == len(threads)
    assert torch.nn.Module.__call__ is module_call
    assert fpset_cuda.insert_plain is insert_plain


def test_lint_packing_convert_is_info_only():
    gm, _fs = lint.trace_for_lint(lambda a: (a & 0xFF).to(torch.uint8),
                                  [torch.arange(6, dtype=torch.int64)],
                                  "pack")
    _s, findings = lint.lint_graph(gm, "pack")
    assert {f.severity for f in findings} == {INFO}
    assert findings[0].code == "packing-converts"


# ---------------------------------------------------------------------------
# runner


def test_run_analysis_wires_obs(tmp_path):
    from raft_tla_tpu_torch.obs.events import RunEventLog
    from raft_tla_tpu_torch.obs.metrics import MetricsRegistry
    mt = MetricsRegistry()
    ev_path = tmp_path / "events.jsonl"
    with RunEventLog(str(ev_path)) as evlog:
        report = run_analysis(DIMS, init_states=[init_state(DIMS)],
                              passes=("bounds",),
                              lane_caps={"term": (0, 15)},
                              metrics=mt, evlog=evlog)
    assert not report.ok
    assert report.first_witness().startswith("Timeout")
    assert mt.counter_value("analysis/errors") >= 1
    events = [json.loads(line) for line in ev_path.read_text().splitlines()]
    assert [e["pass_name"] for e in events if e["event"] == "analysis"] \
        == ["bounds"]
    assert events[0]["witness"].startswith("Timeout")


def test_resolve_passes_dependencies():
    assert resolve_passes(("por",)) == ("effects", "por")
    assert resolve_passes(("lint",)) == ("effects", "lint")
    assert resolve_passes(("bounds",)) == ("bounds",)
    assert resolve_passes(("por", "bounds")) == ("effects", "bounds", "por")
    with pytest.raises(ValueError, match="typo"):
        resolve_passes(("typo",))
    with pytest.raises(ValueError):
        resolve_passes(())
