"""The port's POR pass (``raft_tla_tpu_torch/analysis/por.py``), its
in-process certification (``EngineConfig.por``, ``check --por``) and the
``analyze`` subcommand, held to

- the JAX tests' literal pins (``tests/test_por.py``): nothing certifies
  on the Raft alphabet, every family is blocked by closure and the block
  is machine-checked (``open == []``), Receive's case split is row-local
  to its destination (``4 N^2`` cases), the one-shot self-disabling
  proof holds and Timeout's does not, the predicate read sets;
- the live JAX package where its output does not depend on the
  installed jax: the table's sha256 fingerprint from ``build_table`` at
  the seed dims and at MCraft_bounded's (all-zero mask), the ``por``
  table's text rendering on the same summary, ``load_table`` on the
  port's artifact, and the ``analyze --json`` report's keys, pass order,
  ``por`` summary head and the ERROR/WARNING counts of lint and por;
- the JAX oracle's level counts for a POR-on run.

``RaftDims(3, 2, 3, 4)`` with ``tests/test_por.py``'s bounds, on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from raft_tla_tpu import cli as jcli
from raft_tla_tpu.analysis import por as jpor
from raft_tla_tpu.analysis.report import render_por_table as jrender
from raft_tla_tpu.models import invariants as jinv
from raft_tla_tpu.models import oracle as jorc
from raft_tla_tpu.models.dims import RaftDims as JDims
from raft_tla_tpu.models.pystate import init_state as jinit
from raft_tla_tpu.utils.cfg import load_config as jload
from raft_tla_tpu_torch import cli
from raft_tla_tpu_torch.analysis import effects, interp, lint, por
from raft_tla_tpu_torch.analysis.report import render_por_table
from raft_tla_tpu_torch.engine.bfs import BFSEngine, EngineConfig
from raft_tla_tpu_torch.models.dims import RaftDims
from raft_tla_tpu_torch.models.invariants import (Bounds, build_constraint,
                                                  build_type_ok)
from raft_tla_tpu_torch.models.pystate import init_state
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs", "MCraft_bounded.cfg")
DIMS = RaftDims(n_servers=3, n_values=2, max_log=3, n_msg_slots=4)
J_DIMS = JDims(n_servers=3, n_values=2, max_log=3, n_msg_slots=4)
BOUNDS = Bounds(max_term=2, max_log_len=1, max_msg_count=1)
J_BOUNDS = jinv.Bounds(max_term=2, max_log_len=1, max_msg_count=1)
SMALL = ["--max-log", "3", "--n-msg-slots", "4"]


@pytest.fixture(scope="module", autouse=True)
def _release_tracing_caches():
    """One PyTorch thread (the small engine runs gain nothing from more),
    and the traced graphs dropped at module teardown."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    import gc
    torch.set_num_threads(threads)
    import jax

    from raft_tla_tpu.analysis import interp as jinterp
    interp.traced_kernels.cache_clear()
    por._model_proofs.cache_clear()
    lint.traced_engine_kernels.cache_clear()
    jinterp.traced_kernels.cache_clear()
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def effect_summary():
    summary, _ = effects.analyze(DIMS)
    return summary


@pytest.fixture(scope="module")
def pass_result(effect_summary):
    return por.analyze(DIMS, bounds=BOUNDS, effect_summary=effect_summary)


@pytest.fixture(scope="module")
def jax_analyze(tmp_path_factory):
    """The JAX CLI's ``analyze --json --por-artifact F`` at the small
    dims, run once: ``(report, F)``.  Its exit code is not held (under
    some jax versions the JAX bounds pass reports ERRORs of its own)."""
    import contextlib
    import io
    art = tmp_path_factory.mktemp("jax_analyze") / "jpor.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jcli.main(["analyze", *SMALL, "--json",
                          "--por-artifact", str(art)]) in (0, 1)
    return json.loads(out.getvalue()), art


@pytest.fixture(scope="module")
def port_analyze(tmp_path_factory):
    """The port's ``analyze --json`` at the small dims, run once with
    every output flag: ``(exit code, stdout report, directory)``."""
    import contextlib
    import io
    d = tmp_path_factory.mktemp("port_analyze")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["analyze", *SMALL, "--json",
                       "--out", str(d / "report.json"),
                       "--por-artifact", str(d / "por.json"),
                       "--metrics-out", str(d / "metrics.json"),
                       "--events-out", str(d / "events.jsonl")])
    return rc, json.loads(out.getvalue()), d


# ---------------------------------------------------------------------------
# The pass: the JAX tests' pins


def test_pass_is_clean_and_honestly_conservative(pass_result):
    summary, findings = pass_result
    assert [f for f in findings if f.severity == "ERROR"] == []
    assert summary["certified"] == 0
    assert summary["n_instances"] == DIMS.n_instances
    widened = {f.field for f in findings if f.code == "por-widened"}
    assert widened == set(DIMS.family_names)
    for fam, d in summary["families"].items():
        assert d["certified"] == 0
        assert d["blocked_by"].get("closure", 0) == d["instances"], fam
        top = d["blocking_elements"]
        assert top and {"family", "element", "kind", "pairs"} \
            <= set(top[0]), fam


def test_closure_block_is_machine_checked_impossible(pass_result):
    summary, findings = pass_result
    ref = summary["closure_refutation"]
    assert ref["ran"] and ref["open"] == []
    assert ref["witnessed"] + ref["vacuous"] == summary["n_instances"]
    imposs = {f.field for f in findings if f.code == "por-impossible"}
    assert imposs == set(DIMS.family_names)
    w = summary["families"]["DuplicateMessage"]["closure_refutation"][
        "witnesses"][0]
    assert w["status"] == "witnessed" and w["conflicts_with"]
    assert w["kind"] in ("disables", "disabled-by", "diamond")
    # The vacuous instances are exactly AppendEntries(i, i).
    ae = summary["families"]["AppendEntries"]["closure_refutation"]
    assert ae["vacuous"] == DIMS.n_servers == ref["vacuous"]


def test_receive_case_split_slot_local(pass_result, effect_summary):
    summary, _ = pass_result
    cs = summary["families"]["Receive"]["case_split"]
    assert cs["cases"] == 4 * DIMS.n_servers * DIMS.n_servers
    assert cs["server_writes_row_local"] == cs["cases"]
    cases = effects.receive_case_effects(DIMS, slot=0)
    recv = next(i for i in effect_summary.instances
                if i.label == "Receive(slot=0)")
    server_fields = {"term", "role", "voted_for", "votes_resp",
                     "votes_gran", "log_term", "log_val", "log_len",
                     "next_idx", "match_idx"}
    for (t, i, j), fp in cases.items():
        for f, m in fp["writes"].items():
            assert not (m & ~recv.writes[f]).any(), (t, i, j, f)
            if f in server_fields:
                assert set(np.nonzero(m)[0].tolist()) <= {i}, (t, i, j, f)
    # AER on a known (i, j): the handler's footprint is cell-local.
    aer = cases[(3, 1, 2)]["writes"]
    assert aer["next_idx"][1][2] and aer["next_idx"].sum() == 1
    assert aer["msg_cnt"].tolist() == [1] + [0] * (DIMS.n_msg_slots - 1)


def test_predicate_read_sets(pass_result):
    from raft_tla_tpu_torch.analysis.lane_map import FIELDS
    summary, _ = pass_result
    reads = summary["predicates"]
    assert set(reads["TypeOK"]) == set(FIELDS)
    assert set(reads["CONSTRAINT"]) == {"term", "log_len", "msg_cnt"}


def test_self_disabling_proof():
    """C3: a one-shot toy action (guard ``role[0] == 0``, write ``role[0]
    = 1``) proves; Timeout (a candidate can time out again) does not."""
    def one_shot(st):
        en = st.role[:, :1] == 0
        ar = torch.arange(st.role.shape[1])
        succ = st._replace(role=torch.where(ar[None, :] == 0, 1, st.role))
        return en, torch.zeros_like(en), tuple(succ)

    graph = interp.trace_family(one_shot, DIMS, 0)
    env = por._envelope_intervals(DIMS, BOUNDS)
    proved, _notes = por.self_disabling(graph, (), env)
    assert proved
    timeout = next(g for name, g, _p in interp.traced_kernels(DIMS)
                   if name == "Timeout")
    proved, _notes = por.self_disabling(timeout, (0,), env)
    assert not proved


def test_render_por_table_equals_jax(pass_result):
    summary, _ = pass_result
    text = render_por_table(summary)
    assert text == jrender(summary)
    assert "top blocking element" in text and "inherent" in text
    assert "closure refutation: " in text


def test_refutation_totals_exclude_certified_instances():
    certified = por.Certificate(
        grid_index=0, family="X", label="X(i=0)",
        conditions={c: (True, "ok") for c in por.CONDITIONS})
    blocked = por.Certificate(
        grid_index=1, family="X", label="X(i=1)",
        conditions=dict({c: (True, "ok") for c in por.CONDITIONS},
                        closure=(False, "dependent")))
    refs = {"X(i=0)": por.ClosureRefutation("X(i=0)", "open"),
            "X(i=1)": por.ClosureRefutation(
                "X(i=1)", "witnessed", "Y(i=1)", "diamond", 0)}
    assert por._refutation_totals([certified, blocked], refs) \
        == {"ran": True, "witnessed": 1, "vacuous": 0, "open": []}
    assert por._refutation_totals([certified, blocked], {}) \
        == {"ran": False, "witnessed": 0, "vacuous": 0, "open": []}


# ---------------------------------------------------------------------------
# The table: one fingerprint for both packages


@pytest.mark.parametrize("which", ["seed", "MCraft_bounded"])
def test_build_table_fingerprint_equals_jax(which):
    if which == "seed":
        pd, pb, jd, jb = DIMS, BOUNDS, J_DIMS, J_BOUNDS
    else:
        p, j = load_config(BOUNDED), jload(BOUNDED)
        pd, pb, jd, jb = p.dims, p.bounds, j.dims, j.bounds
    table = por.build_table(pd, invariants={"TypeOK": build_type_ok(pd)},
                            constraint=build_constraint(pd, pb))
    jtable = jpor.build_table(jd, invariants={"TypeOK":
                                              jinv.build_type_ok(jd)},
                              constraint=jinv.build_constraint(jd, jb))
    assert table.certified == 0 and not table.ample_mask.any()
    assert table.payload() == jtable.payload()
    assert table.fingerprint == jtable.fingerprint
    # A repeat build of the model (fresh predicates) reuses its effects
    # and proviso proofs and gives the same table.
    hits = por._model_proofs.cache_info().hits
    again = por.build_table(pd, invariants={"TypeOK": build_type_ok(pd)},
                            constraint=build_constraint(pd, pb))
    assert por._model_proofs.cache_info().hits == hits + 1
    assert again.payload() == table.payload()
    por.check_table(table, pd, invariant_names=["TypeOK"],
                    has_constraint=True)


# ---------------------------------------------------------------------------
# The engine and the CLI


@pytest.mark.parametrize("pipeline", ["v3", "v4"])
def test_por_true_certifies_in_process_and_runs_unreduced(pipeline):
    """``EngineConfig(por=True)`` certifies in process (nothing on the
    Raft alphabet) and runs the exact body of a run without POR: the JAX
    oracle's L5 counts, no instance applied, nothing pruned."""
    def run(**kw):
        eng = BFSEngine(DIMS, invariants={"TypeOK": build_type_ok(DIMS)},
                        constraint=build_constraint(DIMS, BOUNDS),
                        config=EngineConfig(
                            batch=64, queue_capacity=1 << 12,
                            seen_capacity=1 << 14, max_diameter=5,
                            check_deadlock=False, pipeline=pipeline, **kw),
                        device="cpu")
        return eng, eng.run([init_state(DIMS)])

    eng, on = run(por=True)
    assert eng._por_table is not None and eng._por_table.certified == 0
    _eng, off = run()
    assert on.por_instances == 0
    assert sum(v["pruned"] for v in on.coverage.values()) == 0
    assert (on.distinct, on.generated, on.levels) \
        == (off.distinct, off.generated, off.levels)
    want = jorc.bfs([jinit(J_DIMS)], J_DIMS,
                    invariants={"TypeOK": jinv.type_ok_py},
                    constraint=jinv.constraint_py(J_BOUNDS),
                    check_deadlock=False, max_levels=5)
    assert on.violation is None and want.invariant_violation is None
    assert on.distinct == want.distinct_states
    assert on.levels == want.levels


TINY_CFG = (
    "CONSTANTS\n    Server = {r1, r2}\n    Value = {v1}\n"
    "    MaxTerm = 2\n    MaxLogLen = 1\n    MaxMsgCount = 1\n"
    "SPECIFICATION Spec\nINVARIANT TypeOK\nCONSTRAINT BoundedSpace\n"
    "CHECK_DEADLOCK FALSE\n"
    "\\* TPU: MAX_LOG = 2\n\\* TPU: N_MSG_SLOTS = 8\n")


def test_cli_check_por_equals_jax_counts(tmp_path, capsys):
    """``check --por`` runs, certifying in process, and prints the JAX
    CLI's counts (the JAX oracle's, on ``tests/test_por.py``'s tiny
    cfg); ``check --por-table`` with the artifact ``analyze --passes
    por`` wrote for the same cfg (after the effects pass it needs)
    prints them too."""
    cfg = tmp_path / "tiny.cfg"
    cfg.write_text(TINY_CFG)
    j = jload(str(cfg))
    want = jorc.bfs([jinit(j.dims)], j.dims,
                    invariants={"TypeOK": jinv.type_ok_py},
                    constraint=jinv.constraint_py(j.bounds),
                    check_deadlock=False, max_levels=4)
    art = tmp_path / "por.json"
    assert cli.main(["analyze", str(cfg), "--passes", "por", "--json",
                     "--por-artifact", str(art)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and list(rep["passes"]) == ["effects", "por"]
    for flag in (["--por"], ["--por-table", str(art)]):
        assert cli.main(["check", str(cfg), "--platform", "cpu",
                         "--max-diameter", "4", "--progress-interval", "0",
                         "--no-report", *flag]) == 0
        out = capsys.readouterr().out
        assert f"distinct states    {want.distinct_states}\n" in out, flag


def test_cli_analyze_por_artifact_crosses_packages(port_analyze,
                                                  jax_analyze):
    """``analyze --por-artifact F``: the report's ``por`` summary, a
    table ``check --por-table F`` applies and the JAX package's
    ``load_table`` accepts, with the fingerprint the JAX ``analyze``
    writes for the same model."""
    _rc, rep, d = port_analyze
    art = d / "por.json"
    assert rep["passes"]["effects"]["summary"]["independent_pairs"] > 0
    summ = rep["passes"]["por"]["summary"]
    assert summ["certified"] == 0 and summ["table"]["fingerprint"]
    table = por.load_table(str(art))
    jtable = jpor.load_table(str(art))
    assert table.fingerprint == jtable.fingerprint \
        == summ["table"]["fingerprint"]
    assert por.load_table(str(jax_analyze[1])).fingerprint \
        == table.fingerprint


def test_cli_analyze_report_matches_jax(port_analyze, jax_analyze):
    """The whole ``analyze --json`` report against the JAX CLI's on the
    parts that do not depend on the installed jax: the keys, the pass
    order, the ``por`` summary's head and table, and the ERROR and
    WARNING counts of the ``por`` pass and the ERROR count of ``lint``
    (its kernels are the port's own: v1/v3/v4 chunk steps whose int64
    counters narrow to int32, which the JAX step never does), and the
    ``--out`` file equals stdout.  The exit code gates on errors."""
    rc, port, d = port_analyze
    assert rc == (0 if port["ok"] else 1) == 0
    assert json.loads((d / "report.json").read_text()) == port
    jax_rep = jax_analyze[0]
    assert set(port) == set(jax_rep)
    assert list(port["passes"]) == list(jax_rep["passes"]) \
        == ["bounds", "effects", "lint", "por"]
    for name in port["passes"]:
        assert set(port["passes"][name]) == set(jax_rep["passes"][name])
    ps, js = port["passes"]["por"]["summary"], \
        jax_rep["passes"]["por"]["summary"]
    assert set(ps) == set(js)
    for k in ("certified", "n_instances", "table"):
        assert ps[k] == js[k], k
    pc, jc = (r["passes"]["por"]["severity_counts"]
              for r in (port, jax_rep))
    assert (pc["ERROR"], pc["WARNING"]) == (jc["ERROR"], jc["WARNING"])
    assert port["passes"]["lint"]["severity_counts"]["ERROR"] \
        == jax_rep["passes"]["lint"]["severity_counts"]["ERROR"] == 0
    m = json.loads((d / "metrics.json").read_text())
    assert m["counters"]["analysis/errors"] == 0
    events = [json.loads(x)
              for x in (d / "events.jsonl").read_text().splitlines()]
    assert [e["pass_name"] for e in events if e["event"] == "analysis"] \
        == ["effects", "bounds", "lint", "por"]


def test_cli_analyze_gate_and_usage_errors(capsys):
    rc = cli.main(["analyze", *SMALL, "--passes", "bounds",
                   "--shrink-lane", "term=15", "--json"])
    assert rc == 1
    rep = json.loads(capsys.readouterr().out)
    errs = [f for f in rep["passes"]["bounds"]["findings"]
            if f["severity"] == "ERROR"]
    assert errs and errs[0]["witness"].startswith("Timeout")
    assert cli.main(["analyze", *SMALL, "--passes", "bounds",
                     "--shrink-lane", "term=15",
                     "--allow", "lane-overflow:term", "--json"]) == 0
    capsys.readouterr()
    assert cli.main(["analyze", *SMALL, "--passes", "bogus"]) == 2
    err = capsys.readouterr().err
    assert "bogus" in err and "por" in err and "effects" in err
    assert cli.main(["analyze", *SMALL, "--passes", ","]) == 2
    capsys.readouterr()
    assert cli.main(["analyze", *SMALL, "--passes", "effects",
                     "--por-artifact", "x.json"]) == 2
    assert "requires the 'por' pass" in capsys.readouterr().err
