"""What the port's ``check`` prints and writes vs the JAX package.

- The state printouts (``models/pystate.py``: ``format_state``,
  ``state_fields``, ``diff_states``, ``format_message``) on states of
  oracle walks at MCraft_bounded, TPUraft and reconfig3 dims.
- ``tests/test_explain.py``'s seeded two-step NoLeader model through both
  engines (the JAX one on its default plan, the port's v3 on the CPU)
  with an events file and a counterexample directory: the files
  ``counterexample.{txt,json}``, ``render_html``, the reached graph, the
  event streams (apart from times and memory), the statespace report and
  the coverage.
- ``configs/MCraft_noleader.cfg`` through the port's CLI on the CPU, with
  EVENTS_OUT and COUNTEREXAMPLE_DIR as directives: the printout, the
  pinned ``counterexample.txt`` (``chip_smoke.py`` pins the same digest
  on the card) and the port's ``render_text`` of its replay against the
  JAX ``render_text`` of the same steps.  The JAX engine is not run to
  depth 9 here (``tests/test_explain.py`` marks that slow).
- ``check``'s violation printout under ``--no-trace`` and its deadlock
  printout, against the JAX CLI's text for the same state; ``explain``.
"""

import dataclasses
import hashlib
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tla_tpu.engine import explain as jexplain
from raft_tla_tpu.engine.bfs import BFSEngine as JEngine
from raft_tla_tpu.engine.bfs import EngineConfig as JConfig
from raft_tla_tpu.engine.bfs import Violation as JViolation
from raft_tla_tpu.models import oracle as orc
from raft_tla_tpu.models import pystate as jps
from raft_tla_tpu.models.dims import LEADER as JLEADER
from raft_tla_tpu.models.dims import RaftDims as JDims
from raft_tla_tpu.models.invariants import Bounds as JBounds
from raft_tla_tpu.models.invariants import build_constraint as j_constraint
from raft_tla_tpu.models.invariants import build_type_ok as j_type_ok
from raft_tla_tpu.models.invariants import constraint_py
from raft_tla_tpu.obs.events import validate_run_events as j_validate
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch import cli
from raft_tla_tpu_torch.engine import bfs as tbfs
from raft_tla_tpu_torch.engine import explain
from raft_tla_tpu_torch.engine.bfs import BFSEngine, EngineConfig
from raft_tla_tpu_torch.models import pystate as tps
from raft_tla_tpu_torch.models.dims import LEADER, RaftDims
from raft_tla_tpu_torch.models.invariants import (Bounds, build_constraint,
                                                  build_type_ok)
from raft_tla_tpu_torch.obs.events import validate_run_events
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOLEADER = os.path.join(REPO, "configs/MCraft_noleader.cfg")

#: sha256 of the port's counterexample.txt for configs/MCraft_noleader.cfg
#: (chip_smoke.py checks the same digest on the card, on both plans).
NOLEADER_TXT_SHA256 = (
    "98db3fbba10678ad7587b788b726986898941c397c5753de0ec772d496061c31")

DIMS_KW = dict(n_servers=3, n_values=2, max_log=4, n_msg_slots=32)
BOUNDS_KW = dict(max_term=2, max_log_len=1, max_msg_count=1)

#: Event fields that hold times or memory; every other field must match.
VOLATILE = {"ts", "elapsed_seconds", "phase_seconds", "unattributed_seconds",
            "wall_seconds", "memory", "devices_memory", "host_rss_peak_bytes",
            "stall_seconds", "counterexample_path"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(s):
    return tps.PyState(*dataclasses.astuple(s))


def to_jax(s):
    return jps.PyState(*dataclasses.astuple(s))


def to_jax_steps(steps):
    return [(g, to_jax(s)) for g, s in steps]


# ---------------------------------------------------------------------------
# The state printouts at three dims.

def walk_states(dims, bounds, roots, walks, length, seed):
    """States of seeded random oracle walks inside the constraint."""
    keep = constraint_py(bounds)
    rng = np.random.RandomState(seed)
    out = []
    for w in range(walks):
        s = roots[w % len(roots)]
        out.append(s)
        for _ in range(length):
            nxt = [t for _a, t in orc.successors(s, dims) if keep(t, dims)]
            if not nxt:
                break
            s = nxt[rng.randint(len(nxt))]
            out.append(s)
    return out


def leader_roots(jsetup):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from leader_bench import leader_states
    return leader_states(jsetup.dims, jsetup.bounds, 0)


@pytest.mark.parametrize("cfg", ["MCraft_bounded.cfg", "TPUraft.cfg",
                                 "reconfig3.cfg"])
def test_state_printouts_equal_jax(cfg):
    path = os.path.join(REPO, "configs", cfg)
    jsetup, setup = j_load_config(path), load_config(path)
    jd, td = jsetup.dims, setup.dims
    roots = [jps.init_state(jd)] + leader_roots(jsetup)
    states = walk_states(jd, jsetup.bounds, roots, walks=12, length=30,
                         seed=11)
    kinds = {m[0] for s in states for m, _c in s.messages}
    assert len(kinds) == 4, kinds         # every message type printed
    assert any(s.log[i] for s in states for i in range(td.n_servers))
    if cfg == "reconfig3.cfg":            # config entries: 2-byte values
        assert any(v > 255 for s in states for log in s.log
                   for _t, v in log)
    for prev, s in zip(states, states[1:]):
        t = to_port(s)
        assert tps.format_state(t, td) == jps.format_state(s, jd)
        assert tps.state_fields(t, td) == jps.state_fields(s, jd)
        assert tps.diff_states(to_port(prev), t, td) == \
            jps.diff_states(prev, s, jd)
        for m, _c in s.messages:
            assert tps.format_message(m, td) == jps.format_message(m, jd)
    assert "resp=" in tps.format_state(to_port(states[0]), td)
    assert tps.ROLE_NAMES == jps.ROLE_NAMES


# ---------------------------------------------------------------------------
# The seeded two-step model through both engines.

def seeded_root(init):
    """tests/test_explain.py's root: a candidate one vote short of
    quorum, two steps from a leader."""
    return dataclasses.replace(
        init, role=(1, 0, 0), current_term=(2, 2, 2), voted_for=(1, 1, 1),
        votes_responded=(0b001, 0, 0), votes_granted=(0b001, 0, 0),
        messages=frozenset({((1, 1, 0, 2, 1, ()), 1)}))


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    jdims, tdims = JDims(**DIMS_KW), RaftDims(**DIMS_KW)
    jbounds = JBounds(**BOUNDS_KW)
    tbounds = Bounds(**BOUNDS_KW)
    size = dict(batch=32, queue_capacity=1 << 12, seen_capacity=1 << 15,
                check_deadlock=False)
    out = {}
    jdir = tmp_path_factory.mktemp("jax")
    jeng = JEngine(jdims, invariants={
        "TypeOK": j_type_ok(jdims),
        "NoLeader": lambda st: jnp.all(st.role != JLEADER)},
        constraint=j_constraint(jdims, jbounds),
        config=JConfig(events_out=str(jdir / "events.jsonl"),
                       counterexample_dir=str(jdir), **size))
    jres = jeng.run([seeded_root(jps.init_state(jdims))])
    out["jax"] = (jeng, jres, jeng.replay(jres.violation.fingerprint), jdir)
    tdir = tmp_path_factory.mktemp("port")
    teng = BFSEngine(tdims, invariants={
        "TypeOK": build_type_ok(tdims),
        "NoLeader": lambda st: (st.role != LEADER).all(1)},
        constraint=build_constraint(tdims, tbounds),
        config=EngineConfig(events_out=str(tdir / "events.jsonl"),
                            counterexample_dir=str(tdir), **size),
        device="cpu")
    tres = teng.run([seeded_root(tps.init_state(tdims))])
    out["port"] = (teng, tres, teng.replay(tres.violation.fingerprint),
                   tdir)
    return out


def test_seeded_counterexample_files_equal_jax(seeded):
    _je, jres, jsteps, jdir = seeded["jax"]
    _te, tres, tsteps, tdir = seeded["port"]
    assert tres.stop_reason == jres.stop_reason == "violation"
    assert tres.violation.fingerprint == jres.violation.fingerprint
    assert tsteps == [(g, to_port(s)) for g, s in jsteps]
    for ext in ("txt", "json"):
        name = f"counterexample.{ext}"
        assert tres.counterexample[ext] == str(tdir / name)
        with open(tdir / name, "rb") as f, open(jdir / name, "rb") as g:
            assert f.read() == g.read(), name
    assert tres.counterexample["depth"] == jres.counterexample["depth"] == 2
    text = (tdir / "counterexample.txt").read_text()
    assert text == explain.render_text(tsteps, RaftDims(**DIMS_KW),
                                       violation=tres.violation)


def test_seeded_renderings_equal_jax(seeded):
    jeng, jres, jsteps, _jdir = seeded["jax"]
    teng, tres, tsteps, _tdir = seeded["port"]
    jd, td = jeng.dims, teng.dims
    for title in ("counterexample", "counterexample: NoLeader <&>"):
        assert explain.render_html(tsteps, td, violation=tres.violation,
                                   title=title) == \
            jexplain.render_html(jsteps, jd, violation=jres.violation,
                                 title=title)
    assert explain.render_json(tsteps, td, violation=tres.violation) == \
        jexplain.render_json(jsteps, jd, violation=jres.violation)
    assert explain.decode_steps(tsteps, td) == \
        jexplain.decode_steps(jsteps, jd)
    # The same nodes and edges; GraphML numbers its edges in the trace
    # store's record order, which the JAX native store does not keep.
    for fmt in ("dot", "graphml"):
        got, want = (re.sub(r'<edge id="e\d+"', "<edge", text).splitlines()
                     for text in (
                         explain.export_graph(teng.trace, td, fmt=fmt),
                         jexplain.export_graph(jeng.trace, jd, fmt=fmt)))
        assert sorted(got) == sorted(want) and got[0] == want[0]
    with pytest.raises(ValueError, match="cap"):
        explain.export_graph(teng.trace, td, cap=len(teng.trace) - 1)


def test_seeded_event_streams_equal_jax(seeded):
    _je, _jr, _js, jdir = seeded["jax"]
    _te, tres, _ts, tdir = seeded["port"]
    jev = j_validate(str(jdir / "events.jsonl"))
    tev = validate_run_events(str(tdir / "events.jsonl"))
    assert [e["event"] for e in tev] == [e["event"] for e in jev]
    assert [e["event"] for e in tev][:2] == ["run_start", "level_complete"]
    assert "violation" in [e["event"] for e in tev]
    for t, j in zip(tev, jev):
        assert set(t) == set(j), (t["event"], set(t) ^ set(j))
        assert {k: v for k, v in t.items() if k not in VOLATILE} == \
            {k: v for k, v in j.items() if k not in VOLATILE}, t["event"]
    end = tev[-1]
    assert end["counterexample_path"] == tres.counterexample["txt"]
    assert os.path.basename(end["counterexample_path"]) == \
        os.path.basename(jev[-1]["counterexample_path"])


def test_seeded_report_and_coverage_equal_jax(seeded):
    _je, jres, _js, _jd = seeded["jax"]
    _te, tres, _ts, _td = seeded["port"]
    assert tres.report == jres.report
    assert tres.coverage == jres.coverage
    assert tres.family_groups == jres.family_groups
    mem = {"hbm_peak_bytes", "hbm_bytes_in_use"}
    assert [{k: v for k, v in r.items() if k not in mem}
            for r in tres.level_stats] == \
        [{k: v for k, v in r.items() if k not in mem}
         for r in jres.level_stats]


# ---------------------------------------------------------------------------
# configs/MCraft_noleader.cfg through the CLI.

@pytest.fixture(scope="module")
def noleader_cli(tmp_path_factory):
    """``check`` on MCraft_noleader.cfg with EVENTS_OUT and
    COUNTEREXAMPLE_DIR directives; the engine the CLI built is kept."""
    import contextlib
    import io
    tmp = tmp_path_factory.mktemp("noleader")
    cfg = tmp / "MCraft_noleader.cfg"
    cfg.write_text(open(NOLEADER).read()
                   + f"\n\\* TPU: EVENTS_OUT = {tmp / 'ev.jsonl'}\n"
                   f"\\* TPU: COUNTEREXAMPLE_DIR = {tmp / 'ce'}\n")
    built = []
    make = cli.make_engine

    def keep(*a, **kw):
        built.append(make(*a, **kw))
        return built[-1]

    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(cli, "make_engine", keep)
        rc = cli.main(["check", str(cfg), "--device", "cpu",
                       "--metrics-out", str(tmp / "m.json"),
                       "--progress-interval", "0"])
    return rc, buf.getvalue(), tmp, built[0]


def test_noleader_cli_writes_the_pinned_counterexample(noleader_cli):
    rc, out, tmp, _engine = noleader_cli
    assert rc == 1
    txt = (tmp / "ce" / "counterexample.txt").read_bytes()
    assert hashlib.sha256(txt).hexdigest() == NOLEADER_TXT_SHA256
    doc = json.loads((tmp / "ce" / "counterexample.json").read_text())
    assert doc["depth"] == 9 and doc["invariant"] == "NoLeaderElected"
    # The printout: the result block, the file's text, where it went.
    assert "\n\n" + txt.decode() + "\ncounterexample written: " + \
        str(tmp / "ce" / "counterexample.txt") + " (+ .json)\n" in out
    assert "fp collision prob  " in out and "widest level       8 " in out
    events = validate_run_events(str(tmp / "ev.jsonl"))
    ss = [e for e in events if e["event"] == "statespace"]
    end = events[-1]
    assert len(ss) == 1 and end["event"] == "run_end"
    assert [r["frontier"] for r in ss[0]["report"]["levels"]] == \
        end["levels"]
    assert end["counterexample_path"] == str(tmp / "ce" /
                                             "counterexample.txt")
    snap = json.loads((tmp / "m.json").read_text())
    assert snap["counters"]["engine/generated"] == end["generated"]
    assert set(snap["histograms"]) >= {"phase/dispatch", "phase/host"}


def test_noleader_render_text_equals_jax_on_the_same_steps(noleader_cli):
    _rc, _out, tmp, engine = noleader_cli
    setup, jsetup = load_config(NOLEADER), j_load_config(NOLEADER)
    doc = json.loads((tmp / "ce" / "counterexample.json").read_text())
    viol = engine._result.violation
    steps = engine.replay(viol.fingerprint)
    assert hex(viol.fingerprint) == doc["fingerprint"]
    jviol = JViolation(invariant=viol.invariant, state=to_jax(viol.state),
                       fingerprint=viol.fingerprint)
    want = jexplain.render_text(to_jax_steps(steps), jsetup.dims,
                                violation=jviol)
    assert explain.render_text(steps, setup.dims, violation=viol) == want
    assert (tmp / "ce" / "counterexample.txt").read_text() == want
    for g, s in to_jax_steps(steps)[1:]:
        assert jsetup.dims.describe_instance(g) == \
            setup.dims.describe_instance(g)


# ---------------------------------------------------------------------------
# check's other printouts (C2) and explain.

ONE_SERVER = """CONSTANTS
    Server = {r1}
    Value = {v1}
    Follower = Follower
    Candidate = Candidate
    Leader = Leader
    Nil = Nil
    RequestVoteRequest = RequestVoteRequest
    RequestVoteResponse = RequestVoteResponse
    AppendEntriesRequest = AppendEntriesRequest
    AppendEntriesResponse = AppendEntriesResponse
    MaxTerm = 2
    MaxLogLen = 1
    MaxMsgCount = 1
SPECIFICATION Spec
INVARIANT NoLeaderElected
CONSTRAINT BoundedSpace
CHECK_DEADLOCK FALSE
"""


@pytest.fixture(scope="module")
def one_server_cfg(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one")
    path = tmp / "MCraft_one.cfg"
    path.write_text(ONE_SERVER)
    return str(path)


def test_no_trace_violation_prints_the_state_as_jax(one_server_cfg,
                                                     capsys):
    rc = cli.main(["check", one_server_cfg, "--device", "cpu",
                   "--no-trace", "--progress-interval", "0"])
    out = capsys.readouterr().out
    assert rc == 1
    traced = cli_run_state(one_server_cfg)
    jdims = j_load_config(one_server_cfg).dims
    want = ("\nviolating state (trace recording disabled):\n"
            + jps.format_state(to_jax(traced), jdims) + "\n")
    assert out.endswith(want)
    assert "counterexample written" not in out


def cli_run_state(cfg):
    from raft_tla_tpu_torch.engine.check import run_check
    res = run_check(cfg, EngineConfig(record_trace=False), device="cpu")
    return res.violation.state


def deadlocking_v2(monkeypatch):
    """The model with one more guard: no action is enabled in a state
    where a term reached 3, so the first such state is a deadlock."""
    build = tbfs.build_v2

    def build_v2(dims, device):
        v2 = build(dims, device)
        masks = v2.masks

        def guarded(st):
            en, ovf = masks(st)
            live = (st.term.max(1).values < 3)[:, None]
            return en & live, ovf & live

        return v2._replace(masks=guarded)

    monkeypatch.setattr(tbfs, "build_v2", build_v2)


def test_deadlock_prints_the_state_as_jax(monkeypatch, tmp_path, capsys):
    deadlocking_v2(monkeypatch)
    cfg = tmp_path / "dead.cfg"
    cfg.write_text(open(os.path.join(REPO, "configs/MCraft_bounded.cfg"))
                   .read().replace("CHECK_DEADLOCK FALSE", "")
                   + "\nCHECK_DEADLOCK TRUE\n")
    rc = cli.main(["check", str(cfg), "--device", "cpu",
                   "--progress-interval", "0", "--events-out",
                   str(tmp_path / "ev.jsonl")])
    out = capsys.readouterr().out
    assert rc == 1
    head, dead = out.split("\ndeadlock state:\n")
    assert "DEADLOCK reached" in head
    jdims = j_load_config(str(cfg)).dims
    setup = load_config(str(cfg))
    state = dead.rstrip("\n")
    # The state printed is the engine's deadlocked state, in the JAX
    # CLI's rendering (raft_tla_tpu/cli.py prints format_state of it).
    from raft_tla_tpu_torch.engine.check import make_engine, initial_states
    res = make_engine(setup, EngineConfig(), device="cpu").run(
        initial_states(setup))
    assert res.stop_reason == "deadlock"
    assert max(res.deadlock.current_term) == 3
    assert state == jps.format_state(to_jax(res.deadlock), jdims)
    ev = validate_run_events(str(tmp_path / "ev.jsonl"))
    assert [e["level"] for e in ev if e["event"] == "deadlock"] == \
        [res.diameter]


def test_explain_renders_json_html_and_graph(one_server_cfg, tmp_path,
                                             capsys):
    small = ["--batch", "64", "--queue-capacity", "4096",
             "--seen-capacity", "16384"]
    rc = cli.main(["explain", one_server_cfg, "--device", "cpu",
                   "--format", "json"] + small)
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1 and doc["invariant"] == "NoLeaderElected"
    html = tmp_path / "ce.html"
    graph = tmp_path / "g.dot"
    rc = cli.main(["explain", one_server_cfg, "--device", "cpu",
                   "--format", "html", "--out", str(html),
                   "--graph", str(graph)] + small)
    out = capsys.readouterr().out
    assert rc == 1 and f"-> {html}" in out and f"-> {graph}" in out
    assert html.read_text().startswith("<!doctype html>")
    assert graph.read_text().startswith("digraph statespace {")
    rc = cli.main(["explain", one_server_cfg, "--device", "cpu",
                   "--graph", str(graph), "--graph-cap", "1"] + small)
    assert rc == 1 and "over the graph-export cap" in \
        capsys.readouterr().err


def test_simulate_prints_the_trace_as_jax(one_server_cfg, capsys):
    """``simulate``'s violation block is the JAX CLI's: ``-- <action>``
    and the JAX ``format_state`` of each state."""
    from raft_tla_tpu_torch.engine.check import (initial_states,
                                                 make_simulator)
    args = ["--device", "cpu", "--batch", "16", "--num-steps", "4096",
            "--depth", "20", "--seed", "5"]
    rc = cli.main(["simulate", one_server_cfg] + args)
    out = capsys.readouterr().out
    assert rc == 1
    setup = load_config(one_server_cfg)
    jdims = j_load_config(one_server_cfg).dims
    res = make_simulator(setup, batch=16, depth=20, device="cpu").run(
        initial_states(setup), num_steps=4096, seed=5)
    want = "".join(
        f"-- {'Initial state' if g < 0 else jdims.describe_instance(g)}\n"
        + jps.format_state(to_jax(st), jdims) + "\n"
        for g, st in res.violation_trace)
    assert out.endswith("VIOLATION          NoLeaderElected\n" + want)


def test_swarm_writes_and_prints_its_counterexample(tmp_path, capsys):
    """``check --mode swarm``: counterexample.{txt,json} and the run
    events as the JAX swarm writes them, the printout read from the
    file (the CI canary's run)."""
    ce, ev = tmp_path / "ce", tmp_path / "ev.jsonl"
    rc = cli.main(["check", NOLEADER, "--mode", "swarm", "--device", "cpu",
                   "--walks", "256", "--max-depth", "16", "--seed", "3",
                   "--counterexample-dir", str(ce), "--events-out",
                   str(ev)])
    out = capsys.readouterr().out
    assert rc == 1
    txt = (ce / "counterexample.txt").read_text()
    assert txt.startswith("Error: Invariant NoLeaderElected is violated "
                          "(fingerprint 0xd6467ee051491c1d).\n")
    assert "\n\n" + txt + f"\ncounterexample written: {ce}/" \
        "counterexample.txt (+ .json)\n" in out
    assert json.loads((ce / "counterexample.json").read_text())["depth"] \
        == 9
    events = validate_run_events(str(ev))
    names = [e["event"] for e in events]
    assert names[0] == "run_start" and names[-2:] == ["statespace",
                                                      "run_end"]
    assert "swarm_progress" in names
    assert events[-1]["counterexample_path"] == str(ce /
                                                    "counterexample.txt")
    assert events[-1]["swarm"]["visited"] == 2802
