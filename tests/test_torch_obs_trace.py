"""The port's span tracer, flight recorder, Prometheus exposition and
history ledger against the JAX package's, on the CPU.

- ``obs/tracing.py``: a traced check to L5 gives the JAX engine's span
  names (and the port's ``setup`` and ``finish``), one ``run`` span, a
  ``level`` span a level, and per level the same count of each JAX span;
  the file passes the JAX validator.
- ``obs/flight.py``: ring eviction and the progress rate limit as the JAX
  recorder's; an invariant that raises leaves ``postmortem.json`` with
  the JAX dump's keys and its path on ``run_end``; a ``check`` child that
  receives SIGTERM dumps and dies of the signal.
- ``obs/expose.py``: Prometheus text byte-equal to the JAX rendering of
  the same snapshot, the JAX parser's verdicts, and ``/metrics``,
  ``/flight`` and ``/jobs`` scraped from a running check.
- ``obs/history.py``: an entry equal to the JAX entry of the same run,
  apart from the host and time fields and the plan's stage names.
"""

import collections
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from raft_tla_tpu.engine.bfs import BFSEngine as JEngine
from raft_tla_tpu.engine.bfs import EngineConfig as JConfig
from raft_tla_tpu.models.invariants import build_constraint as j_constraint
from raft_tla_tpu.models.pystate import init_state as j_init_state
from raft_tla_tpu.obs import expose as jexpose
from raft_tla_tpu.obs import flight as jflight
from raft_tla_tpu.obs import history as jhistory
from raft_tla_tpu.obs.tracing import validate_chrome_trace
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch.engine.bfs import BFSEngine, EngineConfig
from raft_tla_tpu_torch.models.invariants import build_constraint
from raft_tla_tpu_torch.models.pystate import init_state
from raft_tla_tpu_torch.obs import expose, flight, history
from raft_tla_tpu_torch.obs.metrics import MetricsRegistry
from raft_tla_tpu_torch.obs.tracing import SpanTracer
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")
CONFIG = dict(batch=128, queue_capacity=1 << 14, seen_capacity=1 << 16,
              record_trace=True, check_deadlock=False, max_diameter=5,
              pipeline="v3")

# Entry fields that name the host, the clock or the plan's lowerings.
HOST_TIME = {"ts", "host_fingerprint", "host_key", "wall_seconds",
             "distinct_per_sec", "generated_per_sec", "fused_stages"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_traced(tmp_path_factory):
    """The JAX engine's traced check to L5, its trace and its result."""
    d = tmp_path_factory.mktemp("jax")
    setup = j_load_config(BOUNDED)
    eng = JEngine(setup.dims, constraint=j_constraint(setup.dims,
                                                      setup.bounds),
                  config=JConfig(trace_out=str(d / "t.json"), **CONFIG))
    res = eng.run([j_init_state(setup.dims)])
    return res, validate_chrome_trace(str(d / "t.json"))


@pytest.fixture(scope="module")
def port_traced(tmp_path_factory):
    d = tmp_path_factory.mktemp("port")
    setup = load_config(BOUNDED)
    eng = BFSEngine(setup.dims, constraint=build_constraint(setup.dims,
                                                            setup.bounds),
                    config=EngineConfig(trace_out=str(d / "t.json"),
                                        **CONFIG), device="cpu")
    res = eng.run([init_state(setup.dims)])
    return res, validate_chrome_trace(str(d / "t.json"))


def per_level_spans(events):
    """``[Counter of span names inside each level span]`` in level order,
    and the names of every complete span."""
    spans = [e for e in events if e["ph"] == "X"]
    levels = sorted((e for e in spans if e["name"] == "level"),
                    key=lambda e: e["ts"])
    out = []
    for lv in levels:
        lo, hi = lv["ts"], lv["ts"] + lv["dur"]
        out.append(collections.Counter(
            e["name"] for e in spans
            if e["name"] not in ("level", "run")
            and lo <= e["ts"] and e["ts"] + e["dur"] <= hi))
    return out, {e["name"] for e in spans}


def test_traced_check_has_the_jax_spans(jax_traced, port_traced):
    jres, jev = jax_traced
    res, ev = port_traced
    assert (res.distinct, res.levels) == (jres.distinct, jres.levels)
    jlevels, jnames = per_level_spans(jev)
    levels, names = per_level_spans(ev)
    # The JAX spans, and beyond them only the port's own: the run's
    # set-up and end, a graph's capture (on the card) and a long
    # garbage collection.
    assert jnames <= names
    assert {"setup", "finish"} <= names - jnames \
        <= {"setup", "finish", "capture", "gc"}
    assert len(levels) == len(res.levels) == len(jlevels)
    assert [{k: c[k] for k in c if k in jnames} for c in levels] == jlevels
    runs = [e for e in ev if e["name"] == "run"]
    assert len(runs) == 1
    # The run span holds every other span.
    lo, hi = runs[0]["ts"], runs[0]["ts"] + runs[0]["dur"]
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi
               for e in ev if e["ph"] == "X")


def test_span_tracer_unit_equals_jax(tmp_path):
    from raft_tla_tpu.obs.tracing import SpanTracer as JTracer
    shapes = []
    for cls, name in ((SpanTracer, "p"), (JTracer, "j")):
        tr = cls(str(tmp_path / f"{name}.json"))
        with tr.span("outer", a=1):
            with tr.span("inner"):
                pass
            tr.instant("mark", b=2)
        tr.write()
        ev = validate_chrome_trace(str(tmp_path / f"{name}.json"))
        shapes.append([(e["name"], e["ph"], sorted(e.get("args", {})))
                       for e in ev if e["ph"] != "M"])
        off = cls(None)
        with off.span("x"):
            pass
        assert len(off) == 0 and off.write() is None
    assert shapes[0] == shapes[1]
    # The registry mirrors a phase_timer block into a span.
    mt, tr = MetricsRegistry(), SpanTracer(str(tmp_path / "m.json"))
    mt.tracer = tr
    with mt.phase_timer("stats_fetch"):
        pass
    assert [e["name"] for e in tr._events if e["ph"] == "X"] \
        == ["stats_fetch"]


def test_history_entry_equals_jax(jax_traced, port_traced):
    jres, _ = jax_traced
    res, _ = port_traced
    text = open(BOUNDED).read()
    jdims, dims = j_load_config(BOUNDED).dims, load_config(BOUNDED).dims
    jentry = jhistory.entry_from_result(
        "check", jres, cfg_text=text, dims=jdims,
        host_fingerprint=jflight.host_fingerprint(), label="b")
    entry = history.entry_from_result(
        "check", res, cfg_text=text, dims=dims,
        host_fingerprint=flight.host_fingerprint(), label="b")
    assert set(entry) == set(jentry)
    assert {k: v for k, v in entry.items() if k not in HOST_TIME} \
        == {k: v for k, v in jentry.items() if k not in HOST_TIME}
    assert entry["host_key"] and entry["host_fingerprint"]["torch"]


def test_flight_ring_equals_jax():
    def drive(rec):
        for i in range(6):
            rec.record("a", i=i)
        rec.record("b", x=1)
        got = [rec.progress(n=i) is not None for i in range(3)]
        snap = rec.snapshot()
        return ({k: [{f: v for f, v in r.items() if f != "ts"}
                     for r in recs] for k, recs in snap.items()}, got,
                rec.last_record("a")["i"])
    assert drive(flight.FlightRecorder(capacity=4)) \
        == drive(jflight.FlightRecorder(capacity=4))


def test_postmortem_after_a_raising_invariant_equals_jax(tmp_path):
    def boom(_st):
        raise RuntimeError("invariant boom")
    # The rings are process-wide: records an earlier test's run left (a
    # hunted swarm's, say) are not this run's.
    flight.RECORDER.clear()
    jflight.RECORDER.clear()
    docs = []
    for name, eng_cls, cfg_cls, setup, cons, root, dev in (
            ("j", JEngine, JConfig, j_load_config(BOUNDED), j_constraint,
             j_init_state, {}),
            ("p", BFSEngine, EngineConfig, load_config(BOUNDED),
             build_constraint, init_state, {"device": "cpu"})):
        d = tmp_path / name
        ev = d / "e.jsonl"
        eng = eng_cls(setup.dims, invariants={"Boom": boom},
                      constraint=cons(setup.dims, setup.bounds),
                      config=cfg_cls(postmortem_dir=str(d),
                                     events_out=str(ev), **CONFIG), **dev)
        with pytest.raises(Exception, match="invariant boom"):
            eng.run([root(setup.dims)])
        pm = d / "postmortem.json"
        doc = json.loads(pm.read_text())
        end = [json.loads(x) for x in ev.read_text().splitlines()][-1]
        assert end["event"] == "run_end" and end["stop_reason"] == "error"
        assert end["postmortem_path"] == str(pm)
        docs.append(doc)
    jdoc, doc = docs
    assert set(doc) == set(jdoc)
    assert set(doc["context"]) == set(jdoc["context"])
    assert doc["reason"] == jdoc["reason"]
    assert set(doc["records"]) <= set(jdoc["records"]) | {"progress"}
    assert not flight.RECORDER.armed


def test_prometheus_text_equals_jax():
    mt = MetricsRegistry()
    mt.counter("engine/distinct", 527)
    mt.counter("engine/generated", 1191.0)
    mt.gauge("engine/seen_load", 0.25)
    mt.gauge("hunt/saturation", 0.9465)
    for v in (0.001, 0.02, 0.02, 3.5):
        mt.observe("phase/dispatch", v)
    snap = mt.snapshot()
    for labels in (None, {"host": "1"}):
        text = expose.render_prometheus(snap, labels=labels)
        assert text == jexpose.render_prometheus(snap, labels=labels)
        assert expose.parse_prometheus(text) \
            == jexpose.parse_prometheus(text)
    for bad in ("raft_x{le=} 1\n", "raft_y 1 2 3\n",
                "# TYPE a counter\n# TYPE a counter\n"):
        for parse in (expose.parse_prometheus, jexpose.parse_prometheus):
            with pytest.raises(ValueError):
                parse(bad)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def get(url: str):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read().decode()


def test_scrape_a_running_check_then_sigterm_dumps(tmp_path):
    """A check child on the CPU: ``/metrics`` parses with both parsers
    and counts the run, ``/flight`` holds its ring, ``/jobs`` answers as
    the JAX listener without a job registry; SIGTERM leaves a postmortem
    and kills with the signal."""
    port, ck = free_port(), tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    p = subprocess.Popen(
        [sys.executable, "-m", "raft_tla_tpu_torch", "check", BOUNDED,
         "--device", "cpu", "--batch", "64", "--max-diameter", "12",
         "--checkpoint-dir", str(ck), "--checkpoint-interval", "1000",
         "--metrics-port", str(port)],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline, samples = time.time() + 120, None
        while time.time() < deadline:
            try:
                samples = expose.parse_prometheus(
                    get(f"http://127.0.0.1:{port}/metrics"))
            except OSError:
                samples = None
            if samples and (expose.counter_sample(samples,
                                                  "engine/distinct") or 0) \
                    > 100:
                break
            assert p.poll() is None, p.communicate()[1][-2000:]
            time.sleep(0.2)
        assert samples, "no /metrics before the deadline"
        text = get(f"http://127.0.0.1:{port}/metrics")
        assert jexpose.parse_prometheus(text)
        fl = json.loads(get(f"http://127.0.0.1:{port}/flight?last=4"))
        assert fl["ok"] and fl["armed"] and fl["records"]["event"]
        assert json.loads(get(f"http://127.0.0.1:{port}/jobs")) == {
            "ok": False, "error": "no job manager"}
        p.send_signal(signal.SIGTERM)
        _out, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == -signal.SIGTERM, err[-2000:]
    doc = json.loads((ck / "postmortem.json").read_text())
    assert doc["reason"] == "sigterm" and doc["postmortem"] is True
    assert doc["records"]["progress"] and doc["context"]["engine"] \
        == "BFSEngine"
    assert doc["host"]["torch"] == torch.__version__
