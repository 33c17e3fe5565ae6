"""The port's checker service (``raft_tla_tpu_torch/server.py``) against
the JAX package's, in one process.

The same newline-delimited JSON requests go to both servers
(``serve(port=0)``: the JAX one on the CPU, the port's with
``device="cpu"``), and the responses must be equal field for field,
seconds left out: the counts, levels, per-family counts, the statespace
report and the coverage of a check; the noleader violation's trace text;
the swarm canary's numbers; the ``stats`` document's keys and the server's
metric names in it and in the Prometheus exposition.  Also the port's
own: the warm engine and its per-request budgets, eviction releasing an
engine, the connection hardening, ``--metrics-port``, ``watch``, a
server for ``cuda`` without a card raising at start, and ``python -m
raft_tla_tpu_torch.server``.
"""

import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

from raft_tla_tpu import server as jsrv
from raft_tla_tpu_torch import server as tsrv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")
NOLEADER = os.path.join(REPO, "configs/MCraft_noleader.cfg")
SMALL = {"batch": 128, "queue_capacity": 1 << 12, "seen_capacity": 1 << 15,
         "check_deadlock": False}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread; at the end, the process-wide flight rings
    emptied of this module's runs."""
    from raft_tla_tpu.obs.flight import RECORDER as JRECORDER
    from raft_tla_tpu_torch.obs.flight import RECORDER
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    RECORDER.clear()
    JRECORDER.clear()


def start(mod, **kw):
    srv = mod.serve(port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def both():
    """(JAX server address, port server address), each server on a fresh
    registry and fresh warm caches for this module (the servers' modules
    keep them process-wide, and other test files fill them)."""
    from collections import OrderedDict

    from raft_tla_tpu.obs import MetricsRegistry as JRegistry
    from raft_tla_tpu_torch.obs.metrics import MetricsRegistry
    mp = pytest.MonkeyPatch()
    mp.setattr(jsrv, "_METRICS", JRegistry())
    mp.setattr(tsrv, "_METRICS", MetricsRegistry())
    for mod in (jsrv, tsrv):
        for cache in ("_ENGINES", "_SIMS", "_SWARMS"):
            mp.setattr(mod, cache, OrderedDict())
    j = start(jsrv)
    t = start(tsrv, device="cpu")
    yield j.server_address, t.server_address
    for srv in (j, t):
        srv.shutdown()
        srv.server_close()
    mp.undo()


def roundtrip(addr, req: dict) -> dict:
    with socket.create_connection(addr, timeout=600) as s:
        s.sendall((json.dumps(req) + "\n").encode())
        line = s.makefile("rb").readline()
    return json.loads(line)


def pair(both, req):
    return roundtrip(both[0], req), roundtrip(both[1], req)


def no_seconds(report):
    """The report without its seconds (the growths' stall times)."""
    out = dict(report)
    if "seen_set" in out:
        ss = dict(out["seen_set"])
        ss["growths"] = [g[0] for g in ss.get("growths", [])]
        out["seen_set"] = ss
    return out


CHECK_FIELDS = ("ok", "distinct", "generated", "diameter", "levels",
                "stop_reason", "batch", "action_counts", "coverage",
                "violation", "deadlock")


def test_ping_answers_the_device(both):
    j, t = pair(both, {"op": "ping"})
    assert j == t == {"ok": True, "platform": "cpu"}


@pytest.mark.parametrize("depth", [3, 4])
def test_check_equals_the_jax_server(both, depth):
    j, t = pair(both, dict(op="check", cfg=BOUNDED, max_diameter=depth,
                           **SMALL))
    assert t["ok"] is True, t
    for key in CHECK_FIELDS:
        assert t[key] == j[key], key
    assert no_seconds(t["report"]) == no_seconds(j["report"])
    assert t["distinct"] == {3: 113, 4: 527}[depth]
    assert t["pipeline"] == "v3"


def test_warm_engine_refreshes_budgets_and_counts_hits(both):
    base = dict(op="check", cfg=BOUNDED, **SMALL)
    r1 = roundtrip(both[1], dict(base, max_diameter=2))
    r2 = roundtrip(both[1], dict(base, max_diameter=4))
    assert (r1["distinct"], r2["distinct"]) == (22, 527)
    assert r2["levels"] == [1, 3, 18, 79, 318]
    stats = roundtrip(both[1], {"op": "stats"})
    c = stats["metrics"]["counters"]
    assert c["server/engine_cache/hits"] >= 1
    assert c["server/engine_cache/misses"] >= 1
    assert stats["engine_cache"] == {"size": stats["engine_cache"]["size"],
                                     "capacity": 8}
    # cfg_text keys by content, as a path does: the same engine.
    with open(BOUNDED) as f:
        text = f.read()
    r3 = roundtrip(both[1], dict(base, cfg_text=text, cfg=None,
                                 max_diameter=3))
    assert r3["distinct"] == 113
    assert roundtrip(both[1], {"op": "stats"})["metrics"]["counters"][
        "server/engine_cache/hits"] == c["server/engine_cache/hits"] + 1


def test_noleader_trace_equals_the_jax_server(both):
    # A table the 45,968 states fit at half load: no growth (and no JAX
    # recompile for one).
    j, t = pair(both, dict(op="check", cfg=NOLEADER, trace=True,
                           **dict(SMALL, seen_capacity=1 << 17)))
    for key in CHECK_FIELDS:
        assert t[key] == j[key], key
    assert t["violation"]["invariant"] == "NoLeaderElected"
    assert len(t["violation"]["trace"]) == 10           # depth 9
    assert t["violation"]["trace"][-1]["action"].startswith("BecomeLeader")


def test_swarm_canary_equals_the_jax_server(both):
    j, t = pair(both, {"op": "check", "cfg": NOLEADER, "mode": "swarm",
                       "walks": 256, "max_depth": 16, "seed": 3})
    assert t["ok"] is True, t
    for key in ("mode", "walks", "steps", "visited", "traces", "distinct",
                "generated", "diameter", "stop_reason", "violation"):
        assert t[key] == j[key], key

    def timeless(hunt):
        return {k: v for k, v in hunt.items() if not k.endswith("seconds")}

    assert timeless(t["hunt"]) == timeless(j["hunt"])
    assert (t["steps"], t["visited"], t["traces"], t["diameter"]) == (
        4096, 2802, 1550, 12)
    assert t["violation"]["fingerprint"] == "0xd6467ee051491c1d"


def test_simulate_op(both):
    j, t = pair(both, {"op": "simulate", "cfg": BOUNDED, "batch": 64,
                       "depth": 16, "num_steps": 256})
    assert t["ok"] is True and j["ok"] is True, t
    assert t["steps"] >= 256 and t["traces"] >= 64
    assert t["violation"] is None


def test_bad_requests_answer_as_the_jax_server(both):
    for req in ({"op": "nope"}, {"op": "check"},
                {"op": "check", "cfg": BOUNDED, "mode": "sideways"},
                {"op": "status"}, {"op": "result", "job_id": "j9"}):
        j, t = pair(both, req)
        assert t == j and t["ok"] is False, req


def server_names(names):
    return sorted(n for n in names
                  if n.startswith(("server/", "request/", "jobs/")))


def test_stats_and_metrics_names_equal_the_jax_servers(both):
    """After the requests above, the two servers' ``stats`` documents have
    the same keys, the same server counter and histogram names, and their
    expositions the same server series."""
    j, t = pair(both, {"op": "stats"})
    assert sorted(t) == sorted(j)
    assert {k: t[k] for k in ("sim_cache", "swarm_cache")} == \
        {k: j[k] for k in ("sim_cache", "swarm_cache")}
    assert server_names(t["metrics"]["counters"]) == \
        server_names(j["metrics"]["counters"])
    assert server_names(t["metrics"]["histograms"]) == \
        server_names(j["metrics"]["histograms"])
    jm, tm = pair(both, {"op": "metrics"})
    assert tm["content_type"] == jm["content_type"]

    def series(text):
        return {m.group(1) for m in re.finditer(
            r"^(raft_(?:server|phase_request|jobs)_\w+?)(?:_bucket|_sum|"
            r"_count)?(?:\{|\s)", text, re.M)}

    assert series(tm["exposition"]) == series(jm["exposition"])
    assert "raft_server_requests_check_total" in series(tm["exposition"])


def test_watch_streams_a_live_run(both):
    from raft_tla_tpu_torch.obs.flight import RECORDER
    seq0 = RECORDER.seq()
    out = {}
    th = threading.Thread(target=lambda: out.update(resp=roundtrip(
        both[1], dict(op="check", cfg=BOUNDED, max_diameter=6, **SMALL))))
    th.start()
    got = []
    with socket.create_connection(both[1], timeout=600) as s:
        s.sendall((json.dumps({"op": "watch", "interval": 0.1})
                   + "\n").encode())
        for line in s.makefile("rb"):
            got.append(json.loads(line))
            if got[-1].get("done"):
                break
    th.join()
    assert out["resp"]["distinct"] == 9457
    end = got[-1]["run_end"]
    assert end and end["seq"] > seq0
    assert end["stop_reason"] == "diameter_budget"
    assert any(g.get("watch", {}).get("run") for g in got[:-1])


def test_eviction_releases_the_engine(monkeypatch):
    """Past the cap the oldest warm engine is evicted and released (its
    graphs, then its buffers)."""
    srv = start(tsrv, device="cpu")
    released = []
    real = tsrv._release
    monkeypatch.setattr(tsrv, "_release",
                        lambda e: (released.append(e), real(e)))
    monkeypatch.setattr(tsrv, "_CACHE_CAP", 1)
    try:
        for batch in (64, 128):
            r = roundtrip(srv.server_address, dict(
                op="check", cfg=BOUNDED, max_diameter=2, **dict(
                    SMALL, batch=batch)))
            assert r["distinct"] == 22
        assert len(released) >= 1
        assert not hasattr(released[0], "_tbuf")
        assert not released[0]._graphs
        c = roundtrip(srv.server_address, {"op": "stats"})["metrics"][
            "counters"]
        assert c["server/engine_cache/evictions"] >= 1
    finally:
        srv.shutdown()
        srv.server_close()


def test_hardening_and_the_metrics_port(tmp_path):
    srv = start(tsrv, device="cpu", max_request_bytes=256,
                idle_timeout_seconds=0.5, metrics_port=0)
    addr = srv.server_address
    try:
        with socket.create_connection(addr, timeout=30) as s:
            s.sendall(b'{"op": "ping", "pad": "' + b"x" * 400 + b'"}\n')
            resp = json.loads(s.makefile("rb").readline())
        assert resp["ok"] is False and "exceeds 256 bytes" in resp["error"]
        with socket.create_connection(addr, timeout=30) as s:
            time.sleep(1.0)
            assert s.recv(100) == b""            # idle: closed, silently
        base = f"http://127.0.0.1:{srv.metrics_http.server_address[1]}"
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        assert "raft_server_rejected_oversized_total 1" in text
        jobs = json.loads(urllib.request.urlopen(base + "/jobs").read())
        assert jobs["ok"] and jobs["queue_capacity"] == 64
        fl = json.loads(urllib.request.urlopen(base + "/flight").read())
        assert fl["ok"] and "records" in fl
    finally:
        srv.shutdown()
        srv.server_close()


def test_a_cuda_server_without_a_card_raises_at_start(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tsrv.serve(port=0)
    with pytest.raises(RuntimeError, match="cuda"):
        tsrv.serve(port=0, device="cuda")


def test_server_main_serves_the_cpu(tmp_path):
    p = subprocess.Popen(
        [sys.executable, "-m", "raft_tla_tpu_torch.server", "--device",
         "cpu", "--port", "0", "--job-dir", str(tmp_path / "jobs")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = p.stdout.readline()
        m = re.search(r"on 127\.0\.0\.1:(\d+) \(cpu\)", line)
        assert m, line + p.stderr.read()
        r = roundtrip(("127.0.0.1", int(m.group(1))), {"op": "ping"})
        assert r == {"ok": True, "platform": "cpu"}
    finally:
        p.terminate()
        p.wait(timeout=30)
