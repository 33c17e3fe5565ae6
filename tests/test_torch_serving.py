"""The port's job layer (``raft_tla_tpu_torch/serving/``) against the JAX
package's.

The managers run the same scenarios against a stub executor (no engine,
no device) and must give the same job documents, schedules, metric
names and journals, job ids and timestamps left out: lifecycle and
metrics, least-recently-served fairness, bounded admission, the cancel
rules, the result cache, the terminal retention, the tenant label bound,
journal replay (queued jobs resume, the job a crash caught running is
re-run once, then failed with a postmortem pointer).  A journal written by
either package replays in the other, and a job queued on one package's
server runs on the other's after a restart on the same job directory.
The port's server serves jobs from two tenants with the direct check's
counts, and its ``jobs`` document equals the JAX server's; the CLI's
clients (``submit --wait``, ``jobs``, ``watch --job``) drive it without
importing torch.
"""

import json
import os
import re
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

from raft_tla_tpu import server as jsrv
from raft_tla_tpu.serving import JobManager as JManager
from raft_tla_tpu.serving import jobs as jjobs
from raft_tla_tpu_torch import server as tsrv
from raft_tla_tpu_torch.serving import (JobManager, QueueFullError,
                                        TERMINAL_STATES)
from raft_tla_tpu_torch.serving import jobs as tjobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")
SMALL = {"batch": 128, "queue_capacity": 1 << 12, "seen_capacity": 1 << 15,
         "check_deadlock": False}
MANAGERS = {"torch": (JobManager, tjobs), "jax": (JManager, jjobs)}

#: Job fields that name a run's time or identity rather than its fate.
VOLATILE = ("id", "created_ts", "enqueued_ts", "admitted_ts", "started_ts",
            "finished_ts", "queue_wait_seconds", "run_seconds",
            "turnaround_seconds", "events_out", "job_dir", "postmortem")


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


def stable(job):
    """A job summary without its ids, times and paths (their presence
    kept)."""
    out = {k: v for k, v in job.items() if k not in VOLATILE}
    for k in ("events_out", "postmortem", "queue_wait_seconds"):
        if k in job:
            out[k] = job[k] is not None
    return out


def no_ids(text):
    """``text`` with its job ids replaced by one placeholder."""
    return re.sub(r"j\d{6}-[0-9a-f]{6}", "<id>", text)


def stable_doc(doc):
    return dict(doc, jobs=[stable(j) for j in doc["jobs"]])


def wait_terminal(m, timeout=60.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        doc = m.jobs_doc()
        if all(j["state"] in TERMINAL_STATES for j in doc["jobs"]):
            return doc
        time.sleep(0.01)
    raise AssertionError(f"jobs never settled: {m.jobs_doc()}")


def metric_names(m):
    snap = m.metrics.snapshot()
    return {kind: sorted(snap[kind]) for kind in ("counters", "gauges",
                                                  "histograms")}


# -- the managers, scenario by scenario -----------------------------------

def lifecycle(cls, base):
    def ex(req, job):
        if req.get("boom"):
            raise RuntimeError("engine exploded")
        return {"ok": True, "distinct": req["n"]}

    m = cls(base, executor=ex, slo_seconds=60.0)
    try:
        a = m.submit({"op": "check", "n": 7}, tenant="acme", label="lbl")
        b = m.submit({"op": "simulate", "n": 3}, tenant="bravo")
        c = m.submit({"op": "check", "boom": True}, tenant="acme")
        wait_terminal(m)
        out = {"doc": stable_doc(m.jobs_doc()),
               "result": m.result(a["id"]), "simulate": m.get(b["id"]),
               "names": metric_names(m)}
        with pytest.raises(ValueError) as info:
            m.result(c["id"])
        out["error"] = str(info.value).split(": ", 1)[1]
        out["simulate"] = stable(out["simulate"])
        return out
    finally:
        m.close()


def fairness(cls, base):
    order = []

    def ex(req, job):
        order.append((job["tenant"], req["n"]))
        return {"ok": True}

    m = cls(base, executor=ex, start=False)
    for t, n in (("a", 1), ("a", 2), ("a", 3), ("b", 10), ("b", 11),
                 ("c", 20)):
        m.submit({"op": "check", "n": n}, tenant=t)
    m._thread = threading.Thread(target=m._loop, daemon=True)
    m._thread.start()
    try:
        wait_terminal(m)
        return order
    finally:
        m.close()


def admission_and_cancel(cls, base):
    m = cls(base, executor=lambda r, j: {"ok": True}, queue_capacity=2,
            start=False)
    out = []
    a = m.submit({"op": "check"}, tenant="t")
    m.submit({"op": "check"}, tenant="t")
    with pytest.raises(Exception) as info:
        m.submit({"op": "check"}, tenant="t")
    out.append((type(info.value).__name__, str(info.value)))
    out.append(stable(m.cancel(a["id"])))
    for op in (lambda: m.cancel(a["id"]), lambda: m.get("nope")):
        with pytest.raises(Exception) as info:
            op()
        out.append((type(info.value).__name__, no_ids(str(info.value))))
    out.append(stable_doc(m.jobs_doc()))
    out.append(metric_names(m))
    m.close(wait=False)
    return out


def cache_and_retention(cls, base):
    calls = []

    def ex(req, job):
        calls.append(req["n"])
        return {"ok": True, "n": req["n"]}

    m = cls(base, executor=ex, max_terminal_jobs=3, tenant_cap=2)
    try:
        for n, key, tenant in ((1, "K", "acme corp"), (2, "K", "acme_corp"),
                               (3, "K2", "t3"), (4, None, "t4"),
                               (5, "K", "other")):
            m.submit({"op": "check", "n": n}, tenant=tenant, cache_key=key)
            wait_terminal(m)
        return {"calls": calls, "doc": stable_doc(m.jobs_doc()),
                "names": metric_names(m)}
    finally:
        m.close()


SCENARIOS = {"lifecycle": lifecycle, "fairness": fairness,
             "admission_and_cancel": admission_and_cancel,
             "cache_and_retention": cache_and_retention}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_manager_scenario_equals_the_jax_manager(tmp_path, name):
    got = {pkg: SCENARIOS[name](cls, str(tmp_path / pkg))
           for pkg, (cls, _jobs) in MANAGERS.items()}
    assert got["torch"] == got["jax"]
    if name == "fairness":
        assert got["torch"] == [("a", 1), ("b", 10), ("c", 20), ("a", 2),
                                ("b", 11), ("a", 3)]


def test_queue_full_is_the_ports_own_error(tmp_path):
    m = JobManager(str(tmp_path), executor=lambda r, j: {"ok": True},
                   queue_capacity=1, start=False)
    m.submit({"op": "check"})
    with pytest.raises(QueueFullError, match="queue full"):
        m.submit({"op": "check"})
    m.close(wait=False)


# -- the journal, across the packages -------------------------------------

def crashed_journal(jobs_mod, base, restarts):
    """A journal (written with ``jobs_mod``) holding a queued job and one
    whose last word is ``running``: what a crash leaves."""
    os.makedirs(base, exist_ok=True)
    path = os.path.join(base, "jobs.jsonl")
    q = jobs_mod.new_job("j000001-aaaaaa", "acme", {"op": "check", "n": 1},
                         ts=1000.0)
    r = jobs_mod.new_job("j000002-bbbbbb", "bravo", {"op": "check", "n": 2},
                         ts=1001.0)
    for job in (q, r):
        job["job_dir"] = os.path.join(base, job["id"])
    r["restarts"] = restarts
    os.makedirs(r["job_dir"], exist_ok=True)
    with open(os.path.join(r["job_dir"], "postmortem.json"), "w") as f:
        f.write("{}\n")
    for job in (q, r):
        jobs_mod.append_record(path, jobs_mod.submit_record(job))
    r["state"] = "running"
    jobs_mod.append_record(path, jobs_mod.state_record(
        r, patch={"started_ts": 1002.0}))
    return path


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("restarts", [0, 1])
def test_a_journal_replays_in_the_other_package(tmp_path, writer, reader,
                                                restarts):
    base = str(tmp_path / "jobs")
    crashed_journal(MANAGERS[writer][1], base, restarts)
    ran = []

    def ex(req, job):
        ran.append(req["n"])
        return {"ok": True, "n": req["n"]}

    m = MANAGERS[reader][0](base, executor=ex)
    try:
        doc = wait_terminal(m)
        by = {j["id"]: j for j in doc["jobs"]}
        q, r = by["j000001-aaaaaa"], by["j000002-bbbbbb"]
        assert q["state"] == "done" and q["note"] == "resumed_after_restart"
        if restarts == 0:
            assert sorted(ran) == [1, 2]
            assert r["state"] == "done" and r["restarts"] == 1
            assert r["note"] == "requeued_after_restart"
        else:
            assert ran == [1]
            assert r["state"] == "failed"
            assert r["error"] == "lost to 2 server restart(s) while running"
            assert r["postmortem"].endswith("postmortem.json")
    finally:
        m.close()
    # The reader's appends replay in the writer's package too.
    jobs, results, problems = MANAGERS[writer][1].replay(
        os.path.join(base, "jobs.jsonl"))
    assert problems == []
    assert {j["id"]: j["state"] for j in jobs.values()} == {
        "j000001-aaaaaa": "done",
        "j000002-bbbbbb": "done" if restarts == 0 else "failed"}


def test_the_journals_are_written_alike(tmp_path):
    """The same operations journal the same records, key for key."""
    lines = {}
    for pkg, (cls, _mod) in MANAGERS.items():
        m = cls(str(tmp_path / pkg), executor=lambda r, j: {"ok": True},
                start=False)
        a = m.submit({"op": "check", "cfg_text": "x"}, tenant="acme",
                     label="l", cache_key="k", slo_seconds=5)
        m.cancel(a["id"])
        m.close(wait=False)
        with open(m.journal_path) as f:
            recs = [json.loads(line) for line in f]
        lines[pkg] = [(r["rec"], sorted(r), sorted(r.get("job", {})),
                       r.get("state"), sorted(r.get("patch", {})),
                       stable(r["job"]) if "job" in r else None)
                      for r in recs]
    assert lines["torch"] == lines["jax"]


# -- the servers ----------------------------------------------------------

def start(mod, **kw):
    srv = mod.serve(port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def roundtrip(addr, req):
    with socket.create_connection(addr, timeout=600) as s:
        s.sendall((json.dumps(req) + "\n").encode())
        return json.loads(s.makefile("rb").readline())


def settle(addr, ids, timeout=600.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        doc = roundtrip(addr, {"op": "jobs"})
        by = {j["id"]: j for j in doc["jobs"]}
        if all(by[i]["state"] in TERMINAL_STATES for i in ids):
            return doc
        time.sleep(0.05)
    raise AssertionError(f"jobs never settled: {doc}")


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    base = tmp_path_factory.mktemp("serving")
    j = start(jsrv, job_dir=str(base / "jax"))
    t = start(tsrv, device="cpu", job_dir=str(base / "torch"),
              history=str(base / "ledger.jsonl"), metrics_port=0)
    yield j, t, base
    for srv in (j, t):
        srv.shutdown()
        srv.server_close()


JOBS = [("t1", 3), ("t2", 4), ("t1", 4)]


def test_jobs_from_two_tenants_equal_the_jax_servers(servers):
    j, t, base = servers
    docs, results = {}, {}
    for name, srv in (("jax", j), ("torch", t)):
        ids = []
        for tenant, d in JOBS:
            r = roundtrip(srv.server_address, {
                "op": "submit", "tenant": tenant,
                "job": dict(op="check", cfg=BOUNDED, max_diameter=d,
                            **SMALL)})
            assert r["ok"] and r["job"]["state"] == "queued", r
            ids.append(r["job"]["id"])
        docs[name] = stable_doc(settle(srv.server_address, ids))
        results[name] = [roundtrip(srv.server_address,
                                   {"op": "result", "job_id": i})
                         for i in ids]
    assert docs["torch"] == docs["jax"]
    assert docs["torch"]["by_state"]["done"] == 3
    for tr, jr in zip(results["torch"], results["jax"]):
        assert tr["ok"] and tr["state"] == "done"
        for key in ("distinct", "generated", "levels", "action_counts",
                    "coverage"):
            assert tr["result"][key] == jr["result"][key], key
    assert [r["result"]["distinct"] for r in results["torch"]] == \
        [113, 527, 527]
    # Each job's scoped event log, and the history ledger.
    jobs = roundtrip(t.server_address, {"op": "jobs"})["jobs"]
    for job in jobs:
        with open(job["events_out"]) as f:
            events = [json.loads(line)["event"] for line in f]
        assert events[0] == "run_start" and events[-1] == "run_end"
    with open(base / "ledger.jsonl") as f:
        ledger = [json.loads(line) for line in f]
    assert {e.get("job_id") for e in ledger} >= {job["id"] for job in jobs}


def test_cache_cancel_and_bad_submits_equal_the_jax_servers(servers):
    j, t, _base = servers
    out = {}
    for name, srv in (("jax", j), ("torch", t)):
        a = srv.server_address
        req = {"op": "submit", "tenant": "c", "cache": True,
               "job": dict(op="check", cfg=BOUNDED, max_diameter=2,
                           **SMALL)}
        first = roundtrip(a, req)["job"]["id"]
        settle(a, [first])
        second = roundtrip(a, req)["job"]["id"]
        settle(a, [second])
        bad = [roundtrip(a, r) for r in (
            {"op": "submit", "job": {"op": "nope"}},
            {"op": "submit", "job": dict(op="check", cfg=BOUNDED,
                                         mode="sideways")},
            dict(req, job=dict(req["job"], max_seconds=5)),
            {"op": "cancel", "job_id": first},
            {"op": "status", "job_id": "j999"})]
        out[name] = (stable(roundtrip(a, {"op": "status",
                                          "job_id": second})["job"]),
                     roundtrip(a, {"op": "result", "job_id": second})[
                         "result"]["distinct"],
                     [dict(b, error=no_ids(b["error"])) for b in bad])
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["cached"] is True and out["torch"][1] == 22


def test_a_queued_job_crosses_a_restart_between_the_packages(tmp_path):
    """A job queued on one package's server runs on the other's, started
    on the same job directory."""
    for first, second in ((jsrv, tsrv), (tsrv, jsrv)):
        jd = str(tmp_path / first.__name__)
        kw = {"device": "cpu"} if first is tsrv else {}
        s1 = start(first, job_dir=jd, **kw)
        s1.jobs.close(wait=False)       # no executor: the job stays queued
        jid = roundtrip(s1.server_address, {
            "op": "submit", "tenant": "t",
            "job": dict(op="check", cfg=BOUNDED, max_diameter=3,
                        **SMALL)})["job"]["id"]
        s1.shutdown()
        s1.server_close()
        kw = {"device": "cpu"} if second is tsrv else {}
        s2 = start(second, job_dir=jd, **kw)
        try:
            doc = settle(s2.server_address, [jid])
            job = {j["id"]: j for j in doc["jobs"]}[jid]
            assert job["state"] == "done"
            assert job["note"] == "resumed_after_restart"
            r = roundtrip(s2.server_address, {"op": "result",
                                              "job_id": jid})
            assert r["result"]["distinct"] == 113
        finally:
            s2.shutdown()
            s2.server_close()


def cli(*args):
    return subprocess.run([sys.executable, "-m", "raft_tla_tpu_torch",
                           *args], cwd=REPO, env=dict(os.environ,
                                                      PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)


def test_the_clients_drive_the_ports_server(servers):
    """``submit --wait``, ``jobs`` and ``watch --job`` through ``python -m
    raft_tla_tpu_torch``; the client path never imports torch."""
    _j, t, _base = servers
    host, port = t.server_address
    target = f"{host}:{port}"
    r = cli("submit", BOUNDED, "--server", target, "--tenant", "cli",
            "--batch", "128", "--queue-capacity", "4096",
            "--seen-capacity", "32768", "--max-diameter", "3",
            "--pipeline", "v4", "--wait", "--poll-interval", "0.1")
    assert r.returncode == 0, r.stderr
    assert "distinct 113 | generated 222 | diameter 3" in r.stdout
    jid = r.stdout.split()[1]
    r = cli("jobs", "--server", target, "--tenant", "cli")
    assert r.returncode == 0 and jid in r.stdout and "done" in r.stdout
    r = cli("watch", target, "--job", jid, "--interval", "0.1")
    assert r.returncode == 0 and f"job {jid} done" in r.stdout
    probe = ("import sys\nfrom raft_tla_tpu_torch import clients\n"
             "rc = clients.main(sys.argv[1:])\n"
             "print('torch' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", probe, "jobs", "--server",
                        target, "--json"], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.stdout.strip().endswith("False")
    assert json.loads(r.stdout.rsplit("\n", 2)[0])["ok"] is True


def test_watch_job_sees_its_own_progress(servers):
    _j, t, _base = servers
    a = t.server_address
    jid = roundtrip(a, {"op": "submit", "tenant": "w", "job": dict(
        op="check", cfg=BOUNDED, max_diameter=6, **SMALL)})["job"]["id"]
    got = []
    with socket.create_connection(a, timeout=600) as s:
        s.sendall((json.dumps({"op": "watch", "job": jid,
                               "interval": 0.05}) + "\n").encode())
        for line in s.makefile("rb"):
            got.append(json.loads(line))
            if got[-1].get("done"):
                break
    assert got[-1]["job"]["state"] == "done"
    snaps = [g["watch"] for g in got[:-1]]
    assert all(s["job"]["id"] == jid for s in snaps)
    assert any(s.get("run", {}).get("job_id") == jid for s in snaps
               if s.get("running"))
