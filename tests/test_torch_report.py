"""The port's observability (``obs/``) vs the JAX package's, and the cfg
directives of this slice.

- ``obs/metrics.py``, ``obs/coverage.py``, ``obs/report.py`` and
  ``obs/events.py`` on the same inputs as the JAX modules: snapshots,
  tables, reports, renderings, the validator.
- The engine with the report, coverage and events on and off: counts,
  levels, per-family counts and trace records identical; the registry's
  phase seconds are ``EngineResult.phases``; a run's events (checkpoint,
  spill, growth, degradation) validate.
- The directives: PLATFORM picks the device, REPORT, EVENTS_OUT and
  COUNTEREXAMPLE_DIR are honoured (a flag over its directive), and so
  are the six of the JAX package's other obs/ modules (TRACE_OUT,
  PROFILE_CHUNKS, XLA_PROFILE, METRICS_PORT, HISTORY, PERF).
"""

import json
import os
import types

import pytest
import torch

from raft_tla_tpu.obs import coverage as jcoverage
from raft_tla_tpu.obs import events as jevents
from raft_tla_tpu.obs import metrics as jmetrics
from raft_tla_tpu.obs import report as jreport
from raft_tla_tpu_torch import cli
from raft_tla_tpu_torch.engine.bfs import BFSEngine, EngineConfig
from raft_tla_tpu_torch.engine.check import (UNPORTED_DIRECTIVES,
                                             device_for, make_engine,
                                             run_check)
from raft_tla_tpu_torch.obs import coverage, events, metrics, report
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")
L4 = (527, 1191, [1, 3, 18, 79, 318])     # distinct, generated, levels


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(**kw):
    base = dict(batch=64, queue_capacity=1 << 12, seen_capacity=1 << 14,
                check_deadlock=False, max_diameter=4)
    base.update(kw)
    return EngineConfig(**base)


# ---------------------------------------------------------------------------
# The modules against the JAX ones.

def test_metrics_registry_equals_jax():
    regs = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for r in regs:
        r.counter("engine/distinct", 5)
        r.counter("engine/distinct", 7)
        r.gauge("engine/seen_size", 123)
        for v in (3e-7, 0.004, 0.004, 2.5, 700.0):
            r.observe("phase/dispatch", v)
        r.observe("phase/host", 0.25)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].phase_seconds() == regs[1].phase_seconds()
    base = {"dispatch": 1.0, "host": 0.25}
    assert metrics.phase_delta(regs[0].phase_seconds(), base) == \
        jmetrics.phase_delta(regs[1].phase_seconds(), base)
    with regs[0].phase_timer("checkpoint"):
        pass
    assert regs[0].snapshot()["histograms"]["phase/checkpoint"]["count"] == 1


def test_coverage_and_report_equal_jax():
    names = ["Restart", "Timeout", "RequestVote", "BecomeLeader",
             "ClientRequest", "AdvanceCommitIndex", "AppendEntries",
             "Receive", "DuplicateMessage", "DropMessage"]
    sizes = [3, 3, 9, 3, 6, 3, 9, 32, 32, 32]
    covs = (coverage.ActionCoverage(names, sizes),
            jcoverage.ActionCoverage(names, sizes))
    for c in covs:
        c.add_chunk(40, range(10, 20), range(5, 15))
        c.add_chunk(7, [1] * 10, [0] * 10, [0, 2] + [0] * 8)
        c.seed_generated({"Timeout": 4})
    assert covs[0].snapshot() == covs[1].snapshot()
    assert covs[0].render_table() == covs[1].render_table()
    res = types.SimpleNamespace(
        distinct=2300, generated=5616, diameter=5,
        levels=[1, 3, 18, 79, 318, 1218], stop_reason="diameter_budget",
        violation=None, deadlock=None, growth_stalls=[(1 << 15, 0.01)],
        family_groups=report.family_groups(
            types.SimpleNamespace(family_names=names, family_sizes=sizes)))
    stats = [{"level": i, "distinct": 10 * i, "generated": 20 * i,
              "seen_size": 9 * i, "seen_capacity": 1 << 14}
             for i in range(5)]
    got = report.build_report(res, coverage=covs[0], level_stats=stats,
                              seen_capacity=1 << 15, seen_size=2400)
    want = jreport.build_report(res, coverage=covs[1], level_stats=stats,
                                seen_capacity=1 << 15, seen_size=2400)
    assert got == want
    assert report.render_report(got) == jreport.render_report(want)
    assert report.summarize(got) == jreport.summarize(want)
    assert report.collision_probability(9457, 24429) == \
        jreport.collision_probability(9457, 24429)
    regs = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    report.feed_metrics(got, regs[0])
    jreport.feed_metrics(want, regs[1])
    covs[0].feed_metrics(regs[0])
    covs[1].feed_metrics(regs[1])
    assert regs[0].snapshot() == regs[1].snapshot()


def test_run_events_log_and_validator(tmp_path):
    assert events.events_path(None, None) is None
    assert events.events_path(None, "ck") == os.path.join("ck",
                                                          "events.jsonl")
    assert events.events_path("e.jsonl", "ck", 1, 4) == \
        jevents.events_path("e.jsonl", "ck", 1, 4)
    assert events.KNOWN_EVENTS == jevents.KNOWN_EVENTS
    path = str(tmp_path / "ev.jsonl")
    with events.RunEventLog(path) as log:
        log.emit("run_start", batch=1)
        log.emit("statespace", report={"distinct": 1})
        log.emit("run_end", levels=[1])
    assert [e["event"] for e in events.validate_run_events(path)] == \
        [e["event"] for e in jevents.validate_run_events(path)]
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"event": "run_start", "ts": 1}\n'
                   '{"event": "statespace", "ts": 2}\n'
                   '{"event": "run_end", "ts": 3}\n')
    with pytest.raises(ValueError, match="statespace"):
        events.validate_run_events(str(bad))
    scratch = tmp_path / "scratch"
    scratch.mkdir()
    assert events.validate_and_cleanup(path, str(scratch)) == 3
    assert not scratch.exists()
    events.RunEventLog(None).emit("run_start")       # a no-op sink
    # The CPU reports no device memory, as the JAX probe's CPU devices.
    assert events.device_memory_stats("cpu") == {}
    assert events.all_device_memory_stats("cpu") == [{}]


# ---------------------------------------------------------------------------
# The engine: observational only.

@pytest.mark.parametrize("pipeline", ["v3", "v4"])
def test_report_events_and_coverage_change_no_count(tmp_path, pipeline):
    on = run_check(BOUNDED, port_config(
        pipeline=pipeline, events_out=str(tmp_path / "ev.jsonl")),
        device="cpu")
    off = run_check(BOUNDED, port_config(pipeline=pipeline,
                                         statespace_report=False),
                    device="cpu")
    for res in (on, off):
        assert (res.distinct, res.generated, res.levels) == L4
    assert on.action_counts == off.action_counts
    assert on.steps == off.steps and on.batches == off.batches
    links = [tuple(c.tolist() for c in r.engine.trace.export())
             for r in (on, off)]
    assert links[0] == links[1]
    assert off.report == {} and off.level_stats == []
    assert [r["frontier"] for r in on.report["levels"]] == on.levels
    assert on.report["out_degree"]["expanded_parents"] == sum(L4[2][:-1])
    # Coverage: generated is action_counts; distinct sums to the states
    # found past the roots.
    assert {n: c["generated"] for n, c in on.coverage.items()} == \
        on.action_counts
    assert sum(c["distinct"] for c in on.coverage.values()) == \
        on.distinct - 1
    # One clock: the registry's phase seconds are EngineResult.phases.
    got = on.engine.metrics.phase_seconds()
    assert got == {k: v for k, v in on.phases.items() if v > 0}
    ev = events.validate_run_events(str(tmp_path / "ev.jsonl"))
    lv = [e for e in ev if e["event"] == "level_complete"]
    assert [e["frontier_rows"] for e in lv] == on.levels
    assert ev[-1]["phase_seconds"] == pytest.approx(got)


def test_checkpoint_spill_growth_and_degraded_events(monkeypatch, tmp_path):
    real = BFSEngine._run_chunk
    calls = [0]

    def run_chunk(self, *args, **kw):
        calls[0] += 1
        if calls[0] == 8:
            raise torch.cuda.OutOfMemoryError("injected")
        return real(self, *args, **kw)

    monkeypatch.setattr(BFSEngine, "_run_chunk", run_chunk)
    ck = tmp_path / "ck"
    res = run_check(BOUNDED, port_config(
        batch=64, queue_capacity=1024, seen_capacity=256, sync_every=4,
        checkpoint_dir=str(ck), record_trace=False, max_diameter=6),
        device="cpu")
    assert (res.distinct, res.generated) == (9457, 24429)
    ev = events.validate_run_events(str(ck / "events.jsonl"))
    names = [e["event"] for e in ev]
    assert names[0] == "run_start" and names[-1] == "run_end"
    for name in ("checkpoint", "spill", "fpset_resize", "degraded"):
        assert name in names, name
    deg, = [e for e in ev if e["event"] == "degraded"]
    assert (deg["batch"], deg["new_batch"]) == (64, 32)
    assert deg["error"].startswith("OutOfMemoryError")
    assert res.report["seen_set"]["growths"]
    assert len(res.engine.metrics.snapshot()["counters"]) >= 3


# ---------------------------------------------------------------------------
# The directives.

def cfg_with(tmp_path, *lines, name="c.cfg"):
    path = tmp_path / name
    path.write_text(open(BOUNDED).read() + "\n"
                    + "".join(f"\\* TPU: {ln}\n" for ln in lines))
    return str(path)


def test_platform_directive_picks_the_device(monkeypatch, tmp_path,
                                             capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = cfg_with(tmp_path, "PLATFORM = cpu")
    assert device_for(load_config(cfg)) == "cpu"
    assert cli.main(["check", cfg, "--max-diameter", "2",
                     "--progress-interval", "0"]) == 0
    out = capsys.readouterr().out
    assert "device             cpu" in out and "distinct states    22" in out
    for name, want in (("gpu", "cuda"), ("cuda", "cuda")):
        setup = load_config(cfg_with(tmp_path, f"PLATFORM = {name}"))
        assert device_for(setup) == want
        with pytest.raises(RuntimeError, match="cuda"):
            make_engine(setup)
        assert device_for(setup, "cpu") == "cpu"      # the flag wins
    with pytest.raises(ValueError, match="tpu"):
        make_engine(load_config(cfg_with(tmp_path, "PLATFORM = tpu")))


#: The directives of the JAX package's obs/, refused until their modules
#: were ported, honoured since.
OBS_DIRECTIVES = ("HISTORY", "METRICS_PORT", "PERF", "PROFILE_CHUNKS",
                  "TRACE_OUT", "XLA_PROFILE")


@pytest.mark.parametrize("key", OBS_DIRECTIVES)
def test_unported_directives_are_refused(tmp_path, key, capsys):
    """None is refused now: each of the six is honoured by the engine or
    the CLI, and off asks for nothing."""
    assert not UNPORTED_DIRECTIVES
    out = tmp_path / "out"
    value = {"HISTORY": out / "h.jsonl", "TRACE_OUT": out / "t.json",
             "PERF": "TRUE", "METRICS_PORT": free_port()}.get(key, "8")
    cfg = cfg_with(tmp_path, f"{key} = {value}")
    eng = make_engine(load_config(cfg), device="cpu")
    c = eng.config
    assert {"PERF": c.perf and eng._perf is not None,
            "PROFILE_CHUNKS": c.profile_chunks_every == 8
            and eng._profiler.every == 8,
            "XLA_PROFILE": c.xla_profile_chunks == 8,
            "TRACE_OUT": c.trace_out == str(value)}.get(key, True)
    if key in ("HISTORY", "METRICS_PORT", "TRACE_OUT"):
        assert cli.main(["check", cfg, "--device", "cpu",
                         "--max-diameter", "2"]) == 0
        err = capsys.readouterr().err
        if key == "HISTORY":
            assert json.loads((out / "h.jsonl").read_text())["distinct"] \
                == 22
        elif key == "METRICS_PORT":
            assert f"metrics: http://127.0.0.1:{value}/metrics" in err
        else:
            names = {e["name"] for e in json.loads(
                (out / "t.json").read_text())}
            assert {"run", "level", "chunk"} <= names
    # Off asks for nothing.
    if key in ("PERF", "METRICS_PORT", "PROFILE_CHUNKS", "XLA_PROFILE"):
        off = "FALSE" if key == "PERF" else "0"
        eng = make_engine(load_config(cfg_with(tmp_path, f"{key} = {off}",
                                               name="off.cfg")),
                          device="cpu")
        assert eng._perf is None and eng._profiler is None
        assert not eng.config.xla_profile_chunks


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_report_events_and_counterexample_directives(tmp_path, capsys):
    ev, flag_ev = tmp_path / "ev.jsonl", tmp_path / "flag.jsonl"
    cfg = cfg_with(tmp_path, "REPORT = FALSE", f"EVENTS_OUT = {ev}",
                   f"COUNTEREXAMPLE_DIR = {tmp_path / 'ce'}",
                   "BATCH = 64")
    cfgobj = make_engine(load_config(cfg), device="cpu").config
    assert cfgobj.events_out == str(ev) and not cfgobj.statespace_report
    assert cfgobj.counterexample_dir == str(tmp_path / "ce")
    assert cli.main(["check", cfg, "--device", "cpu", "--max-diameter",
                     "2", "--progress-interval", "0"]) == 0
    out = capsys.readouterr().out
    assert "fp collision prob" not in out          # REPORT = FALSE
    assert events.validate_run_events(str(ev))[0]["batch"] == 64
    # A flag over its directive.
    assert cli.main(["check", cfg, "--device", "cpu", "--max-diameter",
                     "2", "--events-out", str(flag_ev), "--batch", "32",
                     "--progress-interval", "0"]) == 0
    assert events.validate_run_events(str(flag_ev))[0]["batch"] == 32
    assert len(events.validate_run_events(str(ev))) == \
        len(events.validate_run_events(str(flag_ev)))
    # --no-report over REPORT's default; the metrics file.
    m = tmp_path / "m.json"
    assert cli.main(["check", BOUNDED, "--device", "cpu", "--max-diameter",
                     "2", "--no-report", "--metrics-out", str(m),
                     "--progress-interval", "0"]) == 0
    assert "fp collision prob" not in capsys.readouterr().out
    snap = json.loads(m.read_text())
    assert snap["counters"]["engine/distinct"] == 22
    assert "statespace/diameter" not in snap["gauges"]
