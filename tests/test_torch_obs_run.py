"""What a single-device run says of its own time, on the CPU.

- ``EngineResult.phases`` covers ``run()``: its wall, as the caller
  measures it, less the sum of the phases is under 1 ms, for a fresh
  engine and a warm one, traced or not; a run that spills to the host
  times the drain (``spill``) and the upload back (``upload``) apart.
- ``obs/tracing.py`` stamps spans on the profiler's Unix-epoch clock: a
  span and a ``torch.profiler`` ``record_function`` range around the
  same block agree within 1 ms.
- Each run has its own id, on the ``run`` span, the span file's
  metadata, ``run_start`` and ``run_end``; the span file is written once
  a run, at its end.
- A garbage collection inside a run is a ``gc`` span and counts in
  ``EngineResult.gc``; ``obs/events.py device_memory_stats`` keeps the
  JAX probe's keys beside the allocator's own.
"""

import gc
import os
import time

import pytest
import torch

from raft_tla_tpu_torch.engine.bfs import PHASES, BFSEngine, EngineConfig
from raft_tla_tpu_torch.engine.check import initial_states, make_engine
from raft_tla_tpu_torch.obs import events, tracing
from raft_tla_tpu_torch.obs.events import validate_run_events
from raft_tla_tpu_torch.obs.tracing import SpanTracer, validate_chrome_trace
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")
L5 = (2300, [1, 3, 18, 79, 318, 1218])       # distinct, levels


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def engine(**kw):
    base = dict(batch=128, queue_capacity=1 << 14, seen_capacity=1 << 16,
                check_deadlock=False, max_diameter=5, pipeline="v3")
    base.update(kw)
    setup = load_config(BOUNDED)
    return make_engine(setup, EngineConfig(**base), device="cpu"), \
        initial_states(setup)


def timed_run(eng, roots):
    t = time.perf_counter()
    res = eng.run(roots)
    return res, time.perf_counter() - t


@pytest.mark.parametrize("traced", [False, True])
def test_phases_partition_the_run(tmp_path, traced):
    kw = (dict(trace_out=str(tmp_path / "t.json"),
               events_out=str(tmp_path / "e.jsonl")) if traced else {})
    eng, roots = engine(**kw)
    for _ in range(3):                       # a fresh engine, then warm
        res, wall = timed_run(eng, roots)
        assert (res.distinct, res.levels) == L5
        assert set(res.phases) == set(PHASES)
        assert all(v >= 0 for v in res.phases.values())
        assert res.phases["setup"] > 0 and res.phases["finish"] > 0
        assert 0 <= wall - sum(res.phases.values()) < 1e-3, res.phases
    # The registry's phases are the result's, and run_end carries them.
    if traced:
        end = validate_run_events(str(tmp_path / "e.jsonl"))[-1]
        assert end["phase_seconds"] == pytest.approx(
            {k: v for k, v in res.phases.items() if v > 0})


def test_spill_and_upload_are_timed_apart():
    eng, roots = engine(batch=64, queue_capacity=256, seen_capacity=1 << 14)
    res, wall = timed_run(eng, roots)
    assert (res.distinct, res.levels) == L5
    assert res.spills > 0
    assert res.phases["spill"] > 0 and res.phases["upload"] > 0
    assert 0 <= wall - sum(res.phases.values()) < 1e-3, res.phases


def test_span_clock_is_the_profilers():
    from torch.profiler import ProfilerActivity, profile, record_function
    tr = SpanTracer(os.devnull)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):       # the first range's set-up
            pass
        with record_function("block"), tr.span("block"):
            time.sleep(0.02)
    got = [e for e in tr._events if e["ph"] == "X"]
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "block"]
    assert len(got) == len(ranges) == 1
    start_us = ranges[0].start_ns() / 1e3
    end_us = start_us + ranges[0].duration_ns() / 1e3
    span = got[0]
    assert abs(span["ts"] - start_us) < 1e3
    assert abs(span["ts"] + span["dur"] - end_us) < 1e3
    clock, = [e for e in tr._events if e["name"] == "clock"]
    assert clock["args"]["name"] == tracing.CLOCK


def test_run_ids_and_one_span_file_a_run(tmp_path, monkeypatch):
    spans, evs = tmp_path / "t.json", tmp_path / "e.jsonl"
    eng, roots = engine(trace_out=str(spans), events_out=str(evs))
    writes = []
    real = SpanTracer.write
    monkeypatch.setattr(SpanTracer, "write", lambda self, path=None: (
        writes.append(path), real(self, path))[1])
    first, _ = timed_run(eng, roots)
    second, _ = timed_run(eng, roots)
    assert len(writes) == 2                  # once a run, not a level
    ids = [first.run_id, second.run_id]
    assert ids[0] != ids[1]
    assert all(i.startswith(f"{os.getpid()}-") for i in ids)
    ev = validate_run_events(str(evs))
    for event in ("run_start", "run_end"):
        assert [e["run_id"] for e in ev if e["event"] == event] == ids
    trace = validate_chrome_trace(str(spans))
    meta, = [e for e in trace if e["name"] == "run_id"]
    run, = [e for e in trace if e["name"] == "run"]
    assert meta["args"]["run_id"] == run["args"]["run_id"] == ids[1]
    # The run span holds the others; setup starts with it and ends
    # before level 0, finish starts after the last level.
    setup, = [e for e in trace if e["name"] == "setup"]
    fin, = [e for e in trace if e["name"] == "finish"]
    levels = [e for e in trace if e["name"] == "level"]
    assert setup["ts"] == run["ts"]
    assert setup["ts"] + setup["dur"] <= min(e["ts"] for e in levels)
    assert fin["ts"] >= max(e["ts"] + e["dur"] for e in levels)
    assert run["ts"] + run["dur"] >= fin["ts"] + fin["dur"]


def test_a_collection_in_a_run_is_a_gc_span(tmp_path, monkeypatch):
    spans = tmp_path / "t.json"
    eng, roots = engine(trace_out=str(spans))
    real = BFSEngine._account_chunk
    collected = []

    def account(self, *a, **kw):
        if not collected:
            collected.append(gc.collect())
        return real(self, *a, **kw)

    monkeypatch.setattr(BFSEngine, "_account_chunk", account)
    res, _ = timed_run(eng, roots)
    assert res.gc["collections"] >= 1 and res.gc["gen2_collections"] >= 1
    assert res.gc["seconds"] >= res.gc["gen2_seconds"] > 0
    trace = validate_chrome_trace(str(spans))
    gcs = [e for e in trace if e["name"] == "gc"]
    assert any(e["args"]["generation"] == 2 for e in gcs)
    assert all(e["dur"] >= 1e3 for e in gcs)
    # The watch leaves with the run; the counters reach the registry.
    assert not any(isinstance(c, events.GcWatch) for c in gc.callbacks)
    counters = eng.metrics.snapshot()["counters"]
    assert counters["gc/seconds"] >= res.gc["seconds"]
    assert counters["alloc/retries"] == counters["alloc/device_mallocs"] \
        == 0
    assert res.alloc == {} and res.device_seconds == 0.0


def test_device_memory_stats_keeps_the_jax_keys(monkeypatch):
    assert events.device_memory_stats("cpu") == {}
    stats = {"allocated_bytes": {"all": {"current": 7, "peak": 9}},
             "reserved_bytes": {"all": {"current": 64}},
             "num_alloc_retries": 2, "num_device_alloc": 5,
             "num_device_free": 3}

    class Props:
        total_memory = 80

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict",
                        lambda idx: stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda idx: Props)
    got = events.device_memory_stats("cuda:0")
    assert got == {"bytes_in_use": 7, "peak_bytes_in_use": 9,
                   "bytes_limit": 80, "reserved_bytes": 64,
                   "alloc_retries": 2, "device_mallocs": 5,
                   "device_frees": 3}
    later = dict(got, alloc_retries=3, device_mallocs=9, reserved_bytes=32)
    assert events.alloc_delta(got, later) == {
        "retries": 1, "device_mallocs": 4, "device_frees": 0,
        "reserved_start": 64, "reserved_end": 32}
    assert events.alloc_delta({}, later) == {}


def test_a_degraded_run_keeps_the_failed_attempts_seconds(monkeypatch):
    """Out of device memory mid-run: the rebuild at half the batch and the
    failed attempt stay in the phases, which still cover the run and
    still equal the registry's."""
    eng, roots = engine(batch=64)
    real = BFSEngine._run_chunk
    calls = [0]

    def run_chunk(self, *args, **kw):
        calls[0] += 1
        if calls[0] == 4:
            time.sleep(0.05)             # the failed attempt's own time
            raise torch.cuda.OutOfMemoryError("injected")
        return real(self, *args, **kw)

    monkeypatch.setattr(BFSEngine, "_run_chunk", run_chunk)
    res, wall = timed_run(eng, roots)
    assert (res.distinct, res.levels) == L5
    assert res.degraded and res.degraded[0][:2] == (64, 32)
    assert 0 <= wall - sum(res.phases.values()) < 1e-3, res.phases
    assert res.phases["loop"] >= 0.05
    got = eng.metrics.phase_seconds()
    assert got == pytest.approx({k: v for k, v in res.phases.items()
                                 if v > 0})
