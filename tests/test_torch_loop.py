"""The port's device-resident level loop against the JAX engine's.

The chunk of ``sync_every`` batches (``engine/chunk.py ChunkStep`` on
device counters, the trace records in a device buffer drained once a
chunk) on both plans and both tails equals the JAX engine on
MCraft_bounded to L6: counts, levels, per-family counts and the trace
links.  The tiny tables spill and grow as the JAX engine does at the same
``sync_every``; TPUraft's dims give the oracle's L5 counts; an injected
``torch.cuda.OutOfMemoryError`` degrades the batch and resumes from the
run's own newest snapshot; the progress line and ``path_to_state`` equal
the JAX package's.
"""

import dataclasses
import json
import os
import shutil
import time

import pytest
import torch

from raft_tla_tpu.engine import bfs as jbfs
from raft_tla_tpu.engine.bfs import BFSEngine as JEngine
from raft_tla_tpu.engine.bfs import EngineConfig as JConfig
from raft_tla_tpu.engine.check import path_to_state as j_path_to_state
from raft_tla_tpu.models.invariants import build_constraint as j_constraint
from raft_tla_tpu.models.pystate import PyState as JPyState
from raft_tla_tpu.models.pystate import init_state as j_init_state
from raft_tla_tpu.obs import MetricsRegistry
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch.engine import bfs as tbfs
from raft_tla_tpu_torch.engine.bfs import BFSEngine, EngineConfig
from raft_tla_tpu_torch.engine.check import (initial_states, make_engine,
                                             path_to_state, run_check)
from raft_tla_tpu_torch.models.dims import LEADER
from raft_tla_tpu_torch.models.invariants import build_constraint
from raft_tla_tpu_torch.models.pystate import PyState
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")
NOLEADER = os.path.join(REPO, "configs/MCraft_noleader.cfg")
TPURAFT = os.path.join(REPO, "configs/TPUraft.cfg")
L6 = (9457, 24429, [1, 3, 18, 79, 318, 1218, 4433])     # PERF.md §4
# The oracle's TPUraft levels (BASELINE.md, the north-star row).
TPURAFT_L5 = (17852, 50900, [1, 5, 45, 310, 1995, 12306])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread for these runs of many small operations: the
    suite runs in several worker processes at once, and a thread a core
    in each oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def links(trace):
    tf, tp, ta = trace.export()
    return set(zip(tf.tolist(), tp.tolist(), ta.tolist()))


def jax_run(**kw):
    setup = j_load_config(BOUNDED)
    dims = setup.dims
    base = dict(batch=64, queue_capacity=1 << 13, seen_capacity=1 << 14,
                record_trace=True, check_deadlock=False, max_diameter=6,
                statespace_report=False)
    base.update(kw)
    eng = JEngine(dims, constraint=j_constraint(dims, setup.bounds),
                  config=JConfig(**base))
    return eng.run([j_init_state(dims)]), eng


@pytest.fixture(scope="module")
def jax_l6():
    """The JAX engine (v2 plan) to L6: the reference every plan, tail and
    ``sync_every`` of the port must equal."""
    res, eng = jax_run()
    return res, links(eng.trace)


def port_config(**kw):
    base = dict(batch=64, queue_capacity=1 << 13, seen_capacity=1 << 14,
                check_deadlock=False, max_diameter=6)
    base.update(kw)
    return EngineConfig(**base)


@pytest.mark.parametrize("sync_every", [1, 7, 32])
@pytest.mark.parametrize("pipeline,method", [
    ("v3", "fused"), ("v3", "kernel"), ("v4", "fused"), ("v4", "kernel")])
def test_chunk_equals_jax(jax_l6, pipeline, method, sync_every):
    jres, jlinks = jax_l6
    res = run_check(BOUNDED, port_config(pipeline=pipeline,
                                         enqueue_method=method,
                                         sync_every=sync_every),
                    device="cpu")
    assert (res.distinct, res.generated, res.levels) == L6
    assert (res.distinct, res.generated, res.levels) == (
        jres.distinct, jres.generated, jres.levels)
    assert res.action_counts == jres.action_counts
    assert links(res.engine.trace) == jlinks
    assert res.batches == res.steps       # the CPU runs no idle step
    # A chunk is one host round trip of at most sync_every batches.
    assert res.chunks >= -(-res.batches // sync_every)
    if sync_every == 1:
        assert res.chunks == res.batches


def spill_events(path):
    with open(path) as f:
        return sum(1 for line in f if json.loads(line)["event"] == "spill")


def test_tiny_tables_spill_and_grow_as_jax(tmp_path):
    """Batch 32, queue 1,024, seen 256 at sync_every 8: the same spills
    and the same growth capacities as the JAX engine."""
    ev = str(tmp_path / "events.jsonl")
    jres, _eng = jax_run(batch=32, queue_capacity=1024, seen_capacity=256,
                         sync_every=8, record_trace=False, events_out=ev)
    res = run_check(BOUNDED, port_config(
        batch=32, queue_capacity=1024, seen_capacity=256, sync_every=8,
        record_trace=False), device="cpu")
    assert (res.distinct, res.generated, res.levels) == L6
    assert (jres.distinct, jres.generated, jres.levels) == L6
    assert [c for c, _s in res.growth_stalls] \
        == [c for c, _s in jres.growth_stalls]
    assert len(res.growth_stalls) >= 2
    assert res.spills == spill_events(ev) >= 2


def test_noleader_counterexample_through_the_trace_buffer():
    """The depth-9 counterexample on v4 at sync_every 32: the violation
    comes back from the device state, its trace from the device buffer."""
    setup = load_config(NOLEADER)
    engine = make_engine(setup, EngineConfig(
        batch=256, queue_capacity=16384, seen_capacity=65536,
        pipeline="v4", sync_every=32), device="cpu")
    res = engine.run(initial_states(setup))
    assert res.violation is not None
    assert res.violation.invariant == "NoLeaderElected"
    steps = engine.replay(res.violation.fingerprint)
    assert len(steps) - 1 == 9
    assert steps[-1][1] == res.violation.state
    assert LEADER in steps[-1][1].role
    assert all(LEADER not in st.role for _g, st in steps[:-1])
    # Every state found has its record: the buffer lost none.
    assert len(engine.trace) == res.distinct


@pytest.mark.parametrize("pipeline,method", [
    ("v3", "fused"), ("v4", "fused"), ("v4", "kernel")])
def test_tpuraft_l5_equals_the_oracle(pipeline, method):
    """configs/TPUraft.cfg's model (5 servers, 48 message slots) at a
    small batch and small tables."""
    setup = load_config(TPURAFT)
    assert setup.dims.n_servers == 5 and setup.dims.n_msg_slots == 48
    res = make_engine(setup, EngineConfig(
        batch=512, queue_capacity=1 << 14, seen_capacity=1 << 16,
        max_diameter=5, pipeline=pipeline, enqueue_method=method,
        record_trace=False), device="cpu").run(initial_states(setup))
    assert (res.distinct, res.generated, res.levels) == TPURAFT_L5


def inject_oom(monkeypatch, at_chunk):
    """Raise torch.cuda.OutOfMemoryError at the at_chunk-th chunk call
    (once)."""
    real = BFSEngine._run_chunk
    calls = [0]

    def run_chunk(self, *args, **kw):
        calls[0] += 1
        if calls[0] == at_chunk:
            raise torch.cuda.OutOfMemoryError("injected")
        return real(self, *args, **kw)

    monkeypatch.setattr(BFSEngine, "_run_chunk", run_chunk)
    return calls


def test_oom_halves_the_batch_and_resumes_from_the_newest_snapshot(
        monkeypatch, tmp_path):
    inject_oom(monkeypatch, at_chunk=6)
    ckdir = str(tmp_path / "ck")
    res = run_check(BOUNDED, port_config(checkpoint_dir=ckdir,
                                         sync_every=4), device="cpu")
    assert (res.distinct, res.generated, res.levels) == L6
    (before, after, ck), = res.degraded
    assert (before, after) == (64, 32)
    assert ck is not None and os.path.basename(ck).startswith("level_")
    assert res.engine.config.batch == 32
    # The resumed run's trace still reaches the roots.
    tf, _tp, _ta = res.engine.trace.export()
    assert len(tf) == res.distinct


def test_oom_never_resumes_a_snapshot_that_was_there_before(monkeypatch,
                                                            tmp_path):
    """A snapshot in the directory before a fresh run belongs to another
    run: the degraded run restarts from the roots."""
    ckdir = tmp_path / "ck"
    run_check(BOUNDED, port_config(checkpoint_dir=str(ckdir),
                                   max_diameter=5), device="cpu")
    shutil.copy(ckdir / "level_00005.npz", tmp_path / "foreign.npz")
    shutil.rmtree(ckdir)
    ckdir.mkdir()
    shutil.copy(tmp_path / "foreign.npz", ckdir / "level_00005.npz")
    inject_oom(monkeypatch, at_chunk=3)
    res = run_check(BOUNDED, port_config(checkpoint_dir=str(ckdir),
                                         checkpoint_every=1000),
                    device="cpu")
    assert res.degraded == [(64, 32, None)]
    assert (res.distinct, res.generated, res.levels) == L6


def test_oom_below_min_batch_and_other_errors_raise(monkeypatch):
    inject_oom(monkeypatch, at_chunk=2)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        run_check(BOUNDED, port_config(batch=32), device="cpu")
    inject_oom(monkeypatch, at_chunk=2)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        run_check(BOUNDED, port_config(degrade_on_oom=False), device="cpu")

    def boom(self, *a, **kw):
        raise RuntimeError("not an OOM")

    monkeypatch.setattr(BFSEngine, "_run_chunk", boom)
    with pytest.raises(RuntimeError, match="not an OOM"):
        run_check(BOUNDED, port_config(), device="cpu")


def test_progress_line_equals_jax(monkeypatch, capsys):
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    res = tbfs.EngineResult(distinct=123456, generated=7654321, diameter=7)
    jres = jbfs.EngineResult(distinct=123456, generated=7654321,
                             diameter=7)
    reg = MetricsRegistry()
    reg.gauge("engine/seen_size", 123456)
    reg.gauge("engine/seen_capacity", 1 << 18)
    jbfs._progress_line(jres, 958.5, 4321, 15510, metrics=reg)
    want = capsys.readouterr().err.strip()
    got = tbfs.progress_line(res, 958.5, 4321, 15510, 123456 / (1 << 18))
    assert got == want


def test_progress_lines_are_printed(capsys):
    run_check(BOUNDED, port_config(max_diameter=3,
                                   progress_interval_seconds=1e-9,
                                   sync_every=1), device="cpu")
    err = capsys.readouterr().err
    assert err.count("progress: ") >= 3 and "fpset load" in err


def to_port(st: JPyState) -> PyState:
    return PyState(*dataclasses.astuple(st))


def test_path_to_state_equals_jax():
    """A shortest path to a depth-5 state of MCraft_bounded."""
    setup = load_config(BOUNDED)
    dims = setup.dims
    eng = make_engine(setup, port_config(max_diameter=5), device="cpu")
    res = eng.run(initial_states(setup))
    fps, _p, _a = eng.trace.export()
    target = eng.replay(int(fps[-1]))[-1][1]
    cfg = port_config(max_diameter=None)
    path = path_to_state(dims, target,
                         constraint=build_constraint(dims, setup.bounds),
                         config=cfg, device="cpu")
    js = j_load_config(BOUNDED)
    jtarget = JPyState(*dataclasses.astuple(target))
    jpath = j_path_to_state(
        js.dims, jtarget, constraint=j_constraint(js.dims, js.bounds),
        config=JConfig(batch=64, queue_capacity=1 << 13,
                       seen_capacity=1 << 14, statespace_report=False))
    assert len(path) - 1 == 5 == len(jpath) - 1
    assert [g for g, _s in path] == [g for g, _s in jpath]
    assert [s for _g, s in path] == [to_port(s) for _g, s in jpath]
    assert path[-1][1] == target
    assert res.levels[-1] > 0
