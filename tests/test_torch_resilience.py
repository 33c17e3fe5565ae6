"""The port's resilience (``raft_tla_tpu_torch/resilience/``) against the
JAX package's.

Fault plans parse to the same faults in both packages and fire once; the
sites in the port's engines act where the JAX ones do: a torn snapshot
write and a mid-level kill (soft, ``FaultInjected``) leave a state that
resumes to the uninterrupted counts; a simulated out-of-memory at a chunk
halves the batch and resumes; a seen-set growth that runs out retries
once from the host keys (C7: the ``oom_grow_retry`` event, the JAX
engine's counts under the same plan); a failed disk spill write is
retried once through a fresh file (C6).  The supervisor drives the port's
CLI in subprocesses on the CPU: a kill and a torn write, exit 2 not
retried, exit 1 from an exception retried; each recovered run equals the
pinned counts.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from raft_tla_tpu.engine.bfs import BFSEngine as JEngine
from raft_tla_tpu.engine.bfs import EngineConfig as JConfig
from raft_tla_tpu.models.invariants import build_constraint as j_constraint
from raft_tla_tpu.models.pystate import init_state as j_init_state
from raft_tla_tpu.resilience import faults as jfaults
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch.engine import checkpoint as ckpt_mod
from raft_tla_tpu_torch.engine.bfs import BFSEngine, EngineConfig
from raft_tla_tpu_torch.engine.check import initial_states, run_check
from raft_tla_tpu_torch.engine.spillpool import SpillPool
from raft_tla_tpu_torch.ops import fpset
from raft_tla_tpu_torch.parallel.mesh import MeshBFSEngine
from raft_tla_tpu_torch.resilience import faults
from raft_tla_tpu_torch.resilience.faults import (
    EXIT_FAULT, FaultInjected, FaultPlan, SimulatedResourceExhausted,
    is_resource_exhausted)
from raft_tla_tpu_torch.resilience.supervisor import strip_supervisor_flags
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")
L4 = (527, 1191, [1, 3, 18, 79, 318])
L6 = (9457, 24429, [1, 3, 18, 79, 318, 1218, 4433])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    faults.clear()
    jfaults.clear()


def config(**kw):
    base = dict(batch=64, queue_capacity=1 << 12, seen_capacity=1 << 14,
                check_deadlock=False, max_diameter=4)
    base.update(kw)
    return EngineConfig(**base)


def counts(res):
    return res.distinct, res.generated, res.levels


def read_events(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


# -- the plan -------------------------------------------------------------

PLANS = ["ckpt_torn_write@level=3,kill@level=5,oom@grow=1",
         "oom@level=9;chunk=2", "spill_write@attempt=1",
         "trace_piece_delay@piece=1;seconds=2",
         "ckpt_piece_missing@level=4;piece=0, kill@chunk=x",
         "explode@level=1", "kill@level", " , "]


@pytest.mark.parametrize("text", PLANS)
def test_plans_parse_as_the_jax_package_parses_them(text):
    def parse(mod):
        try:
            plan = mod.FaultPlan.parse(text, hard=False)
        except ValueError as e:
            return ("error", str(e))
        return [(f.site, f.params, f.idx, f.marker, str(f))
                for f in plan.faults]

    assert parse(faults) == parse(jfaults)
    assert faults.KNOWN_SITES == jfaults.KNOWN_SITES
    assert faults.ACTION_PARAMS == jfaults.ACTION_PARAMS
    assert EXIT_FAULT == jfaults.EXIT_FAULT == 86


def test_faults_fire_once_with_markers_that_persist(tmp_path):
    state = str(tmp_path / "state")
    faults.install("kill@level=2,trace_piece_delay@piece=0;seconds=0",
                   state_dir=state, hard=False)
    assert faults.fire("kill", level=1, chunk=1) is False
    with pytest.raises(FaultInjected):
        faults.fire("kill", level=2, chunk=1)
    assert faults.fire("kill", level=2, chunk=1) is False     # once
    # The action's own params never gate the match.
    assert faults.fire("trace_piece_delay", piece=0) is True
    assert sorted(os.listdir(state)) == ["fired_00_kill",
                                         "fired_01_trace_piece_delay"]
    # A restarted process (a new plan on the same markers) fires nothing.
    faults.install("kill@level=2", state_dir=state, hard=False)
    assert faults.fire("kill", level=2, chunk=1) is False
    faults.clear()
    assert faults.ACTIVE is False and faults.fire("kill", level=2) is False


def test_install_from_env_resolves_as_the_jax_package(monkeypatch, tmp_path):
    monkeypatch.setenv("FAULT_PLAN", "oom@level=1")
    monkeypatch.setenv("FAULT_HARD", "0")
    monkeypatch.delenv("FAULT_STATE_DIR", raising=False)
    for mod in (faults, jfaults):
        assert mod.install_from_env(default_state_dir=str(tmp_path / "d"))
        plan = mod._PLAN
        assert (plan.hard, plan.state_dir, str(plan.faults[0])) == (
            False, str(tmp_path / "d"), "oom@level=1")
    assert faults.install_from_env(text="kill@level=3")
    assert str(faults._PLAN.faults[0]) == "kill@level=3"


def test_resource_exhausted_is_the_cards_oom_and_the_stand_in():
    faults.install("oom@level=1", hard=False)
    with pytest.raises(SimulatedResourceExhausted) as info:
        faults.fire("oom", level=1, chunk=1)
    assert "RESOURCE_EXHAUSTED" in str(info.value)
    assert is_resource_exhausted(info.value)
    assert jfaults.is_resource_exhausted(info.value)
    assert is_resource_exhausted(torch.cuda.OutOfMemoryError("out"))
    assert not is_resource_exhausted(RuntimeError("not an OOM"))
    assert not is_resource_exhausted(FaultInjected("injected fault: kill"))


# -- C6: the disk spill write ---------------------------------------------

@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_spill_write_retries_once_then_surfaces(tmp_path, pkg):
    """``spill_write@attempt=1``: the segment lands through a fresh file
    and no torn one stays; two failures surface.  Both packages."""
    if pkg == "torch":
        mod, pool_cls = faults, SpillPool
    else:
        from raft_tla_tpu.engine.spillpool import SpillPool as JPool
        mod, pool_cls = jfaults, JPool
    d = tmp_path / "spill"
    mod.install("spill_write@attempt=1", hard=False)
    pool = pool_cls(str(d))
    rows = np.arange(64, dtype=np.uint8).reshape(8, 8)
    pool.append(rows)
    assert pool.total_rows() == 8 and len(os.listdir(d)) == 1
    np.testing.assert_array_equal(np.asarray(pool.pop(0)), rows)
    mod.install("spill_write@attempt=1,spill_write@attempt=2", hard=False)
    with pytest.raises(OSError, match="twice"):
        pool.append(np.zeros((4, 4), np.uint8))
    assert pool.total_rows() == 0 and os.listdir(d) == []


def test_spill_write_fault_in_a_run_keeps_the_counts(tmp_path):
    """A tiny queue spilling to files through a failed first write: the
    uninterrupted counts."""
    faults.install("spill_write@attempt=1", hard=False)
    res = run_check(BOUNDED, config(max_diameter=6, queue_capacity=1024,
                                    spill_dir=str(tmp_path / "spill")),
                    device="cpu")
    assert counts(res) == L6 and res.spills >= 1
    assert faults._PLAN._fired_local == {"fired_00_spill_write"}


# -- C7: a seen-set growth that runs out of memory -----------------------

def test_grow_retries_from_the_host_keys_after_releasing_the_table():
    eng = BFSEngine(load_config(BOUNDED).dims, config=config(),
                    device="cpu")
    hi = np.arange(1, 701, dtype=np.uint32)
    lo = np.arange(7, 707, dtype=np.uint32)
    seen = fpset.from_host_keys(hi, lo, 1 << 10, "cpu")
    old_keys = seen.keys
    eng._graphs[("sentinel",)] = None
    faults.install("oom@grow=1", hard=False)
    res = type("R", (), {"growth_stalls": []})()
    grown, _t0 = eng._maybe_grow(seen, 700, res, 0.0)
    assert grown.capacity == 1 << 11 and int(grown.size[0]) == 700
    ghi, glo = fpset.to_host_keys(grown)
    np.testing.assert_array_equal(ghi, hi)
    np.testing.assert_array_equal(glo, lo)
    assert old_keys.numel() == 0         # released before the retry
    assert not eng._graphs               # the graphs went first
    assert eng.metrics.counter_value("engine/degraded") == 1
    assert res.growth_stalls[0][0] == 1 << 11
    # Without degradation, or on another error, the growth raises.
    eng.config.degrade_on_oom = False
    faults.install("oom@grow=2", hard=False)
    with pytest.raises(SimulatedResourceExhausted):
        eng._maybe_grow(grown, 1500, res, 0.0)


def test_grow_oom_run_equals_the_jax_engine_under_the_same_plan(tmp_path):
    """``oom@grow=1`` on a table that grows (16,384 slots, the floor at
    batch 128, past half full at L6): the ``degraded`` event with
    ``reason="oom_grow_retry"`` and the JAX engine's counts under the
    same plan."""
    sizes = dict(batch=128, queue_capacity=1 << 12, seen_capacity=512,
                 check_deadlock=False, max_diameter=6)
    setup = j_load_config(BOUNDED)
    jfaults.install("oom@grow=1", hard=False)
    jev = str(tmp_path / "jax.jsonl")
    jeng = JEngine(setup.dims, constraint=j_constraint(setup.dims,
                                                        setup.bounds),
                   config=JConfig(record_trace=False, events_out=jev,
                                  statespace_report=False, **sizes))
    jres = jeng.run([j_init_state(setup.dims)])
    faults.install("oom@grow=1", hard=False)
    ev = str(tmp_path / "port.jsonl")
    res = run_check(BOUNDED, EngineConfig(record_trace=False, events_out=ev,
                                          **sizes), device="cpu")
    assert counts(res) == counts(jres) == L6
    assert res.action_counts == jres.action_counts
    assert [c for c, _s in res.growth_stalls] \
        == [c for c, _s in jres.growth_stalls] == [1 << 15]
    for path in (ev, jev):
        deg = [e for e in read_events(path) if e["event"] == "degraded"]
        assert [(e["reason"], e["capacity"]) for e in deg] == [
            ("oom_grow_retry", 1 << 15)]
        assert deg[0]["error"].startswith("SimulatedResourceExhausted")


# -- a simulated OOM at a chunk, a torn write, a kill ---------------------

def test_oom_at_a_chunk_halves_the_batch_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    ev = str(tmp_path / "ev.jsonl")
    faults.install("oom@level=2;chunk=1", hard=False)
    res = run_check(BOUNDED, config(checkpoint_dir=ck, events_out=ev),
                    device="cpu")
    assert counts(res) == L4
    assert res.engine.config.batch == 32
    deg = [e for e in read_events(ev) if e["event"] == "degraded"]
    assert len(deg) == 1 and deg[0]["reason"] == "resource_exhausted"
    assert (deg[0]["batch"], deg[0]["new_batch"]) == (64, 32)
    assert deg[0]["resume_from"].endswith("level_00002.npz")
    assert res.degraded == [(64, 32, deg[0]["resume_from"])]
    # Below the floor, or with degradation off, it raises.
    faults.install("oom@level=1", hard=False)
    with pytest.raises(SimulatedResourceExhausted):
        run_check(BOUNDED, config(batch=32), device="cpu")
    faults.install("oom@level=1", hard=False)
    with pytest.raises(SimulatedResourceExhausted):
        run_check(BOUNDED, config(degrade_on_oom=False), device="cpu")


def test_torn_write_leaves_the_previous_snapshot_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    faults.install("ckpt_torn_write@level=2", hard=False)
    with pytest.raises(FaultInjected):
        run_check(BOUNDED, config(checkpoint_dir=ck), device="cpu")
    assert os.path.exists(os.path.join(ck, "level_00002.npz.tmp"))
    assert ckpt_mod.latest(ck).endswith("level_00001.npz")
    faults.clear()
    res = run_check(BOUNDED, config(), device="cpu",
                    resume=ckpt_mod.latest(ck))
    assert counts(res) == L4


def test_piece_missing_skips_the_write(tmp_path):
    faults.install("ckpt_piece_missing@level=3", hard=False)
    res = run_check(BOUNDED, config(checkpoint_dir=str(tmp_path)),
                    device="cpu")
    assert counts(res) == L4
    names = sorted(n for n in os.listdir(tmp_path) if n.endswith(".npz"))
    assert names == ["level_00000.npz", "level_00001.npz",
                     "level_00002.npz", "level_00004.npz"]


@pytest.mark.parametrize("engine", ["single", "mesh"])
def test_mid_level_kill_resumes_to_the_full_counts(tmp_path, engine):
    ck = str(tmp_path / "ck")
    faults.install("kill@level=3;chunk=1", hard=False)
    cls = MeshBFSEngine if engine == "mesh" else None
    kw = {"engine_cls": cls, "devices": ["cpu"] * 2} if cls else {}
    with pytest.raises(FaultInjected):
        run_check(BOUNDED, config(checkpoint_dir=ck), device="cpu", **kw)
    path = ckpt_mod.latest(ck)
    assert path.endswith("level_00003.npz")       # died past the snapshot
    faults.clear()
    res = run_check(BOUNDED, config(), device="cpu", resume=path, **kw)
    assert counts(res) == L4


def test_mesh_growth_oom_degrades(tmp_path):
    """The mesh's ``oom@grow`` propagates to the degradation wrapper
    (halve the batch, resume), as in the JAX mesh."""
    faults.install("oom@grow=1", hard=False)
    res = run_check(BOUNDED, config(seen_capacity=512, max_diameter=6,
                                    checkpoint_dir=str(tmp_path)),
                    device="cpu", engine_cls=MeshBFSEngine,
                    devices=["cpu"] * 2)
    assert counts(res) == L6
    assert res.engine.config.batch == 32 and len(res.degraded) == 1


# -- C8 under kept buffers: a warm engine's graphs and run buffers --------

def one_grant(st):
    """No server holds two vote grants: first broken at depth 8 of
    MCraft_bounded, mid-level, after the queue has spilled."""
    g = st.votes_gran
    return sum((g >> b) & 1 for b in range(st.term.shape[1])).le(1).all(1)


def warm_engine(violating=False, **kw):
    """MCraft_bounded on the CPU with its cfg's invariants and constraint
    (and ``one_grant`` when ``violating``), trace on; a 4,096-row queue,
    so deep runs spill."""
    from raft_tla_tpu_torch.engine.check import (resolve_constraint,
                                                 resolve_invariants)
    setup = load_config(BOUNDED)
    inv = resolve_invariants(setup)
    if violating:
        inv = {**inv, "OneGrant": one_grant}
    base = dict(seen_capacity=1 << 15, max_diameter=8 if violating else 6,
                record_trace=True)
    base.update(kw)
    return BFSEngine(setup.dims, invariants=inv,
                     constraint=resolve_constraint(setup),
                     config=config(**base), device="cpu")


def answer(eng, res):
    """What a run answers: counts, levels, families, the violation's state
    and its replayed trace, the trace store's links."""
    v = res.violation
    fps, parents, actions = eng.trace.export()
    return (res.distinct, res.generated, res.levels, res.action_counts,
            res.stop_reason,
            v and (v.invariant, v.fingerprint, repr(v.state),
                   repr(eng.replay(v.fingerprint))),
            sorted(zip(fps.tolist(), parents.tolist(), actions.tolist())))


def kept_pointers(eng):
    return [t.data_ptr() for t in (*eng._queues, eng._seen.keys,
                                   eng._seen.size, eng._tbuf, eng._cs.st,
                                   eng._ctl)]


def resume_l3(eng, tmp_path):
    """A level-3 snapshot of a fresh engine's run, resumed by ``eng``."""
    ck = str(tmp_path / "ck")
    writer = warm_engine(max_diameter=3, checkpoint_dir=ck,
                         checkpoint_interval_seconds=0.0)
    writer.run(initial_states(load_config(BOUNDED)))
    eng.run(resume=eng.resume_point(
        ckpt_mod.load(ckpt_mod.latest(ck))))


@pytest.mark.parametrize("before", ["second_run", "violation", "growth",
                                    "release", "resume"])
def test_a_warm_engine_equals_a_fresh_one(before, tmp_path):
    """C8's point under kept buffers: a warm engine's run, on the buffers
    and graphs an earlier run left, answers as a fresh engine's does,
    whatever that run was: a whole run (on the same buffers), a run that
    stopped on a violation mid-level after spilling, one that grew the
    seen table (kept, larger), one followed by ``release``, or a resumed
    run (whose table the engine keeps)."""
    violating = before == "violation"
    kw = dict(seen_capacity=1 << 10) if before == "growth" else {}
    roots = initial_states(load_config(BOUNDED))
    fresh = warm_engine(violating, **kw)
    want = answer(fresh, fresh.run(roots))
    eng = warm_engine(violating, **kw)
    if before == "resume":
        resume_l3(eng, tmp_path)
        table = eng._seen
    else:
        first = eng.run(roots)
        assert answer(eng, first) == want
        ptrs = kept_pointers(eng)
        if before == "growth":
            assert len(first.growth_stalls) == 2
        if before == "release":
            eng.release()
    res = eng.run(roots)
    assert answer(eng, res) == want
    if before == "second_run":
        assert kept_pointers(eng) == ptrs
    if before == "growth":
        assert not res.growth_stalls and eng._seen.capacity == 1 << 15
    if before == "resume":
        assert eng._seen is table
    assert res.graph_captures == res.graph_hits == 0     # none on the CPU


def test_release_frees_the_kept_buffers():
    """``release`` gives back every buffer a run keeps: the queues, the
    seen table, the trace buffer, the chunk state and control words; the
    graphs go first."""
    import gc
    import weakref
    eng = warm_engine(max_diameter=2)
    eng.run(initial_states(load_config(BOUNDED)))
    kept = [weakref.ref(t) for t in (*eng._queues, eng._seen.keys,
                                     eng._tbuf, eng._cs.st, eng._ctl)]
    eng._graphs[("sentinel",)] = None
    eng.release()
    gc.collect()
    assert not eng._graphs and eng._pool is None
    assert not any(hasattr(eng, n) for n in eng._RUN_BUFFERS)
    assert all(r() is None for r in kept)


def test_the_graph_cache_counts_captures_and_hits(monkeypatch):
    """Each chunk's lookup counts a capture or a hit, on the result and in
    the registry: the first lookup of a buffer set captures, the next
    hit, a growth's new table captures again."""
    from raft_tla_tpu_torch.engine import bfs
    from raft_tla_tpu_torch.engine.bfs import EngineResult
    eng = warm_engine(max_diameter=2)
    eng._warm = True
    monkeypatch.setattr(bfs, "capture_graph",
                        lambda fn, device, pool: object())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    res = EngineResult()
    for key in (("q1", "q0"), ("q0", "q1"), ("q1", "q0"), ("q1", "q0")):
        eng._graph_replay(key, lambda: None, res)
    assert (res.graph_captures, res.graph_hits) == (2, 2)
    seen = fpset.empty(1 << 10, "cpu")
    eng._keep_seen(seen)
    assert not eng._graphs
    eng._graph_replay(("q1", "q0"), lambda: None, res)
    assert (res.graph_captures, res.graph_hits) == (3, 2)
    mt = eng.metrics
    assert (mt.counter_value("engine/graph_captures"),
            mt.counter_value("engine/graph_hits")) == (3, 2)


# -- the supervisor through the port's CLI --------------------------------

def test_strip_supervisor_flags_as_the_jax_package():
    from raft_tla_tpu.resilience.supervisor import (
        strip_supervisor_flags as j_strip)
    for argv in (["check", "m.cfg", "--supervise", "5", "--batch", "64"],
                 ["check", "m.cfg", "--supervise=5", "--resume", "auto"],
                 ["check", "m.cfg", "--resume=auto", "--supervise"],
                 ["check", "--supervise", "--no-trace", "m.cfg"]):
        assert strip_supervisor_flags(argv) == j_strip(argv)


def supervised(tmp_path, plan, *extra, depth=6):
    ck = str(tmp_path / "ck")
    out = subprocess.run(
        [sys.executable, "-m", "raft_tla_tpu_torch", "check", BOUNDED,
         "--device", "cpu", "--max-diameter", str(depth), "--batch", "128",
         "--queue-capacity", "4096", "--seen-capacity", "32768",
         "--checkpoint-dir", ck, "--checkpoint-interval", "0",
         "--progress-interval", "0", "--no-trace", "--supervise",
         "--fault-plan", plan, *extra],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO,
                           OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    ev = os.path.join(ck, "events.jsonl")
    return out, (read_events(ev) if os.path.exists(ev) else [])


def recovered_counts(stdout):
    got = dict(re.findall(r"^(distinct states|states generated|levels)"
                          r"\s+(.+)$", stdout, re.M))
    return (int(got["distinct states"]), int(got["states generated"]),
            json.loads(got["levels"]))


def test_supervisor_recovers_a_torn_write_and_a_kill(tmp_path):
    out, ev = supervised(tmp_path, "ckpt_torn_write@level=3,kill@level=4")
    assert out.returncode == 0, out.stderr[-2000:]
    assert recovered_counts(out.stdout) == L6
    restarts = [e for e in ev if e["event"] == "restart"]
    assert [e["exit_code"] for e in restarts] == [EXIT_FAULT, EXIT_FAULT]
    assert restarts[0]["resume_from"].endswith("level_00002.npz")
    assert restarts[1]["resume_from"].endswith("level_00004.npz")
    assert [e["event"] for e in ev].count("postmortem") == 2
    assert any(e["event"] == "supervised_done" for e in ev)


def test_supervisor_retries_an_exception_and_not_a_usage_error(tmp_path):
    # An out-of-memory with degradation off: the child raises (exit 1,
    # run_end "error"), the supervisor retries, the retry resumes.
    out, ev = supervised(tmp_path, "oom@level=2;chunk=1", "--no-degrade",
                         depth=4)
    assert out.returncode == 0, out.stderr[-2000:]
    assert recovered_counts(out.stdout) == L4
    restarts = [e for e in ev if e["event"] == "restart"]
    assert [e["exit_code"] for e in restarts] == [1]
    assert restarts[0]["resume_from"].endswith("level_00002.npz")
    assert any(e["event"] == "run_end" and e["stop_reason"] == "error"
               for e in ev)
    # --resume auto on an empty directory: the child's usage error (2)
    # is not retried.
    out, ev = supervised(tmp_path / "u", "kill@level=99", "--resume",
                         "auto", depth=2)
    assert out.returncode == 2
    assert [e["event"] for e in ev] == ["supervise_giveup"]
