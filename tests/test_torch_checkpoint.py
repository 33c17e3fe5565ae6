"""Checkpoint / resume and the exit budgets of the port vs the JAX package.

The two packages share one snapshot format: a JAX run's level snapshot is
resumed by the port, the port's by the JAX engine, and for the same run
the two files hold equal arrays and metadata.  All comparisons are exact
(integers and bytes: tolerance 0); ``wall_seconds`` is the one field that
differs by nature.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from raft_tla_tpu.engine import checkpoint as jckpt
from raft_tla_tpu.engine.bfs import BFSEngine as JEngine
from raft_tla_tpu.engine.bfs import EngineConfig as JConfig
from raft_tla_tpu.models.invariants import build_constraint as j_constraint
from raft_tla_tpu.models.pystate import init_state as j_init_state
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch import cli
from raft_tla_tpu_torch.engine import checkpoint as ckpt
from raft_tla_tpu_torch.engine.bfs import EngineConfig
from raft_tla_tpu_torch.engine.check import (engine_config_from_backend,
                                             initial_states, make_engine,
                                             run_check)
from raft_tla_tpu_torch.interop import checkpoint_from_numpy
from raft_tla_tpu_torch.models.dims import LEADER, RaftDims
from raft_tla_tpu_torch.models.reconfig import ReconfigDims
from raft_tla_tpu_torch.models.schema import state_width
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")
NOLEADER = os.path.join(REPO, "configs/MCraft_noleader.cfg")
L6 = (9457, 24429, [1, 3, 18, 79, 318, 1218, 4433])     # PERF.md §4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread for these runs of many small operations: the
    suite runs in several worker processes at once, and a thread a core
    in each oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(**kw):
    base = dict(batch=128, queue_capacity=1 << 14, seen_capacity=1 << 16,
                check_deadlock=False)
    base.update(kw)
    return EngineConfig(**base)


def jax_engine(**kw):
    setup = j_load_config(BOUNDED)
    base = dict(batch=128, queue_capacity=1 << 14, seen_capacity=1 << 16,
                record_trace=True, check_deadlock=False,
                statespace_report=False)
    base.update(kw)
    return JEngine(setup.dims, constraint=j_constraint(setup.dims,
                                                       setup.bounds),
                   config=JConfig(**base)), setup.dims


def level_file(ckdir, level):
    return os.path.join(str(ckdir), f"level_{level:05d}.npz")


@pytest.fixture(scope="module")
def jax_l3(tmp_path_factory):
    """The JAX engine to L3 with a snapshot at every level."""
    ckdir = str(tmp_path_factory.mktemp("jax_ckpt"))
    eng, dims = jax_engine(max_diameter=3, checkpoint_dir=ckdir)
    res = eng.run([j_init_state(dims)])
    assert res.distinct == 113 and os.path.exists(level_file(ckdir, 3))
    return ckdir


@pytest.fixture(scope="module")
def port_l3(tmp_path_factory):
    """The port to L3 with a snapshot at every level."""
    ckdir = str(tmp_path_factory.mktemp("port_ckpt"))
    res = run_check(BOUNDED, port_config(max_diameter=3,
                                         checkpoint_dir=ckdir),
                    device="cpu")
    assert res.distinct == 113 and res.phases["checkpoint"] > 0
    return ckdir


def links(trace):
    tf, tp, ta = trace if isinstance(trace, tuple) else trace.export()
    return set(zip(np.asarray(tf).tolist(), np.asarray(tp).tolist(),
                   np.asarray(ta).tolist()))


def test_jax_snapshot_resumed_by_the_port_to_the_pinned_l6(jax_l3):
    res = run_check(BOUNDED, port_config(max_diameter=6), device="cpu",
                    resume=level_file(jax_l3, 3))
    assert (res.distinct, res.generated, res.levels) == L6
    assert res.diameter == 6 and res.stop_reason == "diameter_budget"
    assert sum(res.action_counts.values()) == res.generated
    # The trace before and after the resume is one store: a state of the
    # last level replays back to the root the JAX run registered.
    tf, _tp, _ta = res.engine.trace.export()
    steps = res.engine.replay(int(tf[-1]))
    assert steps[0][0] == -1 and len(steps) - 1 == 6


def test_port_snapshot_resumed_by_jax_to_the_pinned_l6(port_l3):
    ck = jckpt.load(level_file(port_l3, 3))
    assert ck.diameter == 3 and ck.distinct == 113
    eng, _dims = jax_engine(max_diameter=6)
    res = eng.run(resume=level_file(port_l3, 3))
    assert (res.distinct, res.generated, res.levels) == L6
    tf, _tp, _ta = eng.trace.export()
    assert len(eng.replay(int(tf[-1]))) - 1 >= 1


@pytest.mark.parametrize("level", [0, 3])
def test_the_two_packages_write_equal_snapshots(jax_l3, port_l3, level):
    with np.load(level_file(jax_l3, level)) as jz, \
            np.load(level_file(port_l3, level)) as pz:
        assert sorted(jz.files) == sorted(pz.files)
        jm = json.loads(bytes(jz["meta"]).decode())
        pm = json.loads(bytes(pz["meta"]).decode())
        assert jm.pop("wall_seconds") >= 0 and pm.pop("wall_seconds") >= 0
        assert jm == pm and pm["version"] == ckpt.FORMAT_VERSION == 4
        for key in ("frontier", "seen_hi", "seen_lo"):
            assert jz[key].dtype == pz[key].dtype
            assert np.array_equal(jz[key], pz[key]), key
        for key in ("trace_fps", "trace_parents", "trace_actions"):
            assert jz[key].dtype == pz[key].dtype
    # Each side's loader reads both files to the same image (the trace
    # as a set: the stores' export orders differ).
    images = [load(level_file(d, level)) for load in (jckpt.load, ckpt.load)
              for d in (jax_l3, port_l3)]
    first = images[0]
    for im in images[1:]:
        assert dataclasses.asdict(im.dims) == dataclasses.asdict(first.dims)
        assert links((im.trace_fps, im.trace_parents, im.trace_actions)) == \
            links((first.trace_fps, first.trace_parents,
                   first.trace_actions))
        assert {k: dataclasses.asdict(v) for k, v in im.roots.items()} == \
            {k: dataclasses.asdict(v) for k, v in first.roots.items()}
        assert (im.distinct, im.generated, im.levels, im.action_counts) == \
            (first.distinct, first.generated, first.levels,
             first.action_counts)
    assert type(images[1].roots.popitem()[1]).__module__.startswith(
        "raft_tla_tpu.")
    assert type(images[2].roots.popitem()[1]).__module__.startswith(
        "raft_tla_tpu_torch.")


def test_latest_skips_torn_files_and_gc_keeps_n(port_l3, tmp_path):
    d = str(tmp_path / "ck")
    shutil.copytree(port_l3, d)
    assert ckpt.latest(d) == level_file(d, 3)
    assert ckpt.latest(str(tmp_path / "missing")) is None
    # A torn write leaves a .tmp beside the snapshots; a truncated file
    # under a snapshot's name is skipped too.
    with open(level_file(d, 5) + ".tmp", "wb") as f:
        f.write(b"torn")
    with open(level_file(d, 4), "wb") as f:
        f.write(open(level_file(d, 3), "rb").read()[:100])
    assert ckpt.latest(d) == jckpt.latest(d) == level_file(d, 3)
    assert ckpt.gc(d, None) == 0 and ckpt.gc(d, 0) == 0
    assert ckpt.gc(d, 2) == 2                    # levels 0 and 1 go
    assert sorted(os.listdir(d)) == [
        "events.jsonl", "level_00002.npz", "level_00003.npz",
        "level_00004.npz", "level_00005.npz.tmp"]
    assert ckpt.gc(d, 5) == 0                    # quota not filled


def test_keep_checkpoints_bounds_the_directory(tmp_path):
    d = str(tmp_path / "ck")
    run_check(BOUNDED, port_config(max_diameter=4, checkpoint_dir=d,
                                   keep_checkpoints=2, record_trace=False),
              device="cpu")
    # The run's events land beside its snapshots (obs/events.py).
    assert sorted(os.listdir(d)) == ["events.jsonl", "level_00003.npz",
                                     "level_00004.npz"]
    d2 = str(tmp_path / "every2")
    run_check(BOUNDED, port_config(max_diameter=4, checkpoint_dir=d2,
                                   checkpoint_every=2, record_trace=False),
              device="cpu")
    assert sorted(os.listdir(d2)) == [
        "events.jsonl", "level_00000.npz", "level_00002.npz",
        "level_00004.npz"]
    d3 = str(tmp_path / "interval")
    run_check(BOUNDED, port_config(max_diameter=4, checkpoint_dir=d3,
                                   checkpoint_interval_seconds=3600.0,
                                   record_trace=False), device="cpu")
    assert sorted(os.listdir(d3)) == ["events.jsonl", "level_00000.npz"]


def test_resumed_run_does_not_rewrite_its_snapshot(port_l3, tmp_path):
    d = str(tmp_path / "ck")
    shutil.copytree(port_l3, d)
    before = open(level_file(d, 3), "rb").read()
    res = run_check(BOUNDED, port_config(max_diameter=5, checkpoint_dir=d),
                    device="cpu", resume=ckpt.latest(d))
    assert res.distinct == 2300
    assert open(level_file(d, 3), "rb").read() == before
    assert os.path.exists(level_file(d, 4)) \
        and os.path.exists(level_file(d, 5))
    # Duration accumulates across the restart.
    assert ckpt.load(level_file(d, 5)).wall_seconds >= \
        ckpt.load(level_file(d, 3)).wall_seconds


def test_refused_resumes(port_l3, tmp_path):
    setup = load_config(BOUNDED)
    path = level_file(port_l3, 3)
    eng = make_engine(setup, port_config(max_diameter=4), device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        eng.run()
    with pytest.raises(ValueError, match="exactly one"):
        eng.run([], resume=path)
    # A trace-carrying snapshot, tracing off, same directory.
    eng = make_engine(setup, port_config(record_trace=False,
                                         checkpoint_dir=port_l3),
                      device="cpu")
    with pytest.raises(ValueError, match="trace-carrying"):
        eng.run(resume=path)
    # A snapshot written without trace, tracing on.
    d = str(tmp_path / "notrace")
    run_check(BOUNDED, port_config(max_diameter=2, checkpoint_dir=d,
                                   record_trace=False), device="cpu")
    eng = make_engine(setup, port_config(max_diameter=4), device="cpu")
    with pytest.raises(ValueError, match="trace recording disabled"):
        eng.run(resume=level_file(d, 2))
    # Other dims.
    other = dataclasses.replace(setup, dims=RaftDims(
        n_servers=3, n_values=2, max_log=3, n_msg_slots=16))
    eng = make_engine(other, port_config(), device="cpu")
    with pytest.raises(ValueError, match="engine dims"):
        eng.run(resume=path)


def test_variant_and_old_snapshots_are_refused(port_l3, tmp_path):
    with np.load(level_file(port_l3, 1)) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["meta"]).decode())

    def write(name, **changes):
        m = dict(meta, **changes)
        arrays["meta"] = np.frombuffer(json.dumps(m).encode(), np.uint8)
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            np.savez_compressed(f, **arrays)
        return path

    # A variant snapshot's metadata rebuilds its dims class, targets and
    # all (the frontier's rows are not read by the load).
    rdims = dict(meta["dims"], targets=[3, 7], n_values=1)
    got = ckpt.load(write("variant.npz", dims_class="ReconfigDims",
                          dims=rdims,
                          state_width=state_width(ReconfigDims(**dict(
                              rdims, targets=(3, 7))))))
    assert type(got.dims) is ReconfigDims and got.dims.targets == (3, 7)
    with pytest.raises(ValueError, match="not in this build's registry"):
        ckpt.load(write("unknown.npz", dims_class="FutureDims"))
    with pytest.raises(ValueError, match="not in"):
        ckpt.load(write("old.npz", version=2))
    with pytest.raises(ValueError, match="row width"):
        ckpt.load(write("width.npz", state_width=meta["state_width"] + 1))
    assert ckpt.load(write("same.npz")).diameter == 1

    class OtherDims(RaftDims):
        pass

    with pytest.raises(TypeError, match="not checkpoint-restorable"):
        ckpt.check_dims_checkpointable(OtherDims(**meta["dims"]))


def test_frontier_larger_than_the_queue_resumes_as_host_segments(tmp_path):
    d = str(tmp_path / "ck")
    run_check(BOUNDED, port_config(max_diameter=5, checkpoint_dir=d,
                                   checkpoint_every=5, record_trace=False),
              device="cpu")
    ck = ckpt.load(level_file(d, 5))
    assert ck.frontier.shape[0] == 1218
    res = run_check(BOUNDED, port_config(batch=32, queue_capacity=512,
                                         max_diameter=6, record_trace=False),
                    device="cpu", resume=ck)
    assert res.engine._Q == 512                   # 1218 rows: three segments
    assert (res.distinct, res.generated, res.levels) == L6


def test_piece_group_of_a_mesh_run_loads_as_one_snapshot(port_l3, tmp_path):
    ck = ckpt.load(level_file(port_l3, 3))
    n = ck.seen_hi.shape[0]
    half = dataclasses.replace(
        ck, frontier=ck.frontier[:30], seen_hi=ck.seen_hi[n // 2:],
        seen_lo=ck.seen_lo[n // 2:], roots={})
    rest = dataclasses.replace(
        ck, frontier=ck.frontier[30:], seen_hi=ck.seen_hi[:n // 2],
        seen_lo=ck.seen_lo[:n // 2], trace_fps=ck.trace_fps[:0],
        trace_parents=ck.trace_parents[:0],
        trace_actions=ck.trace_actions[:0])
    d = str(tmp_path)
    ckpt.save(os.path.join(d, "level_00003.p0of2.npz"), half)
    with pytest.raises(FileNotFoundError, match="incomplete"):
        ckpt.load(os.path.join(d, "level_00003.p0of2.npz"))
    assert ckpt.latest(d) is None
    ckpt.save(os.path.join(d, "level_00003.p1of2.npz"), rest)
    merged = ckpt.load(ckpt.latest(d))
    assert np.array_equal(merged.frontier, ck.frontier)
    assert np.array_equal(merged.seen_hi, ck.seen_hi)
    assert np.array_equal(merged.seen_lo, ck.seen_lo)
    assert links((merged.trace_fps, merged.trace_parents,
                  merged.trace_actions)) == \
        links((ck.trace_fps, ck.trace_parents, ck.trace_actions))
    assert merged.roots == ck.roots
    stale = dataclasses.replace(rest, distinct=ck.distinct + 1)
    ckpt.save(os.path.join(d, "level_00003.p1of2.npz"), stale)
    with pytest.raises(ValueError, match="mixes run generations"):
        ckpt.load(os.path.join(d, "level_00003.p1of2.npz"))
    assert ckpt.latest(d) is None


def test_noleader_replay_reaches_a_root_across_a_resume(tmp_path):
    d = str(tmp_path / "ck")
    first = run_check(NOLEADER, dataclasses.replace(
        engine_config_from_backend(load_config(NOLEADER)), max_diameter=5,
        checkpoint_dir=d, checkpoint_every=5), device="cpu")
    assert first.stop_reason == "diameter_budget"
    res = run_check(NOLEADER, device="cpu", resume=level_file(d, 5))
    assert res.stop_reason == "violation"
    assert res.violation.invariant == "NoLeaderElected"
    steps = res.engine.replay(res.violation.fingerprint)
    assert steps[0][0] == -1 and len(steps) - 1 == 9
    assert steps[-1][1] == res.violation.state
    assert LEADER in steps[-1][1].role
    assert all(LEADER not in st.role for _g, st in steps[:-1])


def test_checkpoint_from_numpy_carries_a_jax_level_boundary(jax_l3):
    jck = jckpt.load(level_file(jax_l3, 3))
    rng = np.random.RandomState(3)
    order = rng.permutation(jck.seen_hi.shape[0])   # any key order goes in
    ck = checkpoint_from_numpy(
        load_config(BOUNDED).dims, jck.frontier, jck.seen_hi[order],
        jck.seen_lo[order], distinct=jck.distinct, generated=jck.generated,
        diameter=jck.diameter, levels=jck.levels,
        action_counts=jck.action_counts)
    assert np.array_equal(ck.seen_hi, jck.seen_hi)
    assert np.array_equal(ck.seen_lo, jck.seen_lo)
    res = run_check(BOUNDED, port_config(max_diameter=6, record_trace=False),
                    device="cpu", resume=ck)
    assert (res.distinct, res.generated, res.levels) == L6
    with pytest.raises(ValueError, match="uint8"):
        checkpoint_from_numpy(ck.dims, jck.frontier.astype(np.int32),
                              jck.seen_hi, jck.seen_lo, distinct=0,
                              generated=0, diameter=0, levels=())


def test_cli_checkpoint_flags_and_resume_auto(tmp_path, capsys):
    d = str(tmp_path / "ck")
    common = ["check", BOUNDED, "--device", "cpu", "--checkpoint-dir", d,
              "--checkpoint-interval", "0"]
    assert cli.main(common + ["--max-diameter", "3", "--keep-checkpoints",
                              "1", "--enqueue-method", "kernel"]) == 0
    assert sorted(os.listdir(d)) == ["events.jsonl", "level_00003.npz"]
    capsys.readouterr()
    assert cli.main(common + ["--max-diameter", "6", "--resume", "auto",
                              "--checkpoint-every", "2"]) == 0
    out = capsys.readouterr().out
    assert f"resuming from {level_file(d, 3)}" in out
    assert "distinct states    9457" in out
    assert "states generated   24429" in out
    assert sorted(os.listdir(d)) == ["events.jsonl", "level_00003.npz",
                                     "level_00004.npz", "level_00006.npz"]
    with pytest.raises(SystemExit):
        cli.main(["check", BOUNDED, "--device", "cpu", "--resume", "auto"])
    with pytest.raises(SystemExit):
        cli.main(["check", BOUNDED, "--device", "cpu", "--resume", "auto",
                  "--checkpoint-dir", str(tmp_path / "empty")])


def test_checkpoint_directives_are_read(tmp_path):
    cfg = tmp_path / "ck.cfg"
    cfg.write_text(open(BOUNDED).read() + f"""
\\* TPU: CHECKPOINT_DIR = {tmp_path}/states
\\* TPU: CHECKPOINT_EVERY = 3
\\* TPU: CHECKPOINT_INTERVAL = 2.5
\\* TPU: KEEP_CHECKPOINTS = 4
""")
    ec = engine_config_from_backend(load_config(str(cfg)))
    assert ec.checkpoint_dir == f"{tmp_path}/states"
    assert (ec.checkpoint_every, ec.checkpoint_interval_seconds,
            ec.keep_checkpoints) == (3, 2.5, 4)


# ---------------------------------------------------------------------------
# TLCGet exit budgets


@pytest.fixture(scope="module")
def jax_budget_engine():
    return jax_engine(batch=64, record_trace=False, max_diameter=8)


@pytest.mark.parametrize("counter,threshold", [
    ("distinct", 1000), ("generated", 3000), ("queue", 700)])
def test_exit_budget_stop_reason_equals_jax(jax_budget_engine, counter,
                                            threshold):
    """Both loops check their budgets after each chunk of ``sync_every``
    batches (32 here, at batch 64), so they stop after the same chunk:
    the stop reason and every counter equal the JAX engine's."""
    conds = ((counter, threshold),)
    jeng, jdims = jax_budget_engine
    jeng.config = dataclasses.replace(jeng.config, exit_conditions=conds)
    jres = jeng.run([j_init_state(jdims)])
    res = run_check(BOUNDED, port_config(batch=64, record_trace=False,
                                         max_diameter=8,
                                         exit_conditions=conds),
                    device="cpu")
    assert res.engine.config.sync_every == jeng.config.sync_every == 32
    assert res.stop_reason == jres.stop_reason == f"{counter}_budget"
    assert (res.distinct, res.generated, res.diameter, res.levels,
            res.action_counts) == (jres.distinct, jres.generated,
                                   jres.diameter, jres.levels,
                                   jres.action_counts)
    if counter != "queue":
        assert getattr(res, counter) > threshold
    assert res.diameter < 8
    assert res.violation is None and res.deadlock is None


def test_cfg_budgets_reach_the_engine(tmp_path):
    """A StopAfter-style CONSTRAINT over TLCGet("distinct") in the cfg's
    companion module becomes the engine's exit condition."""
    (tmp_path / "B.cfg").write_text(open(BOUNDED).read()
                                    + "\nCONSTRAINT StopEarly\n")
    (tmp_path / "B.tla").write_text(
        '---- MODULE B ----\nStopEarly ==\n'
        '    TLCSet("exit", TLCGet("distinct") > 400)\n====\n')
    setup = load_config(str(tmp_path / "B.cfg"))
    assert setup.exit_conditions == (("distinct", 400.0),)
    assert setup.constraints == ["BoundedSpace"]
    eng = make_engine(setup, port_config(record_trace=False), device="cpu")
    assert eng.config.exit_conditions == (("distinct", 400.0),)
    res = eng.run(initial_states(setup))
    assert res.stop_reason == "distinct_budget" and res.distinct > 400
