"""The port's mesh (``raft_tla_tpu_torch/parallel/``) against the JAX
package, on CPU shards (``devices=["cpu"] * n``).

The routed insert against a numpy model of the JAX ``route_insert``
(``raft_tla_tpu/parallel/mesh.py:198-224``) at n = 1, 2, 3 and 8 with
duplicates within and across shards; the shared-P compaction against the
JAX ``build_compactor(reduce_p=...)``; the mesh at n = 1, 2 and 8
against the JAX single-device engine (levels, distinct, generated, family
counts, the stored key set); the ``tests/test_mesh.py`` trace-replay
root against the JAX ``MeshBFSEngine`` at n = 2 (violation fingerprint,
state and replay); spill, growth, disk spill, order independence and a
POR table; snapshots crossing both ways with the JAX single engine and
from n = 2 to n = 3; the distinct budget, progress lines and skew
events; the budgets between the roots' waves, the duration ramp and a
deadlock against the single engine; ``check --engine mesh --device cpu``;
``MeshSimulator``.

The dryrun model's 46,553 / 31 pin takes ~23 s of CPU here, more than
this file's budget allows; ``chip_smoke.py`` pins it on the card, and
``test_seen_set_grows`` forces shard growth at a shorter depth.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from raft_tla_tpu.engine import checkpoint as j_ckpt
from raft_tla_tpu.engine.bfs import BFSEngine as JEngine
from raft_tla_tpu.engine.bfs import EngineConfig as JConfig
from raft_tla_tpu.models.dims import RaftDims as JDims
from raft_tla_tpu.models.invariants import Bounds as JBounds
from raft_tla_tpu.models.invariants import build_constraint as j_constraint
from raft_tla_tpu.models.pystate import PyState as JPyState
from raft_tla_tpu.models.pystate import init_state as j_init_state
from raft_tla_tpu.ops.compact import build_compactor as j_build_compactor
from raft_tla_tpu_torch import cli
from raft_tla_tpu_torch.analysis import por
from raft_tla_tpu_torch.engine import checkpoint as ckpt_mod
from raft_tla_tpu_torch.engine.bfs import BFSEngine, EngineConfig
from raft_tla_tpu_torch.engine.check import (initial_states, make_engine,
                                             make_simulator)
from raft_tla_tpu_torch.engine.simulate import Simulator
from raft_tla_tpu_torch.models.dims import LEADER, RaftDims
from raft_tla_tpu_torch.models.invariants import (Bounds, build_constraint,
                                                  build_type_ok)
from raft_tla_tpu_torch.models.pystate import init_state
from raft_tla_tpu_torch.ops import fpset
from raft_tla_tpu_torch.ops.compact import cap_prefix, choose_k, kspread
from raft_tla_tpu_torch.ops.compact_cuda import compact_plain
from raft_tla_tpu_torch.ops.fpset import EMPTY
from raft_tla_tpu_torch.ops.fpset_cuda import insert
from raft_tla_tpu_torch.parallel.mesh import MeshBFSEngine, route_insert
from raft_tla_tpu_torch.parallel.simulate import MeshSimulator
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")

# tests/test_mesh.py:40-41.
DIMS = RaftDims(n_servers=3, n_values=2, max_log=4, n_msg_slots=24)
BOUNDS = Bounds(max_term=2, max_log_len=1, max_msg_count=1)
JD = JDims(n_servers=3, n_values=2, max_log=4, n_msg_slots=24)
JB = JBounds(max_term=2, max_log_len=1, max_msg_count=1)
DEPTH = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(**kw):
    base = dict(batch=16, queue_capacity=1 << 12, seen_capacity=1 << 15,
                check_deadlock=False, max_diameter=DEPTH)
    base.update(kw)
    return EngineConfig(**base)


def mesh(n, invariants=None, constraint=None, **kw):
    return MeshBFSEngine(DIMS, invariants=invariants,
                         constraint=constraint or build_constraint(DIMS,
                                                                   BOUNDS),
                         config=small(**kw), devices=["cpu"] * n)


def counts(res):
    return res.distinct, res.generated, res.levels, res.action_counts


@pytest.fixture(scope="module")
def jax_single(tmp_path_factory):
    """The JAX single-device engine to DEPTH with a snapshot a level; the
    engine is kept to resume the port's snapshots."""
    d = str(tmp_path_factory.mktemp("jax_ck"))
    eng = JEngine(JD, constraint=j_constraint(JD, JB), config=JConfig(
        batch=16, queue_capacity=1 << 12, seen_capacity=1 << 15,
        check_deadlock=False, max_diameter=DEPTH, record_trace=False,
        statespace_report=False, checkpoint_dir=d,
        checkpoint_interval_seconds=0.0))
    res = eng.run([j_init_state(JD)])
    snaps = {lvl: j_ckpt.load(os.path.join(d, f"level_{lvl:05d}.npz"))
             for lvl in range(DEPTH + 1)}
    return res, snaps, eng


# ---------------------------------------------------------------------------
# The routed insert and the shared-P compaction


def route_model(tables, keys, valid):
    """numpy model of the JAX ``route_insert``: each valid key goes to
    owner ``hi mod n`` (the lanes stably sorted by owner, source-major
    arrival); the owner inserts its arrivals one after another."""
    n, k = len(keys), len(keys[0])
    new = [np.zeros(k, bool) for _ in range(n)]
    for d in range(n):
        for s in range(n):
            q = np.where(valid[s], keys[s], -1)
            owner = ((q >> 32) & 0xFFFFFFFF) % n
            for lane in np.flatnonzero(owner == d):       # stable by lane
                if valid[s][lane] and q[lane] != -1 \
                        and q[lane] not in tables[d]:
                    tables[d].add(int(q[lane]))
                    new[s][lane] = True
    return new


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_route_insert_equals_the_jax_model(n):
    rng = np.random.default_rng(n)
    k = 96
    pool = rng.integers(0, 1 << 63, 160, dtype=np.int64)
    pool[:8] = -pool[:8]                  # keys with the top bit set
    keys = [rng.choice(pool, k) for _ in range(n)]        # duplicates
    keys[0][:4] = keys[0][4:8]            # within a shard
    if n > 1:
        keys[-1][:6] = keys[0][:6]        # across shards
    valid = [rng.random(k) < 0.85 for _ in range(n)]
    # Keys already stored, each on its owner.
    pre = pool[:20]
    owner = ((pre >> 32) & 0xFFFFFFFF) % n
    seens, tables = [], []
    for d in range(n):
        mine = pre[owner == d]
        s = fpset.empty(1 << 10, "cpu")
        insert(s, torch.as_tensor(mine), torch.ones(len(mine), dtype=bool))
        seens.append(s)
        tables.append(set(int(x) for x in mine))
    new, fail = route_insert(seens, [torch.as_tensor(x) for x in keys],
                             [torch.as_tensor(v) for v in valid])
    want = route_model(tables, keys, valid)
    for s in range(n):
        assert new[s].tolist() == want[s].tolist()
        assert not bool(fail[s])
    for d in range(n):
        stored = seens[d].keys[seens[d].keys != EMPTY].numpy()
        assert set(int(x) for x in stored) == tables[d]
        assert int(seens[d].size[0]) == len(tables[d])
        # No key off its owner.
        assert (((stored >> 32) & 0xFFFFFFFF) % n == d).all()
    # One new lane for each key no table held.
    union = set().union(*tables)
    assert sum(int(x.sum()) for x in new) == len(union) - len(set(pre))


@pytest.mark.parametrize("fanout,cap", [(12, 3), (12, 40), (40, 1),
                                        (3, 0), (20, 7)])
def test_shared_p_cap_equals_jax_reduce_p(fanout, cap):
    import jax.numpy as jnp
    B, G = 64, DIMS.n_instances
    K = choose_k(B, G)
    rng = np.random.default_rng(fanout * 100 + cap)
    en = np.zeros((B, G), bool)
    for b in range(B):
        en[b, rng.choice(G, rng.integers(0, fanout + 1), replace=False)] = 1
    P_j, total_j, lane_j, kvalid_j = j_build_compactor(
        B, G, K, reduce_p=lambda p: jnp.minimum(p, cap))(jnp.asarray(en))
    kspr = kspread(B, G, K, "cpu")
    pt, lane, kvalid = compact_plain(torch.as_tensor(en), K, kspr, p_cap=cap)
    assert pt.tolist() == [int(P_j), int(total_j)]
    assert lane.tolist() == np.asarray(lane_j).tolist()
    assert kvalid.tolist() == np.asarray(kvalid_j).tolist()
    # The uncapped compaction cut by cap_prefix: the same lanes.
    pt0, lane0, kvalid0 = compact_plain(torch.as_tensor(en), K, kspr)
    P = torch.tensor([min(int(pt0[0]), cap)])
    total, lane1, kvalid1 = cap_prefix(P, G, lane0, kvalid0, kspr)
    assert int(total) == int(total_j)
    assert lane1.tolist() == lane.tolist()
    assert kvalid1.tolist() == kvalid.tolist()


# ---------------------------------------------------------------------------
# The engine against the JAX engines


@pytest.mark.parametrize("n", [1, 2, 8])
def test_mesh_equals_jax_single(jax_single, n, tmp_path):
    jres, snaps, _eng = jax_single
    ck = str(tmp_path / "ck")
    eng = mesh(n, record_trace=False, checkpoint_dir=ck,
               checkpoint_interval_seconds=0.0)
    res = eng.run([init_state(DIMS)])
    assert counts(res) == (jres.distinct, jres.generated, jres.levels,
                           jres.action_counts)
    assert res.diameter == jres.diameter == DEPTH
    assert res.pipeline == "v3" and res.fused_stages["insert"] == \
        "plain-routed" and "enqueue" in res.fused_reasons
    # The stored key set at the last level, and the frontier's size.
    mine = ckpt_mod.load(os.path.join(ck, f"level_{DEPTH:05d}.npz"))
    assert np.array_equal(mine.seen_hi, snaps[DEPTH].seen_hi)
    assert np.array_equal(mine.seen_lo, snaps[DEPTH].seen_lo)
    assert len(mine.frontier) == len(snaps[DEPTH].frontier)


def near_election_root(mod=init_state, dims=DIMS):
    return dataclasses.replace(
        mod(dims), role=(1, 0, 0), current_term=(2, 2, 2),
        voted_for=(1, 1, 1), votes_responded=(0b001, 0, 0),
        votes_granted=(0b001, 0, 0),
        messages=frozenset({((1, 1, 0, 2, 1, ()), 1)}))


@pytest.mark.skipif(os.cpu_count() == 1,
                    reason="the JAX mesh's virtual devices crash jaxlib's "
                           "CPU client on single-core hosts "
                           "(tests/test_mesh.py:15-30)")
def test_trace_replay_equals_jax_mesh():
    """``tests/test_mesh.py``'s trace-replay root: the same violation
    fingerprint, state and replay as the JAX mesh at n = 2."""
    import jax
    import jax.numpy as jnp
    from raft_tla_tpu.parallel.mesh import MeshBFSEngine as JMesh
    j = JMesh(JD, invariants={"NoLeader": lambda st: jnp.all(st.role != 2)},
              constraint=j_constraint(JD, JBounds(max_term=3, max_log_len=1,
                                                  max_msg_count=1)),
              config=JConfig(batch=16, queue_capacity=1 << 12,
                             seen_capacity=1 << 15, check_deadlock=False,
                             statespace_report=False),
              devices=jax.devices()[:2])
    jres = j.run([JPyState(*dataclasses.astuple(near_election_root()))])
    eng = mesh(2, invariants={"NoLeader":
                              lambda st: (st.role != LEADER).all(1)},
               constraint=build_constraint(DIMS, Bounds(
                   max_term=3, max_log_len=1, max_msg_count=1)),
               max_diameter=None)
    res = eng.run([near_election_root()])
    assert res.stop_reason == jres.stop_reason == "violation"
    assert res.violation.fingerprint == jres.violation.fingerprint
    assert dataclasses.astuple(res.violation.state) == \
        dataclasses.astuple(jres.violation.state)
    assert (res.distinct, res.levels) == (jres.distinct, jres.levels)
    steps, jsteps = eng.replay(res.violation.fingerprint), \
        j.replay(jres.violation.fingerprint)
    assert [(g, dataclasses.astuple(s)) for g, s in steps] == \
        [(g, dataclasses.astuple(s)) for g, s in jsteps]
    assert steps[-1][1] == res.violation.state


def test_spill_growth_and_disk_spill_keep_the_counts(jax_single, tmp_path):
    jres = jax_single[0]
    want = (jres.distinct, jres.generated, jres.levels)
    # queue_capacity 8 a shard rounds up to one batch: every chunk spills.
    res = mesh(4, batch=8, queue_capacity=8, sync_every=4).run(
        [init_state(DIMS)])
    assert res.spills > 0 and counts(res)[:3] == want
    spill = tmp_path / "spill"
    res = mesh(4, batch=8, queue_capacity=8, sync_every=4,
               spill_dir=str(spill)).run([init_state(DIMS)])
    assert res.spills > 0 and counts(res)[:3] == want
    import gc
    gc.collect()
    assert list(spill.iterdir()) == []
    # compact_lanes 1 (K = G): progress limiting under the shared P.
    res = mesh(2, batch=32, compact_lanes=1).run([init_state(DIMS)])
    assert counts(res)[:3] == want


def test_seen_set_grows():
    """2 shards of 1,024 slots (8·K at batch 8): the L6 keys pass half
    load, every shard doubles, and the counts are the roomy run's."""
    roomy = mesh(2, max_diameter=6).run([init_state(DIMS)])
    eng = mesh(2, batch=8, seen_capacity=8, max_diameter=6, sync_every=4)
    assert eng._CL == 1024
    res = eng.run([init_state(DIMS)])
    assert res.growth_stalls and res.growth_stalls[0][0] == 2 * 2048
    assert counts(res) == counts(roomy)
    assert (res.distinct, res.generated) == (4239, 10872)   # PERF.md §4


def test_order_independence():
    s = init_state(DIMS)
    roots = [s,
             dataclasses.replace(s, role=(1, 0, 0), current_term=(2, 1, 1)),
             dataclasses.replace(s, role=(0, 1, 0), current_term=(1, 2, 1)),
             dataclasses.replace(s, role=(2, 0, 0),
                                 votes_granted=(0b11, 0, 0))]
    want = BFSEngine(DIMS, constraint=build_constraint(DIMS, BOUNDS),
                     config=small(max_diameter=2), device="cpu").run(roots)
    got = mesh(3, batch=8, max_diameter=2).run(
        [roots[i] for i in (3, 1, 0, 2)])
    assert counts(got) == counts(want)


def test_por_table_on_every_shard():
    from tests.test_por import forged_dup_table
    dims = RaftDims(n_servers=3, n_values=2, max_log=4, n_msg_slots=8)
    table = por.PorTable.from_json(forged_dup_table().to_json())

    def run(engine_cls, **kw):
        cfg = small(max_diameter=3, por_table=table)
        inv = {"TypeOK": build_type_ok(dims)}
        return engine_cls(dims, invariants=inv,
                          constraint=build_constraint(dims, BOUNDS),
                          config=cfg, **kw).run([init_state(dims)])

    single = run(BFSEngine, device="cpu")
    got = run(MeshBFSEngine, devices=["cpu"] * 2)
    assert got.por_instances == single.por_instances > 0
    assert counts(got) == counts(single)
    assert got.action_pruned == single.action_pruned
    assert sum(got.action_pruned.values()) > 0


# ---------------------------------------------------------------------------
# Snapshots


def test_snapshots_cross_both_ways(jax_single, tmp_path):
    jres, _snaps, jeng = jax_single
    want = (jres.distinct, jres.generated, jres.levels)
    jpath = os.path.join(jeng.config.checkpoint_dir, "level_00003.npz")
    # JAX single -> port mesh (n = 2).
    got = mesh(2, record_trace=False).run(resume=jpath)
    assert counts(got)[:3] == want
    assert got.action_counts == jres.action_counts
    # Port mesh (n = 2) -> port mesh (n = 3) and -> JAX single.
    ck = str(tmp_path / "ck")
    mesh(2, record_trace=False, max_diameter=3, checkpoint_dir=ck,
         checkpoint_interval_seconds=0.0).run([init_state(DIMS)])
    path = os.path.join(ck, "level_00003.npz")
    got = mesh(3, record_trace=False).run(resume=path)
    assert counts(got)[:3] == want
    jgot = jeng.run(resume=path)
    assert (jgot.distinct, jgot.generated, jgot.levels) == want


def test_traced_snapshot_resumes_and_replays(tmp_path):
    """A traced snapshot of the mesh resumed by the single engine and the
    other way round: the noleader cfg's depth-9 counterexample."""
    from raft_tla_tpu_torch.engine.check import run_check
    noleader = os.path.join(REPO, "configs/MCraft_noleader.cfg")
    ck = str(tmp_path / "ck")
    cfg = EngineConfig(batch=64, queue_capacity=1 << 13,
                       seen_capacity=1 << 16, checkpoint_dir=ck,
                       checkpoint_interval_seconds=0.0, max_diameter=4,
                       statespace_report=False)
    run_check(noleader, cfg, device="cpu", engine_cls="mesh",
              devices=["cpu"] * 2)
    rest = dataclasses.replace(cfg, max_diameter=None, checkpoint_dir=None)
    res = run_check(noleader, rest, device="cpu",
                    resume=os.path.join(ck, "level_00004.npz"))
    assert res.violation is not None
    assert len(res.engine.replay(res.violation.fingerprint)) == 10


# ---------------------------------------------------------------------------
# Budgets, progress, skew, the CLI


def test_distinct_budget_and_progress_lines(capfd):
    res = mesh(2, max_diameter=None,
               exit_conditions=(("distinct", 100),)).run([init_state(DIMS)])
    assert res.stop_reason == "distinct_budget" and res.distinct > 100
    mesh(2, progress_interval_seconds=1e-6).run([init_state(DIMS)])
    err = capfd.readouterr().err
    assert "progress:" in err and "queue" in err


def thirteen_roots():
    """The initial state and twelve candidates and voters of terms 1-2:
    four waves of roots at batch 4."""
    s = init_state(DIMS)
    out = [s]
    for t in (1, 2):
        for r in range(3):
            terms = tuple(t if i == r else 1 for i in range(3))
            out.append(dataclasses.replace(
                s, role=tuple(int(i == r) for i in range(3)),
                current_term=terms))
            out.append(dataclasses.replace(
                s, current_term=terms,
                voted_for=tuple(r + 1 if i == r else 0 for i in range(3))))
    return out


@pytest.mark.parametrize("n,kw,stop", [
    (1, dict(batch=4, max_seconds=0.0), "duration_budget"),
    (1, dict(batch=4, exit_conditions=(("distinct", 5),)), "distinct_budget"),
    (1, dict(batch=4, queue_capacity=4, exit_conditions=(("queue", 6),)),
     "queue_budget"),
    (2, dict(max_seconds=1e6), "diameter_budget"),
])
def test_ingest_budgets_and_the_ramp_equal_the_single_engine(n, kw, stop):
    """The level loop's budget branches on the mesh: a stop between the
    roots' waves (the first three cases stop at level 0, the third after
    a spill), and a duration budget's chunk ramp, against the single
    engine's counts from the same roots."""
    roots = thirteen_roots()
    want = BFSEngine(DIMS, constraint=build_constraint(DIMS, BOUNDS),
                     config=small(**kw), device="cpu").run(roots)
    got = mesh(n, **kw).run(roots)
    assert got.stop_reason == want.stop_reason == stop
    assert counts(got) == counts(want)
    assert (got.diameter == 0) == (stop != "diameter_budget")
    if n == 1:                  # a shard's queue is Q / n rows
        assert got.spills == want.spills


@pytest.mark.parametrize("n", [1, 2])
def test_deadlock_equals_the_single_engine(monkeypatch, n):
    """The model with one more guard (no action once a term reaches 2):
    the mesh stops on a deadlock at the single engine's level; at n = 1
    on its state and counts, at n = 2 on the lowest flagged shard's."""
    import raft_tla_tpu_torch.engine.bfs as tbfs
    import raft_tla_tpu_torch.parallel.mesh as tmesh
    build = tbfs.build_v2

    def build_v2(dims, device):
        v2 = build(dims, device)

        def guarded(st):
            en, ovf = v2.masks(st)
            live = (st.term.max(1).values < 2)[:, None]
            return en & live, ovf & live

        return v2._replace(masks=guarded)

    monkeypatch.setattr(tbfs, "build_v2", build_v2)
    monkeypatch.setattr(tmesh, "build_v2", build_v2)
    kw = dict(check_deadlock=True, max_diameter=None)
    want = BFSEngine(DIMS, constraint=build_constraint(DIMS, BOUNDS),
                     config=small(**kw), device="cpu").run(
                         [init_state(DIMS)])
    eng = mesh(n, **kw)
    got = eng.run([init_state(DIMS)])
    assert got.stop_reason == want.stop_reason == "deadlock"
    assert got.diameter == want.diameter
    assert max(got.deadlock.current_term) == 2
    assert not eng.successors(got.deadlock)[0].any()
    if n == 1:
        assert got.deadlock == want.deadlock
        assert counts(got) == counts(want)


def test_skew_events_and_level_rows(tmp_path):
    ev = str(tmp_path / "ev.jsonl")
    eng = mesh(4, events_out=ev, skew_warn_ratio=1.0)
    res = eng.run([init_state(DIMS)])
    events = [json.loads(line) for line in open(ev)]
    levels = [e for e in events if e["event"] == "level_complete"]
    skews = [e for e in events if e["event"] == "skew"]
    assert len(levels) == DEPTH + 1 and skews
    for e, row in zip(levels, res.level_stats):
        assert len(e["shard_frontier"]) == 4
        assert sum(e["shard_frontier"]) == e["frontier_rows"]
        assert row["frontier_skew"] == e["frontier_skew"]
    assert skews[0]["balance"]["threshold"] == 1.0
    assert eng.metrics.counter_value("mesh/skew_warnings") == len(skews)
    assert eng.metrics.gauge_value("mesh/shard_seen_max") > 0


def test_cli_check_engine_mesh_on_cpu(capsys):
    rc = cli.main(["check", BOUNDED, "--device", "cpu", "--engine", "mesh",
                   "--max-diameter", "4", "--batch", "64",
                   "--progress-interval", "0"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "distinct states    527" in out and "mesh of 1: cpu" in out
    setup = load_config(BOUNDED)
    assert type(make_engine(setup, device="cpu", engine_cls="auto")) \
        is BFSEngine
    assert type(make_engine(setup, device="cpu", engine_cls="mesh")) \
        is MeshBFSEngine
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            MeshBFSEngine(DIMS)              # devices=None: every card


# ---------------------------------------------------------------------------
# MeshSimulator


def near_election_sim(cls, **kw):
    return cls(DIMS, invariants={"NoLeader":
                                 lambda st: (st.role != LEADER).all(1)},
               constraint=build_constraint(DIMS, Bounds(
                   max_term=3, max_log_len=1, max_msg_count=1)),
               batch=32, depth=16, chunk=64, **kw)


def test_mesh_simulator_repeats_and_n1_is_the_simulator():
    roots = [near_election_root()]
    one = near_election_sim(Simulator, device="cpu").run(roots, 1 << 14,
                                                         seed=5)
    got = near_election_sim(MeshSimulator, devices=["cpu"]).run(
        roots, 1 << 14, seed=5)
    assert (got.steps, got.traces, got.violation_invariant) == \
        (one.steps, one.traces, one.violation_invariant)
    assert got.violation_trace == one.violation_trace
    runs = [near_election_sim(MeshSimulator, devices=["cpu"] * 4).run(
        roots, 1 << 14, seed=9) for _ in range(2)]
    assert (runs[0].steps, runs[0].traces) == (runs[1].steps, runs[1].traces)
    assert runs[0].violation_trace == runs[1].violation_trace
    assert runs[0].violation_invariant == "NoLeader"
    setup = load_config(BOUNDED)
    sim = make_simulator(setup, batch=16, device="cpu", engine="mesh")
    assert isinstance(sim, MeshSimulator) and sim.n_dev == 1
    res = sim.run(initial_states(setup), num_steps=3000)
    assert res.steps >= 3000 and res.violation_invariant is None
