"""The port's exhaustive check vs the JAX engine on MCraft_bounded.

The JAX side runs the same v3 plan (Pallas compaction and fused tail in
interpret mode, Pallas insert for the roots) at batch 128; the port runs
on the CPU with its plain versions.  Counts, levels, per-family counts
and the recorded trace links must be equal; deeper runs hold the port to
the pinned oracle profile the JAX suite pins.
"""

import glob
import os

import pytest

from raft_tla_tpu.engine import checkpoint as jckpt
from raft_tla_tpu.engine.bfs import BFSEngine as JEngine
from raft_tla_tpu.engine.bfs import EngineConfig as JConfig
from raft_tla_tpu.models import oracle as orc
from raft_tla_tpu.models.invariants import build_constraint as j_constraint
from raft_tla_tpu.models.pystate import PyState as JPyState
from raft_tla_tpu.models.pystate import init_state as j_init_state
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch.engine.bfs import EngineConfig, ResumePoint
from raft_tla_tpu_torch.engine.check import make_engine, run_check
from raft_tla_tpu_torch.interop import queue_from_numpy, seen_from_numpy
from raft_tla_tpu_torch.models.dims import LEADER
from raft_tla_tpu_torch.utils.cfg import load_config

from tests.test_engine import (MCRAFT_BOUNDED_DISTINCT_L7,
                               MCRAFT_BOUNDED_GEN_L7, MCRAFT_BOUNDED_LEVELS)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")


def port_config(**kw):
    base = dict(batch=128, queue_capacity=1 << 14, seen_capacity=1 << 16,
                check_deadlock=False)
    base.update(kw)
    return EngineConfig(**base)


@pytest.fixture(scope="module")
def jax_l6(tmp_path_factory):
    """JAX v3 (forced full-kernel plan) to L6, with level snapshots."""
    ckdir = str(tmp_path_factory.mktemp("jax_ckpt"))
    setup = j_load_config(BOUNDED)
    dims = setup.dims
    eng = JEngine(dims, constraint=j_constraint(dims, setup.bounds),
                  config=JConfig(batch=128, queue_capacity=1 << 14,
                                 seen_capacity=1 << 16, record_trace=True,
                                 check_deadlock=False, max_diameter=6,
                                 pipeline="v3",
                                 v3_force_stages={"compact": "pallas"},
                                 insert_method="pallas",
                                 checkpoint_dir=ckdir,
                                 statespace_report=False))
    res = eng.run([j_init_state(dims)])
    assert res.fused_stages["compact"] == "pallas"
    assert res.fused_stages["insert"] == "fused"
    tf, tp, ta = eng.trace.export()
    return res, set(zip(tf.tolist(), tp.tolist(), ta.tolist())), ckdir


def test_l6_equals_jax_v3_with_trace_links(jax_l6):
    jres, jlinks, _ = jax_l6
    res = run_check(BOUNDED, port_config(max_diameter=6), device="cpu")
    assert res.distinct == jres.distinct == 9457
    assert res.generated == jres.generated
    assert res.levels == jres.levels
    assert res.diameter == jres.diameter == 6
    assert res.action_counts == jres.action_counts
    tf, tp, ta = res.engine.trace.export()
    assert set(zip(tf.tolist(), tp.tolist(), ta.tolist())) == jlinks


def test_l7_equals_pinned_profile():
    res = run_check(BOUNDED, port_config(max_diameter=7, record_trace=False),
                    device="cpu")
    assert res.distinct == MCRAFT_BOUNDED_DISTINCT_L7
    assert res.generated == MCRAFT_BOUNDED_GEN_L7
    assert res.levels == MCRAFT_BOUNDED_LEVELS[:8]


def test_tiny_seen_and_queue_grow_and_spill(jax_l6):
    jres = jax_l6[0]
    res = run_check(BOUNDED, port_config(batch=32, queue_capacity=1024,
                                         seen_capacity=256, max_diameter=6,
                                         record_trace=False), device="cpu")
    assert len(res.growth_stalls) >= 2 and res.spills >= 2
    assert (res.distinct, res.generated, res.levels) == \
        (jres.distinct, jres.generated, jres.levels)


def test_jax_l4_snapshot_continued_by_the_port(jax_l6):
    jres, _, ckdir = jax_l6
    path, = glob.glob(os.path.join(ckdir, "level_00004*"))
    ck = jckpt.load(path)
    assert ck.diameter == 4
    eng = make_engine(load_config(BOUNDED),
                      port_config(max_diameter=6, record_trace=False),
                      device="cpu")
    resume = ResumePoint(
        frontier=queue_from_numpy(ck.frontier, "cpu"),
        seen=seen_from_numpy(ck.seen_hi, ck.seen_lo, 1 << 16, "cpu"),
        distinct=ck.distinct, generated=ck.generated, diameter=ck.diameter,
        levels=ck.levels, action_counts=ck.action_counts)
    res = eng.run(resume=resume)
    assert (res.distinct, res.generated, res.levels, res.diameter) == \
        (jres.distinct, jres.generated, jres.levels, jres.diameter)
    assert res.action_counts == jres.action_counts


def test_noleader_counterexample_replays_at_minimal_depth():
    res = run_check(os.path.join(REPO, "configs/MCraft_noleader.cfg"),
                    device="cpu")
    assert res.stop_reason == "violation"
    assert res.violation.invariant == "NoLeaderElected"
    steps = res.engine.replay(res.violation.fingerprint)
    assert len(steps) - 1 == 9           # tests/test_explain.py pins 9
    assert steps[-1][1] == res.violation.state
    assert LEADER in steps[-1][1].role
    assert all(LEADER not in st.role for _g, st in steps[:-1])
    dims = j_load_config(os.path.join(REPO, "configs/MCraft_noleader.cfg"))\
        .dims

    def to_jax(s):
        return JPyState(**s.__dict__)

    for (_g0, prev), (g, nxt) in zip(steps, steps[1:]):
        assert to_jax(nxt) in orc.successor_set(to_jax(prev), dims), \
            dims.describe_instance(g)
