"""The port's classical v1 pipeline (``models/actions.py``,
``ops/pipeline_v1.py``) against the JAX package's v1, on the CPU.

- ``build_expand``: the same ``en``, ``ovf``, candidate rows and pack
  guard as the JAX ``build_expand`` on every lane of the grid, at
  ``RaftDims(3, 2, 6, 24)`` (``tests/test_actions.py``'s dims) on probe
  and reachable states, and at reconfig3's dims on leader states whose
  extra families fire; ``family_groups`` equal;
- the v1 engine on MCraft_bounded to L6 at batch 128: distinct,
  generated, levels, per-family counts and trace links equal to the JAX
  v1 engine's, its plan and expansion groups; a snapshot resumed; the
  NoLeaderElected trace from a candidate one vote short, against the JAX
  oracle's depth;
- reconfig3 on v1 from leader roots to depth 3, against the JAX oracle;
- the v1 mesh at n = 2 to L5 against the JAX oracle;
- the v1 swarm's visited multiset against the JAX v1 swarm's;
- the v1 stages' roofline rows named as the JAX roofline's.

The PyTorch side runs on one thread (the suite runs in several workers).
"""

import dataclasses
import os
import random

import jax
import numpy as np
import pytest
import torch

from raft_tla_tpu.engine.bfs import BFSEngine as JEngine
from raft_tla_tpu.engine.bfs import EngineConfig as JConfig
from raft_tla_tpu.engine.swarm import SwarmEngine as JSwarm
from raft_tla_tpu.models import actions as jact
from raft_tla_tpu.models import oracle as jorc
from raft_tla_tpu.models import pystate as jps
from raft_tla_tpu.models import schema as jschema
from raft_tla_tpu.models.dims import RaftDims as JDims
from raft_tla_tpu.models.invariants import Bounds as JBounds
from raft_tla_tpu.models.invariants import build_constraint as j_constraint
from raft_tla_tpu.models.invariants import constraint_py as j_constraint_py
from raft_tla_tpu.models.invariants import no_leader_py as j_no_leader_py
from raft_tla_tpu.obs import roofline as jroofline
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch.engine import checkpoint as ckpt_mod
from raft_tla_tpu_torch.engine.bfs import BFSEngine, EngineConfig
from raft_tla_tpu_torch.engine.swarm import SwarmEngine
from raft_tla_tpu_torch.models import actions as tact
from raft_tla_tpu_torch.models import pystate as tps
from raft_tla_tpu_torch.models import schema as tschema
from raft_tla_tpu_torch.models.dims import LEADER, RaftDims
from raft_tla_tpu_torch.models.invariants import (Bounds, build_constraint,
                                                  build_no_leader)
from raft_tla_tpu_torch.obs import roofline
from raft_tla_tpu_torch.ops import pipeline_v1
from raft_tla_tpu_torch.parallel.mesh import MeshBFSEngine
from raft_tla_tpu_torch.utils.cfg import load_config

from test_torch_oracle import one_vote_short, reconfig_leaders

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")
RECONFIG = os.path.join(REPO, "configs/reconfig3.cfg")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_jax(s):
    return jps.PyState(*dataclasses.astuple(s))


def to_port(s):
    return tps.PyState(*dataclasses.astuple(s))


def expand_both(jdims, tdims, states):
    """JAX and port expansions of ``states``: (en, ovf, rows, pack_ok)
    each, the rows [B, G, sw]."""
    jst = jschema.stack_states([jschema.encode_state(to_jax(s), jdims)
                                for s in states])
    expand, pack_ok = jact.build_expand(jdims), \
        jschema.build_pack_guard(jdims)

    @jax.jit
    def run(st):
        cands, en, ovf = jax.vmap(expand)(st)
        rows = jax.vmap(jax.vmap(
            lambda c: jschema.flatten_state(c, jdims)))(cands)
        return en, ovf, rows, jax.vmap(jax.vmap(pack_ok))(cands)

    want = tuple(np.asarray(x) for x in run(jst))
    tst = tschema.stack_states([tschema.encode_state(s, tdims)
                                for s in states], "cpu")
    c, ten, tovf = tact.build_expand(tdims, "cpu", lane_cap=700)(tst)
    B, G = ten.shape
    got = (ten.numpy(), tovf.numpy(), c.rows.view(B, G, -1).numpy(),
           c.pack_ok.numpy())
    return got, want


def test_build_expand_equals_jax_on_every_lane():
    jdims, tdims = JDims(3, 2, 6, 24), RaftDims(3, 2, 6, 24)
    r = jorc.bfs([jps.init_state(jdims)], jdims,
                 constraint=j_constraint_py(JBounds(
                     max_term=3, max_log_len=2, max_msg_count=1)),
                 max_levels=6)
    reach = sorted(r.parent, key=repr)
    random.Random(1).shuffle(reach)
    states = tps.probe_states(tdims) + [to_port(s) for s in reach[:48]]
    got, want = expand_both(jdims, tdims, states)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g, w)
    assert got[0].any() and got[1].sum() == 0
    assert tact.family_groups(tdims) == jact.family_groups(jdims)


def test_build_expand_equals_jax_on_reconfig():
    jsetup, tsetup = j_load_config(RECONFIG), load_config(RECONFIG)
    roots = reconfig_leaders(tsetup.dims)
    nxt = [t for s in roots for _a, t in
           jorc.successors(to_jax(s), jsetup.dims)][::5]
    states = roots + [to_port(s) for s in nxt]
    got, want = expand_both(jsetup.dims, tsetup.dims, states)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    off = tsetup.dims.family_offsets[10]
    assert got[0][:, off:].any()            # the extra families fire
    assert tact.family_groups(tsetup.dims) == \
        jact.family_groups(jsetup.dims)


def port_config(**kw):
    base = dict(batch=128, queue_capacity=1 << 14, seen_capacity=1 << 16,
                check_deadlock=False, pipeline="v1")
    base.update(kw)
    return EngineConfig(**base)


@pytest.fixture(scope="module")
def jax_v1_l6():
    setup = j_load_config(BOUNDED)
    dims = setup.dims
    eng = JEngine(dims, constraint=j_constraint(dims, setup.bounds),
                  config=JConfig(batch=128, queue_capacity=1 << 14,
                                 seen_capacity=1 << 16, record_trace=True,
                                 check_deadlock=False, max_diameter=6,
                                 pipeline="v1", statespace_report=False))
    res = eng.run([jps.init_state(dims)])
    tf, tp, ta = eng.trace.export()
    return res, set(zip(tf.tolist(), tp.tolist(), ta.tolist()))


def test_v1_engine_l6_equals_jax_v1(jax_v1_l6, tmp_path):
    jres, jlinks = jax_v1_l6
    setup = load_config(BOUNDED)
    cons = build_constraint(setup.dims, setup.bounds)
    eng = BFSEngine(setup.dims, constraint=cons, config=port_config(
        max_diameter=6, checkpoint_dir=str(tmp_path),
        checkpoint_interval_seconds=0.0), device="cpu")
    res = eng.run([tps.init_state(setup.dims)])
    assert jres.pipeline == res.pipeline == "v1"
    assert (res.distinct, res.generated, res.levels) == \
        (jres.distinct, jres.generated, jres.levels) == \
        (9457, 24429, [1, 3, 18, 79, 318, 1218, 4433])
    assert res.action_counts == jres.action_counts
    assert res.family_groups == jres.family_groups
    assert res.fused_stages == pipeline_v1.resolve_plan("cpu")
    assert res.fused_reasons == {"enqueue": pipeline_v1.V1_FUSED_REASON}
    tf, tp, ta = eng.trace.export()
    assert set(zip(tf.tolist(), tp.tolist(), ta.tolist())) == jlinks
    # A level-4 snapshot resumed on v1 reaches the same L6.
    snap = os.path.join(str(tmp_path), "level_00004.npz")
    again = BFSEngine(setup.dims, constraint=cons,
                      config=port_config(max_diameter=6), device="cpu")
    res2 = again.run(resume=ckpt_mod.load(snap))
    assert (res2.distinct, res2.generated, res2.levels) == \
        (res.distinct, res.generated, res.levels)


def test_noleader_trace_equals_the_jax_oracle():
    """NoLeaderElected on v1 from a candidate one vote short: the depth of
    the JAX oracle's first violation, and a trace the oracle allows."""
    setup, jsetup = load_config(BOUNDED), j_load_config(BOUNDED)
    dims, jdims = setup.dims, jsetup.dims
    root = one_vote_short(dims)
    want = jorc.bfs([to_jax(root)], jdims,
                    invariants={"NoLeaderElected": j_no_leader_py},
                    constraint=j_constraint_py(jsetup.bounds))
    eng = BFSEngine(dims, invariants={"NoLeaderElected":
                                      build_no_leader(dims)},
                    constraint=build_constraint(dims, setup.bounds),
                    config=port_config(), device="cpu")
    res = eng.run([root])
    assert res.violation.invariant == want.invariant_violation[0]
    steps = eng.replay(res.violation.fingerprint)
    assert len(steps) == len(want.trace_to(want.invariant_violation[1]))
    assert LEADER in steps[-1][1].role and steps[-1][1] == res.violation.state
    for (_g, a), (_h, b) in zip(steps, steps[1:]):
        assert to_jax(b) in jorc.successor_set(to_jax(a), jdims)


def test_reconfig_v1_equals_the_jax_oracle():
    jsetup, setup = j_load_config(RECONFIG), load_config(RECONFIG)
    roots = reconfig_leaders(setup.dims)
    want = jorc.bfs([to_jax(s) for s in roots], jsetup.dims,
                    constraint=j_constraint_py(jsetup.bounds),
                    check_deadlock=False, max_levels=3)
    eng = BFSEngine(setup.dims,
                    constraint=build_constraint(setup.dims, setup.bounds),
                    config=port_config(max_diameter=3, batch=64),
                    device="cpu")
    res = eng.run(roots)
    assert (res.distinct, res.generated, res.levels) == \
        (want.distinct_states, want.generated_states, want.levels)
    assert res.action_counts["InitiateReconfig"] > 0
    assert res.action_counts["FinalizeReconfig"] > 0


def test_v1_mesh_n2_equals_the_jax_oracle():
    setup, jsetup = load_config(BOUNDED), j_load_config(BOUNDED)
    want = jorc.bfs([jps.init_state(jsetup.dims)], jsetup.dims,
                    constraint=j_constraint_py(jsetup.bounds),
                    check_deadlock=False, max_levels=5)
    eng = MeshBFSEngine(setup.dims,
                        constraint=build_constraint(setup.dims, setup.bounds),
                        config=port_config(max_diameter=5),
                        devices=["cpu"] * 2)
    res = eng.run([tps.init_state(setup.dims)])
    assert res.pipeline == "v1"
    assert (res.distinct, res.generated, res.levels) == \
        (want.distinct_states, want.generated_states, want.levels)
    assert res.fused_stages["expand"] == "torch"
    assert res.fused_stages["insert"] == "plain-routed"


SW_DIMS = dict(n_servers=3, n_values=2, max_log=4, n_msg_slots=32)
SW_BOUNDS = dict(max_term=2, max_log_len=1, max_msg_count=1)


def test_v1_swarm_multiset_equals_jax_v1():
    jd, td = JDims(**SW_DIMS), RaftDims(**SW_DIMS)
    kw = dict(walks=24, max_depth=10, chunk=4, ring=8,
              collect_fingerprints=True, hunt=False, pipeline="v1")
    want = JSwarm(jd, constraint=j_constraint(jd, JBounds(**SW_BOUNDS)),
                  **kw).run([jps.init_state(jd)], seed=7, num_steps=16)
    got = SwarmEngine(td, constraint=build_constraint(td, Bounds(
        **SW_BOUNDS)), device="cpu", **kw).run(
            [tps.init_state(td)], seed=7, num_steps=16)
    assert got.pipeline == want.pipeline == "v1"
    assert (got.steps, got.visited, got.traces, got.diameter) == \
        (want.steps, want.visited, want.traces, want.diameter)

    def fps(r):
        f = r.visited_fingerprints
        return f[np.lexsort((f[:, 1], f[:, 0]))]

    assert np.array_equal(fps(got), fps(want))


def test_v1_roofline_rows_are_the_jax_stages():
    dims = load_config(BOUNDED).dims
    rows = roofline.stage_traffic(dims, 2048, 32768, pipeline="v1")
    want = jroofline.stage_traffic(JDims(**dataclasses.asdict(dims)), 2048,
                                   32768, pipeline="v1")
    assert tuple(rows) == tuple(want)
    # Device ops of the walked stages: the expansion's ops and B3; the
    # gathered rows hashed; fpset.pack's five ops and B1; new & cons_ok,
    # the count zeroed and B5.
    assert [rows[s]["launches"] for s in rows] == [1221, 316, 6, 3]
