"""The v2 delta pipeline: port vs JAX ``build_v2``, exactly.

Masks (enabled and overflow over the whole [X, G] grid), the parents'
hash sums and fingerprints, and on every enabled lane the delta
fingerprint and the successor row, on reachable states (oracle BFS to
level 5), leader states, the uint8 packing edges and random states.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tla_tpu.models import oracle as orc
from raft_tla_tpu.models import smoke
from raft_tla_tpu.models.actions2 import build_v2 as j_build_v2
from raft_tla_tpu.models.invariants import constraint_py
from raft_tla_tpu.models.pystate import init_state
from raft_tla_tpu.models.schema import encode_state as j_encode
from raft_tla_tpu.models.schema import flatten_state as j_flatten
from raft_tla_tpu.models.schema import stack_states as j_stack
from raft_tla_tpu.utils.cfg import load_config
from raft_tla_tpu_torch.models import schema as tschema
from raft_tla_tpu_torch.models.actions2 import build_v2 as t_build_v2
from raft_tla_tpu_torch.models.dims import RaftDims as TDims

from tests.test_torch_schema_fp import to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _states(dims, bounds):
    res = orc.bfs([init_state(dims)], dims, constraint=constraint_py(bounds),
                  check_deadlock=False, max_levels=5)
    reach = list(res.parent)
    rng = np.random.RandomState(0)
    picked = [reach[i] for i in rng.choice(len(reach), 200, replace=False)]
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from leader_bench import leader_states
    leaders = leader_states(dims, bounds, 1)[:40]
    base = leaders[0]
    s_cnt = orc.request_vote(orc.timeout(init_state(dims), dims, 0), dims,
                             0, 1)
    mm = sorted(s_cnt.messages)[0][0]
    edges = [
        base.replace(current_term=tuple(255 for _ in base.current_term)),
        base.replace(current_term=(254, 255, 255)),
        base.replace(current_term=(200, 200, 200),
                     log=(((200, 1),), ((200, 2),), ())),
        s_cnt.replace(messages=frozenset({(mm, 255)})),
        s_cnt.replace(messages=frozenset({(mm, 254)})),
        s_cnt.replace(messages=frozenset(list(frozenset(
            ((0, src, dst, t, 1, 0), 1) for src in range(3)
            for dst in range(3) for t in range(1, 6)))[:dims.n_msg_slots])),
    ]
    return picked + leaders + edges + smoke.random_states(dims, 60, seed=9)


@pytest.fixture(scope="module")
def rig():
    setup = load_config(os.path.join(REPO, "configs/MCraft_bounded.cfg"))
    dims = setup.dims
    states = _states(dims, setup.bounds)
    jv2 = j_build_v2(dims)
    G = dims.n_instances

    @jax.jit
    @jax.vmap
    def v2_all(st):
        en, ovf = jv2.masks(st)
        ph = jv2.parent_hash(st)
        h, l, succ = jax.vmap(jv2.lane_out, (None, None, 0))(
            st, ph, jnp.arange(G, dtype=jnp.int32))
        rows = jax.vmap(j_flatten, (0, None))(succ, dims)
        phi, plo = jv2.parent_fp(ph)
        return en, ovf, ph, h, l, rows, phi, plo

    jst = jax.tree.map(jnp.asarray,
                       j_stack([j_encode(s, dims) for s in states]))
    want = jax.tree.map(np.asarray, v2_all(jst))
    tdims = TDims(dims.n_servers, dims.n_values, dims.max_log,
                  dims.n_msg_slots)
    tst = tschema.stack_states(
        [tschema.encode_state(to_port(s), tdims) for s in states], "cpu")
    return tdims, tst, want


def test_masks_equal(rig):
    tdims, tst, want = rig
    en, ovf = t_build_v2(tdims, "cpu").masks(tst)
    assert (en.numpy() == want[0]).all()
    assert (ovf.numpy() == want[1]).all()
    assert want[0].any(axis=1).all() and want[1].any()   # both exercised


def test_parent_hash_and_fp_equal(rig):
    tdims, tst, want = rig
    v2 = t_build_v2(tdims, "cpu")
    ph = v2.parent_hash(tst)
    for name, a, b in zip(ph._fields, ph, want[2]):
        assert (a.numpy() == b.astype(np.int64)).all(), name
    phi, plo = v2.parent_fp(ph)
    assert (phi.numpy() == want[6].astype(np.int64)).all()
    assert (plo.numpy() == want[7].astype(np.int64)).all()


def test_lane_out_equal_on_every_enabled_lane(rig):
    tdims, tst, want = rig
    v2 = t_build_v2(tdims, "cpu")
    en = torch.as_tensor(want[0].copy())
    x, g = en.nonzero(as_tuple=True)
    assert len(x) > 2000
    ph = v2.parent_hash(tst)
    kph = type(ph)(*(f.index_select(0, x) for f in ph))
    kh, kl, succ = v2.lane_out(tschema.gather_states(tst, x), kph, g)
    xs, gs = x.numpy(), g.numpy()
    assert (kh.numpy() == want[3][xs, gs].astype(np.int64)).all()
    assert (kl.numpy() == want[4][xs, gs].astype(np.int64)).all()
    assert (tschema.flatten_state(succ, tdims).numpy()
            == want[5][xs, gs]).all()
