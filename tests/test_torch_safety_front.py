"""The v4 chunk front with the safety suite: port vs the JAX ``build_front``.

The JAX front runs in interpret mode with the JAX suite, the port's
``Front`` on CPU tensors takes ``front_plain`` with the port's suite (the
contract the CUDA kernel is held to on the card, ``chip_smoke.py``).  The
parents are random states over the smoke domains (``models/smoke.py``),
where the suite often fails, and a window of reachable MCraft states,
where it holds; the lists are ``configs/MCraft_safety.cfg``'s ten in its
order and the nine in reverse, so that the ids of predicates masked by
earlier ones in one list show in the other.  All 14 outputs equal with
tolerance 0, ``inv`` included.
"""

import os

import jax
import jax.numpy as jnp
import pytest
import torch

from raft_tla_tpu.engine.check import resolve_invariants as j_resolve
from raft_tla_tpu.models import oracle as orc
from raft_tla_tpu.models.actions2 import build_v2 as j_build_v2
from raft_tla_tpu.models.invariants import build_constraint as j_constraint
from raft_tla_tpu.models.invariants import constraint_py
from raft_tla_tpu.models.pystate import init_state as j_init_state
from raft_tla_tpu.ops.chunk_front_pallas import build_front as j_build_front
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch.engine.check import resolve_invariants
from raft_tla_tpu_torch.models import schema as tschema
from raft_tla_tpu_torch.models import smoke
from raft_tla_tpu_torch.models.actions2 import build_v2
from raft_tla_tpu_torch.models.invariants import build_constraint
from raft_tla_tpu_torch.ops import chunk_front_cuda
from raft_tla_tpu_torch.utils.cfg import load_config

from tests.test_torch_front import assert_equal_fronts
from tests.test_torch_schema_fp import to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAFETY = os.path.join(REPO, "configs/MCraft_safety.cfg")
B, K = 8, 256


def windows(dims, states):
    """B-row windows of ``states``, every fourth row marked invalid."""
    st = tschema.stack_states([tschema.encode_state(s, dims)
                               for s in states], "cpu")
    rows = tschema.flatten_state(st, dims)
    out = []
    for base in range(0, rows.shape[0], B):
        w = torch.zeros((B, rows.shape[1]), dtype=torch.uint8)
        part = rows[base:base + B]
        w[:part.shape[0]] = part
        valid = torch.zeros(B, dtype=torch.bool)
        valid[:part.shape[0]] = torch.arange(part.shape[0]) % 4 != 3
        out.append((w, valid))
    return out


@pytest.fixture(scope="module")
def parents():
    """Four windows of random states and two of reachable states (the
    JAX package's oracle BFS of MCraft_safety.cfg to depth 5, every 40th
    state)."""
    jsetup, setup = j_load_config(SAFETY), load_config(SAFETY)
    dims = setup.dims
    rand = smoke.random_states(dims, 4 * B, seed=11)
    res = orc.bfs([j_init_state(jsetup.dims)], jsetup.dims,
                  constraint=constraint_py(jsetup.bounds),
                  check_deadlock=False, max_levels=5)
    reach = [to_port(s) for s in list(res.parent)[::40][:2 * B]]
    return {"random": windows(dims, rand),
            "reachable": windows(dims, reach)}


@pytest.mark.parametrize("order", ["cfg", "reversed"])
def test_front_with_the_suite_equals_jax(parents, order):
    jsetup, setup = j_load_config(SAFETY), load_config(SAFETY)
    jd, d = jsetup.dims, setup.dims
    jinv = list(j_resolve(jsetup).values())
    tinv = list(resolve_invariants(setup).values())
    if order == "reversed":
        jinv, tinv = jinv[:0:-1], tinv[:0:-1]
    jf = j_build_front(dims=jd, v2=j_build_v2(jd),
                       constraint=j_constraint(jd, jsetup.bounds),
                       inv_fns=jinv, B=B, G=jd.n_instances, K=K,
                       interpret=True)
    tf = chunk_front_cuda.Front(dims=d, v2=build_v2(d, "cpu"), inv_fns=tinv,
                                constraint=build_constraint(d, setup.bounds),
                                B=B, K=K, device="cpu")
    assert tf.suite
    seen = {}
    for kind, wins in parents.items():
        seen[kind] = set()
        for rows, valid in wins:
            want = jax.device_get(jf(jnp.asarray(rows.numpy()),
                                     jnp.asarray(valid.numpy())))
            got = tf(rows, valid)
            assert_equal_fronts(want, got)
            seen[kind].update(got.inv[:int(got.total)].tolist())
    # The random parents' successors fail several predicates of the list;
    # the reachable ones' none.
    assert len(seen["random"] - {-1}) >= 4, seen
    assert seen["reachable"] == {-1}, seen
