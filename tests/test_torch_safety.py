"""The port's safety suite and smoke roots vs the JAX package's.

Each of the nine predicates of ``raft_tla_tpu_torch/models/safety.py`` is
held, state for state with no tolerance, against the JAX predicate of the
same name under ``jax.vmap``, and each port mirror against the JAX mirror:
on reachable states of a bounded 2-server model (where the whole suite
holds) and on unstructured random states (where it often fails) at three
dims, the north-star model's among them.  The nine crafted violations of
``tests/test_safety.py`` pin each predicate's failure mode, and the port's
``models/smoke.py`` must draw the JAX package's roots for one seed.
"""

import os

import jax
import numpy as np
import pytest

from raft_tla_tpu.models import oracle as orc
from raft_tla_tpu.models import smoke as j_smoke
from raft_tla_tpu.models.dims import RaftDims as JDims
from raft_tla_tpu.models.invariants import Bounds as JBounds
from raft_tla_tpu.models.invariants import constraint_py
from raft_tla_tpu.models.pystate import init_state as j_init_state
from raft_tla_tpu.models.safety import SAFETY_INVARIANTS as J_SAFETY
from raft_tla_tpu.models.safety import SAFETY_INVARIANTS_PY as J_SAFETY_PY
from raft_tla_tpu.models.schema import encode_state as j_encode
from raft_tla_tpu.models.schema import stack_states as j_stack
from raft_tla_tpu_torch.engine.check import resolve_invariants
from raft_tla_tpu_torch.models import smoke
from raft_tla_tpu_torch.models.dims import RaftDims
from raft_tla_tpu_torch.models.invariants import invariant_registry
from raft_tla_tpu_torch.models.safety import (SAFETY_INVARIANTS,
                                              SAFETY_INVARIANTS_PY)
from raft_tla_tpu_torch.models.schema import encode_state, stack_states
from raft_tla_tpu_torch.ops.chunk_front_cuda import predicate_codes
from raft_tla_tpu_torch.utils.cfg import load_config

from tests.test_safety import DIMS2, _crafted_violations
from tests.test_torch_schema_fp import to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = list(SAFETY_INVARIANTS)
DIMS3 = JDims(n_servers=3, n_values=2, max_log=3, n_msg_slots=12)
TPURAFT = JDims(n_servers=5, n_values=2, max_log=5, n_msg_slots=48)
SETS = ("reachable DIMS2", "random DIMS2", "random DIMS3",
        "random TPUraft")


def port_dims(jd):
    return RaftDims(n_servers=jd.n_servers, n_values=jd.n_values,
                    max_log=jd.max_log, n_msg_slots=jd.n_msg_slots)


@pytest.fixture(scope="module")
def state_sets():
    """name -> (JAX dims, JAX PyStates): the oracle BFS of
    tests/test_safety.py (bounded 2-server model) and random_states(...,
    seed=7) at DIMS2, DIMS3 and the north-star dims."""
    bounds = JBounds(max_term=2, max_log_len=1, max_msg_count=1)
    res = orc.bfs([j_init_state(DIMS2)], DIMS2,
                  constraint=constraint_py(bounds), check_deadlock=False,
                  stop_predicate=lambda r: r.distinct_states >= 1200)
    reach = list(res.parent.keys())
    assert len(reach) >= 500
    return {"reachable DIMS2": (DIMS2, reach),
            "random DIMS2": (DIMS2, j_smoke.random_states(DIMS2, 150, 7)),
            "random DIMS3": (DIMS3, j_smoke.random_states(DIMS3, 150, 7)),
            "random TPUraft": (TPURAFT,
                               j_smoke.random_states(TPURAFT, 150, 7))}


def both(name, jd, states):
    """(port predicate, JAX predicate) values on ``states``."""
    d = port_dims(jd)
    batch = stack_states([encode_state(to_port(s), d) for s in states],
                         "cpu")
    got = SAFETY_INVARIANTS[name](d)(batch).numpy()
    jbatch = j_stack([j_encode(s, jd) for s in states])
    want = np.asarray(jax.jit(jax.vmap(J_SAFETY[name](jd)))(jbatch))
    return got, want


@pytest.mark.parametrize("which", SETS)
@pytest.mark.parametrize("name", NAMES)
def test_predicate_equals_jax(state_sets, name, which):
    jd, states = state_sets[which]
    got, want = both(name, jd, states)
    assert got.dtype == bool and got.shape == (len(states),)
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, (name, which, states[int(bad[0])])
    if which == "reachable DIMS2":
        assert got.all(), f"{name} fails on a reachable state"
    # The mirrors: the port's on port states, the JAX package's on its own.
    mirror = np.array([SAFETY_INVARIANTS_PY[name](to_port(s), port_dims(jd))
                       for s in states])
    j_mirror = np.array([J_SAFETY_PY[name](s, jd) for s in states])
    assert (mirror == j_mirror).all() and (mirror == got).all()


def test_random_states_break_every_predicate(state_sets):
    """The random sets reach each predicate's False path somewhere."""
    for name in NAMES:
        hit = []
        for which in SETS[1:]:
            jd, states = state_sets[which]
            got, _want = both(name, jd, states)
            hit.append(int((~got).sum()))
        assert sum(hit) > 0, (name, hit)


@pytest.mark.parametrize("name,dims,state", _crafted_violations(),
                         ids=[x[0] for x in _crafted_violations()])
def test_crafted_violation_detected(name, dims, state):
    d, s = port_dims(dims), to_port(state)
    assert SAFETY_INVARIANTS_PY[name](s, d) is False
    batch = stack_states([encode_state(s, d)], "cpu")
    assert not bool(SAFETY_INVARIANTS[name](d)(batch)[0])
    # Only the predicate it was built for need fail: the others agree
    # with their JAX twins on it all the same.
    for other in NAMES:
        got, want = both(other, dims, [state])
        assert (got == want).all(), other


@pytest.mark.parametrize("seed", [0, 7, 24])
def test_smoke_roots_equal_jax(seed):
    jd = JDims(n_servers=3, n_values=2, max_log=3, n_msg_slots=32)
    d = port_dims(jd)
    got = smoke.smoke_init_states(d, k=2, seed=seed)
    want = j_smoke.smoke_init_states(jd, k=2, seed=seed)
    assert len(got) == 512
    assert got == [to_port(s) for s in want]
    got = smoke.random_states(d, 60, seed=seed)
    assert got == [to_port(s) for s in j_smoke.random_states(jd, 60, seed)]


def test_registry_order_and_safety_cfg_resolves():
    """The registry is the JAX package's, in its order; MCraft_safety.cfg
    resolves to its ten predicates, each with device code in the v4
    front, in the cfg's order."""
    from raft_tla_tpu.models.invariants import (invariant_registry
                                                as j_registry)
    assert list(invariant_registry()) == list(j_registry())
    setup = load_config(os.path.join(REPO, "configs/MCraft_safety.cfg"))
    invs = resolve_invariants(setup)
    assert list(invs) == ["TypeOK"] + NAMES
    assert [f.predicate for f in invs.values()] == list(invs)
    codes = predicate_codes(list(invs.values()))
    assert len(codes) == 10 and len(set(codes)) == 10


def test_front_takes_the_suite_build_only_for_the_suite():
    """The v4 front runs the lanes launch's build with the suite's device
    code exactly when its list names one of the nine, and refuses a list
    longer than the kernel's 16."""
    from raft_tla_tpu_torch.models.actions2 import build_v2
    from raft_tla_tpu_torch.ops.chunk_front_cuda import Front
    setup = load_config(os.path.join(REPO, "configs/MCraft_safety.cfg"))
    d = setup.dims
    reg = {n: b(d) for n, b in invariant_registry().items()}
    kw = dict(dims=d, v2=build_v2(d, "cpu"), constraint=None, B=16, K=256,
              device="cpu")
    assert not Front(inv_fns=[reg["TypeOK"], reg["NoLeaderElected"]],
                     **kw).suite
    for name in NAMES:
        assert Front(inv_fns=[reg["TypeOK"], reg[name]], **kw).suite
    with pytest.raises(ValueError, match="at most 16"):
        Front(inv_fns=list(reg.values()) * 2, **kw)
