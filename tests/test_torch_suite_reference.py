"""The benchmark's plain reference of the safety suite against the port.

``portbench/reference/suite.py`` (the nine predicates written from
raft.tla:896-1180 over the oracle's state, and ``bfs_suite``, TLC's
search with the list) is held against the port's batched predicates
(``models/safety.py``) and their pure-Python mirrors, state for state:
on unstructured random states (``models/smoke.py random_states``, seed
7), where each predicate must fail somewhere, and on every state
reachable to depth 5.  ``configs/MCraft_safety.cfg`` on the port's v4
path to depth 5 must answer as ``bfs_suite`` does, and carry its
invariants and its front in the result and the span file.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from portbench.reference import oracle, suite
from raft_tla_tpu_torch.engine.bfs import EngineConfig
from raft_tla_tpu_torch.engine.check import (initial_states, make_engine,
                                             resolve_invariants)
from raft_tla_tpu_torch.models.invariants import build_inv_id
from raft_tla_tpu_torch.models import smoke
from raft_tla_tpu_torch.models.pystate import PyState
from raft_tla_tpu_torch.models.safety import (SAFETY_INVARIANTS,
                                              SAFETY_INVARIANTS_PY)
from raft_tla_tpu_torch.models.schema import encode_state, stack_states
from raft_tla_tpu_torch.ops.chunk_front_cuda import PREDICATES
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAFETY = os.path.join(REPO, "configs/MCraft_safety.cfg")
NAMES = list(SAFETY_INVARIANTS)
DEPTH = 5
RANDOM = 3000


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    return load_config(SAFETY)


def ref_dims(setup):
    b = setup.bounds
    return oracle.Dims(n_servers=setup.dims.n_servers,
                       n_values=setup.dims.n_values, max_term=b.max_term,
                       max_log_len=b.max_log_len,
                       max_msg_count=b.max_msg_count)


def as_ref(s):
    """A port state as the reference's (the same fields and layout)."""
    return oracle.PyState(**{f.name: getattr(s, f.name)
                             for f in dataclasses.fields(s)})


def as_port(s):
    return PyState(**{f.name: getattr(s, f.name)
                      for f in dataclasses.fields(s)})


def reachable(dims, depth):
    """Every state of the reference's search to ``depth`` (a state that
    fails the constraint is kept, not expanded)."""
    root = oracle.init_state(dims)
    seen, frontier = {root}, [root]
    for _ in range(depth):
        nxt = []
        for s in frontier:
            for _a, t in oracle.successors(s, dims):
                if t not in seen:
                    seen.add(t)
                    if oracle.bounded_space(t, dims):
                        nxt.append(t)
        frontier = nxt
    return list(seen)


@pytest.fixture(scope="module")
def state_sets(setup):
    """name -> (port PyStates, their batch on the CPU)."""
    rand = smoke.random_states(setup.dims, RANDOM, seed=7)
    reach = [as_port(s) for s in reachable(ref_dims(setup), DEPTH)]
    assert len(reach) == 2300
    return {name: (states, stack_states([encode_state(s, setup.dims)
                                         for s in states], "cpu"))
            for name, states in (("random", rand), ("reachable", reach))}


@pytest.mark.parametrize("name", NAMES)
def test_reference_predicate_equals_the_ports(setup, state_sets, name):
    rdims = ref_dims(setup)
    for which, (states, batch) in state_sets.items():
        got = np.array([suite.PREDICATES[name](as_ref(s), rdims)
                        for s in states])
        port = SAFETY_INVARIANTS[name](setup.dims)(batch).numpy()
        mirror = np.array([SAFETY_INVARIANTS_PY[name](s, setup.dims)
                           for s in states])
        bad = np.nonzero((got != port) | (got != mirror))[0]
        assert bad.size == 0, (name, which, states[int(bad[0])])
        if which == "reachable":
            assert got.all(), f"{name} fails on a reachable state"
        else:
            # An always-true predicate would pass every comparison.
            assert (~got).any(), f"{name} never fails on {which} states"


def test_first_failing_is_the_ports_invariant_id(setup, state_sets):
    """The first of the cfg's ten a random state violates, in the cfg's
    order: the reference's against the port's invariant id, which the
    front reports a lane."""
    states, batch = state_sets["random"]
    ids = build_inv_id(list(resolve_invariants(setup).values()))(batch)
    got = [None if i < 0 else setup.invariants[i] for i in ids.tolist()]
    want = [suite.first_failing(as_ref(s), ref_dims(setup),
                                setup.invariants) for s in states]
    assert got == want
    assert len(set(want)) >= 8


def test_safety_cfg_to_l5_on_v4_equals_bfs_suite(setup, tmp_path):
    spans = tmp_path / "spans.json"
    eng = make_engine(setup, EngineConfig(
        pipeline="v4", batch=128, queue_capacity=1 << 13,
        seen_capacity=1 << 15, max_diameter=DEPTH, trace_out=str(spans)),
        device="cpu")
    res = eng.run(initial_states(setup))
    ref = suite.bfs_suite(ref_dims(setup), DEPTH, setup.invariants)
    assert ref.violation is None and not ref.deadlock
    assert res.violation is None and res.deadlock is None
    assert res.stop_reason == "diameter_budget"
    assert (res.levels, res.distinct, res.generated) == \
        (ref.levels, ref.distinct[-1], ref.generated[-1])
    assert res.action_counts == dict(zip(oracle.FAMILY_NAMES,
                                         ref.actions[-1]))
    # What the run evaluated: the cfg's ten, in the front's suite build.
    assert res.invariants == setup.invariants == ["TypeOK"] + NAMES
    assert res.front == {"build": "suite",
                         "predicates": [PREDICATES[n]
                                        for n in setup.invariants],
                         "launches": {}}
    events = json.loads(spans.read_text())
    run, = [e for e in events if e["name"] == "run" and e["ph"] == "X"]
    setup_span, = [e for e in events
                   if e["name"] == "setup" and e["ph"] == "X"]
    assert run["args"]["invariants"] == res.invariants
    assert setup_span["args"]["front"] == res.front


def test_v3_and_the_mesh_record_their_list_and_no_front(setup):
    """v3 and the mesh evaluate the list in their own lanes stage and
    record it, with no front; a TypeOK-only v4 engine runs the front's
    TypeOK build and records its one name."""
    cfg = EngineConfig(pipeline="v3", batch=128, queue_capacity=1 << 13,
                       seen_capacity=1 << 15, max_diameter=DEPTH)
    eng = make_engine(setup, cfg, device="cpu")
    res = eng.run(initial_states(setup))
    assert (res.distinct, res.generated) == (2300, 5616)
    assert res.front == {} and res.invariants == setup.invariants
    mesh = make_engine(setup, cfg, device="cpu", engine_cls="mesh",
                       devices=["cpu"] * 2)
    got = mesh.run(initial_states(setup))
    assert (got.distinct, got.generated) == (2300, 5616)
    assert got.front == {} and got.invariants == setup.invariants
    typeok = make_engine(dataclasses.replace(setup, invariants=["TypeOK"]),
                         dataclasses.replace(cfg, pipeline="v4"),
                         device="cpu")
    assert typeok.front_info()["build"] == "typeok"
    assert typeok.run(initial_states(setup)).invariants == ["TypeOK"]
