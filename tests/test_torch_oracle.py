"""The port's pure-Python oracle (``raft_tla_tpu_torch/models/oracle.py``)
against the JAX package's ``models/oracle.py``, and the helpers it needs.

- ``successors`` (the (action, successor) pairs) and ``successor_set`` on
  ``probe_states`` and on a seeded sample of reachable states, at
  MCraft_bounded's dims and at reconfig3's (leader states with a final, a
  pending joint and a committed joint configuration, so both extra
  families fire);
- ``bfs``: counts, levels, the violation pick and its ``trace_to``, and
  the deadlock pick, on MCraft_bounded to L5 (2,300 / 5,616), on a
  NoLeader check from a candidate one vote short, and on reconfig3 from
  leader roots to depth 3;
- the bag helpers, ``constraint_py``, ``no_leader_py`` and
  ``checkable_predicates`` (names and order).
"""

import collections
import dataclasses
import os
import random

import pytest

from raft_tla_tpu.models import invariants as jinv
from raft_tla_tpu.models import oracle as jorc
from raft_tla_tpu.models import pystate as jps
from raft_tla_tpu.models import reconfig as jrc
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch.models import invariants as tinv
from raft_tla_tpu_torch.models import oracle as torc
from raft_tla_tpu_torch.models import pystate as tps
from raft_tla_tpu_torch.models.dims import CANDIDATE, LEADER, RVR
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")
RECONFIG = os.path.join(REPO, "configs/reconfig3.cfg")


def to_port(s):
    return tps.PyState(*dataclasses.astuple(s))


def to_jax(s):
    return jps.PyState(*dataclasses.astuple(s))


def same_successors(tdims, jdims, states):
    for s in states:
        want = jorc.successors(to_jax(s), jdims)
        got = torc.successors(s, tdims)
        # As multisets: the bag's iteration order is the frozenset's,
        # which a copy of a state may change.
        assert collections.Counter((a, to_jax(t)) for a, t in got) == \
            collections.Counter(want)
        assert {to_jax(t) for t in torc.successor_set(s, tdims)} == \
            jorc.successor_set(to_jax(s), jdims)


@pytest.fixture(scope="module")
def bounded():
    jsetup, tsetup = j_load_config(BOUNDED), load_config(BOUNDED)
    want = jorc.bfs([jps.init_state(jsetup.dims)], jsetup.dims,
                    constraint=jinv.constraint_py(jsetup.bounds),
                    max_levels=5)
    return jsetup, tsetup, want


def test_successors_equal_on_probes_and_reachable_states(bounded):
    jsetup, tsetup, want = bounded
    reach = sorted(want.parent, key=repr)
    random.Random(16).shuffle(reach)
    states = (tps.probe_states(tsetup.dims)
              + [to_port(s) for s in reach[:120]])
    assert [to_jax(s) for s in tps.probe_states(tsetup.dims)] == \
        jps.probe_states(jsetup.dims)
    same_successors(tsetup.dims, jsetup.dims, states)


def test_bfs_to_l5_equals_jax(bounded):
    jsetup, tsetup, want = bounded
    got = torc.bfs([tps.init_state(tsetup.dims)], tsetup.dims,
                   constraint=tinv.constraint_py(tsetup.bounds),
                   max_levels=5)
    assert (got.distinct_states, got.generated_states, got.diameter,
            got.levels) == (want.distinct_states, want.generated_states,
                            want.diameter, want.levels) == \
        (2300, 5616, 5, [1, 3, 18, 79, 318, 1218])
    assert got.deadlock_state is want.deadlock_state is None
    assert {to_jax(s) for s in got.parent} == set(want.parent)


def one_vote_short(dims):
    """A candidate one vote short of quorum, the grant in flight."""
    return dataclasses.replace(
        tps.init_state(dims), role=(CANDIDATE, 0, 0), current_term=(2, 2, 2),
        voted_for=(1, 1, 1), votes_responded=(0b001, 0, 0),
        votes_granted=(0b001, 0, 0),
        messages=frozenset({((RVR, 1, 0, 2, 1, ()), 1)}))


def test_violation_deadlock_and_trace_picks_equal_jax(bounded):
    jsetup, tsetup, _want = bounded
    root = one_vote_short(tsetup.dims)
    got = torc.bfs([root], tsetup.dims,
                   invariants={"NoLeader": tinv.no_leader_py},
                   constraint=tinv.constraint_py(tsetup.bounds))
    want = jorc.bfs([to_jax(root)], jsetup.dims,
                    invariants={"NoLeader": jinv.no_leader_py},
                    constraint=jinv.constraint_py(jsetup.bounds))
    name, state = got.invariant_violation
    assert (name, to_jax(state)) == want.invariant_violation
    assert LEADER in state.role
    assert [(a, to_jax(s)) for a, s in got.trace_to(state)] == \
        want.trace_to(want.invariant_violation[1])
    assert (got.distinct_states, got.generated_states, got.levels) == \
        (want.distinct_states, want.generated_states, want.levels)
    # Restart is always enabled, so neither oracle picks a deadlock.
    assert got.deadlock_state is want.deadlock_state is None


def reconfig_leaders(dims):
    """reconfig3 leaders: a final config, a pending joint entry, a
    committed joint entry (FinalizeReconfig enabled), and the three
    canonical elections."""
    def leader(log=(), commit=0, lead=0):
        n = dims.n_servers
        return dataclasses.replace(
            tps.init_state(dims), current_term=(2,) * n,
            role=tuple(LEADER if j == lead else 0 for j in range(n)),
            votes_granted=tuple((1 << n) - 1 if j == lead else 0
                                for j in range(n)),
            log=tuple(tuple(log) if j == lead else () for j in range(n)),
            commit_index=tuple(commit if j == lead else 0 for j in range(n)),
            next_index=tuple(((len(log) + 1,) * n if j == lead
                              else (1,) * n) for j in range(n)))
    jv, fv = jrc.joint_value, jrc.final_value
    return ([leader(), leader(log=((2, jv(7, 3)),)),
             leader(log=((2, jv(7, 3)),), commit=1),
             leader(log=((2, fv(3)), (2, 1)))]
            + [leader(lead=i) for i in (1, 2)])


def test_reconfig_successors_and_bfs_equal_jax():
    jsetup, tsetup = j_load_config(RECONFIG), load_config(RECONFIG)
    roots = reconfig_leaders(tsetup.dims)
    same_successors(tsetup.dims, jsetup.dims, roots)
    fams = {a[0] for s in roots for a, _t in torc.successors(s, tsetup.dims)}
    assert {10, 11} <= fams                 # both extra families fire
    got = torc.bfs(roots, tsetup.dims,
                   constraint=tinv.constraint_py(tsetup.bounds),
                   check_deadlock=False, max_levels=3)
    want = jorc.bfs([to_jax(s) for s in roots], jsetup.dims,
                    constraint=jinv.constraint_py(jsetup.bounds),
                    check_deadlock=False, max_levels=3)
    assert (got.distinct_states, got.generated_states, got.levels) == \
        (want.distinct_states, want.generated_states, want.levels)
    assert {to_jax(s) for s in got.parent} == set(want.parent)
    picked = sorted(got.parent, key=repr)[::37][:40]
    same_successors(tsetup.dims, jsetup.dims, picked)


def test_helpers_equal_jax():
    m1, m2 = (0, 0, 1, 2, 1, 0), (3, 1, 0, 2, 1, 1)
    bag = frozenset()
    jbag = frozenset()
    for op, args in (("add", m1), ("add", m1), ("add", m2),
                     ("remove", m1), ("reply", (m1, m2)), ("remove", m2),
                     ("remove", m2), ("remove", m1)):
        if op == "add":
            bag, jbag = tps.bag_add(bag, args), jps.bag_add(jbag, args)
        elif op == "remove":
            bag, jbag = tps.bag_remove(bag, args), jps.bag_remove(jbag, args)
        else:
            bag = tps.bag_reply(bag, *args)
            jbag = jps.bag_reply(jbag, *args)
        assert bag == jbag
    tsetup, jsetup = load_config(BOUNDED), j_load_config(BOUNDED)
    states = tps.probe_states(tsetup.dims) + [one_vote_short(tsetup.dims)]
    for bounds in (tsetup.bounds, tinv.Bounds(max_term=1),
                   tinv.Bounds(max_in_flight=0, max_log_len=0)):
        jb = jinv.Bounds(**dataclasses.asdict(bounds))
        for s in states:
            assert tinv.constraint_py(bounds)(s, tsetup.dims) == \
                jinv.constraint_py(jb)(to_jax(s), jsetup.dims)
            assert tinv.no_leader_py(s, tsetup.dims) == \
                jinv.no_leader_py(to_jax(s), jsetup.dims)
    assert tinv.CONSTRAINT_PREDICATE == jinv.CONSTRAINT_PREDICATE
    for kw in ({}, {"invariant_names": ["TypeOK", "NoLeaderElected"]},
               {"bounds": tsetup.bounds}):
        jkw = dict(kw)
        if "bounds" in kw:
            jkw["bounds"] = jsetup.bounds
        assert [n for n, _p in tinv.checkable_predicates(tsetup.dims, **kw)] \
            == [n for n, _p in jinv.checkable_predicates(jsetup.dims, **jkw)]
    with pytest.raises(ValueError, match="unknown invariant"):
        tinv.checkable_predicates(tsetup.dims, invariant_names=["Nope"])
