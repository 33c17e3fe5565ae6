"""The port's swarm (``raft_tla_tpu_torch/engine/swarm.py``) walk for walk
against the JAX package's ``SwarmEngine`` (hunt off), on the CPU.

- ``tests/test_swarm.py``'s determinism run: the port's visited-
  fingerprint multiset at batch 48 / 16 / 7 and chunk 5 / 8 equals the JAX
  run's, with equal visited, traces, diameter and stop reason;
- the seeded violation (seed 1, 32 walks): the same invariant, latched
  (step, walk), fingerprint and trace, each step a successor the oracle
  allows;
- the canary pin of ``chip_smoke.py`` (``configs/MCraft_noleader.cfg``,
  256 walks, depth 16, chunk 8, ring 16, seed 3): equal to the JAX run and
  to the constants there;
- a TypeOK-violating root ends the run at once, in both packages;
- ``lane_out``'s delta fingerprint equals ``build_fingerprint`` on the
  successors the walks take; frozen steps change nothing, and each chunk
  starts with a fresh latch and fresh counters.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tla_tpu.engine.check import initial_states as j_initial_states
from raft_tla_tpu.engine.check import resolve_constraint as j_constraint_of
from raft_tla_tpu.engine.check import resolve_invariants as j_invariants_of
from raft_tla_tpu.engine.swarm import SwarmEngine as JSwarm
from raft_tla_tpu.models import oracle as orc
from raft_tla_tpu.models.dims import LEADER as J_LEADER
from raft_tla_tpu.models.dims import RaftDims as JDims
from raft_tla_tpu.models.invariants import Bounds as JBounds
from raft_tla_tpu.models.invariants import build_constraint as j_constraint
from raft_tla_tpu.models.invariants import build_type_ok as j_type_ok
from raft_tla_tpu.models.pystate import PyState as JPyState
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch.engine import swarm as sw
from raft_tla_tpu_torch.engine.check import (SWARM_BATCH, initial_states,
                                             make_swarm, resolve_constraint,
                                             resolve_invariants)
from raft_tla_tpu_torch.engine.swarm import SwarmEngine
from raft_tla_tpu_torch.models.actions2 import build_v2
from raft_tla_tpu_torch.models.dims import LEADER, RaftDims
from raft_tla_tpu_torch.models.invariants import (Bounds, build_constraint,
                                                  build_type_ok)
from raft_tla_tpu_torch.models.pystate import PyState, init_state
from raft_tla_tpu_torch.models.schema import (StateBatch, decode_state,
                                              encode_state, stack_states,
                                              unflatten_state)
from raft_tla_tpu_torch.ops.fingerprint import build_fingerprint
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOLEADER = os.path.join(REPO, "configs/MCraft_noleader.cfg")

DIMS = RaftDims(n_servers=3, n_values=2, max_log=4, n_msg_slots=32)
JD = JDims(n_servers=3, n_values=2, max_log=4, n_msg_slots=32)
BOUNDS = dict(max_term=2, max_log_len=1, max_msg_count=1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_jax(s: PyState) -> JPyState:
    return JPyState(*dataclasses.astuple(s))


def seeded_root():
    """A candidate one vote short of quorum (tests/test_swarm.py's)."""
    return dataclasses.replace(
        init_state(DIMS), role=(1, 0, 0), current_term=(2, 2, 2),
        voted_for=(1, 1, 1), votes_responded=(0b001, 0, 0),
        votes_granted=(0b001, 0, 0),
        messages=frozenset({((1, 1, 0, 2, 1, ()), 1)}))


def port_swarm(roots, *, depth, batch=None, chunk=8, walks=48, ring=8,
               collect=True, **kw):
    return SwarmEngine(
        DIMS, invariants={"TypeOK": build_type_ok(DIMS),
                          "NoLeader": lambda st: (st.role != LEADER).all(1)},
        constraint=build_constraint(DIMS, Bounds(**BOUNDS)), walks=walks,
        max_depth=depth, batch=batch, chunk=chunk, ring=ring,
        collect_fingerprints=collect, device="cpu", **kw)


def jax_swarm(*, depth, walks, chunk=8, ring=8, collect=True, **kw):
    return JSwarm(
        JD, invariants={"TypeOK": j_type_ok(JD),
                        "NoLeader": lambda st: jnp.all(st.role != J_LEADER)},
        constraint=j_constraint(JD, JBounds(**BOUNDS)), walks=walks,
        max_depth=depth, chunk=chunk, ring=ring,
        collect_fingerprints=collect, hunt=False, **kw)


def sorted_fps(res):
    f = res.visited_fingerprints
    return f[np.lexsort((f[:, 1], f[:, 0]))]


def counts(res):
    return (res.steps, res.visited, res.traces, res.diameter,
            res.stop_reason)


@pytest.fixture(scope="module")
def jax_determinism():
    res = jax_swarm(depth=12, walks=48).run(
        [to_jax(init_state(DIMS))], seed=5, num_steps=24)
    return res, sorted_fps(res)


@pytest.mark.parametrize("batch,chunk", [(48, 8), (16, 8), (7, 8), (48, 5),
                                         (16, 5)])
def test_multiset_equals_jax_across_batch_and_chunk(jax_determinism, batch,
                                                    chunk):
    want, want_fps = jax_determinism
    res = port_swarm([init_state(DIMS)], depth=12, batch=batch,
                     chunk=chunk).run([init_state(DIMS)], seed=5,
                                      num_steps=24)
    assert counts(res) == counts(want)
    assert res.steps == 48 * 24 and res.visited > 0 and res.traces > 48
    assert np.array_equal(sorted_fps(res), want_fps)


def test_multiset_is_seed_sensitive(jax_determinism):
    _want, want_fps = jax_determinism
    res = port_swarm([init_state(DIMS)], depth=12).run(
        [init_state(DIMS)], seed=6, num_steps=24)
    assert not np.array_equal(sorted_fps(res), want_fps)


def trace_ids(res):
    return [g for g, _ in res.violation_trace]


def assert_oracle_trace(trace, dims):
    prev = trace[0][1]
    for _g, st in trace[1:]:
        assert to_jax(st) in orc.successor_set(to_jax(prev), dims)
        prev = st


def test_seeded_violation_equals_jax(tmp_path):
    events = str(tmp_path / "events.jsonl")
    jeng = jax_swarm(depth=8, walks=32, collect=False, events_out=events)
    want = jeng.run([to_jax(seeded_root())], seed=1, num_steps=64)
    with open(events) as f:
        latched = [e for e in map(json.loads, f) if e["event"] == "violation"]
    eng = port_swarm([seeded_root()], depth=8, walks=32, collect=False)
    res = eng.run([seeded_root()], seed=1, num_steps=64)
    assert res.stop_reason == want.stop_reason == "violation"
    assert res.violation.invariant == want.violation.invariant == "NoLeader"
    assert res.violation.fingerprint == want.violation.fingerprint
    assert counts(res) == counts(want)
    assert (res.violation_step, res.violation_walk) == \
        (latched[0]["step"], latched[0]["walk"])
    assert trace_ids(res) == [g for g, _ in want.violation_trace]
    assert [to_jax(s) for _, s in res.violation_trace] == \
        [s for _, s in want.violation_trace]
    assert res.violation.state == res.violation_trace[-1][1]
    assert LEADER in res.violation.state.role
    assert eng.replay(res.violation.fingerprint) == res.violation_trace
    assert_oracle_trace(res.violation_trace, JD)


def canary_run(engine_cls, setup, roots, **kw):
    c = chip_smoke().CANARY
    eng = engine_cls(setup.dims, walks=c["walks"], max_depth=c["max_depth"],
                     chunk=c["chunk"], ring=c["ring"], **kw)
    return eng.run(roots, seed=c["seed"], max_seconds=120)


def test_canary_pin_equals_jax_and_chip_smoke():
    cs = chip_smoke()
    jset = j_load_config(NOLEADER)
    want = canary_run(JSwarm, jset, j_initial_states(jset),
                      invariants=j_invariants_of(jset),
                      constraint=j_constraint_of(jset), hunt=False,
                      pipeline="v2")
    setup = load_config(NOLEADER)
    res = canary_run(SwarmEngine, setup, initial_states(setup),
                     invariants=resolve_invariants(setup),
                     constraint=resolve_constraint(setup), device="cpu")
    got = (res.violation.invariant, res.violation.fingerprint,
           trace_ids(res), res.steps, res.visited, res.traces, res.diameter)
    assert got == (want.violation.invariant, want.violation.fingerprint,
                   [g for g, _ in want.violation_trace], want.steps,
                   want.visited, want.traces, want.diameter)
    assert got == cs.CANARY_PIN
    assert [to_jax(s) for _, s in res.violation_trace] == \
        [s for _, s in want.violation_trace]
    assert_oracle_trace(res.violation_trace, jset.dims)


def test_replay_threads_the_encoded_row():
    """``replay_actions`` reproduces walks taken through ``lane_out``
    state by state; a replay that re-encodes each state before the next
    action (the exhaustive engine's replay) leaves some of them, because
    the recorded Receive / Duplicate / Drop ids are slot indices of the
    walk's own layout."""
    v2 = build_v2(DIMS, "cpu")
    root = init_state(DIMS)
    left = 0
    for seed in range(4):
        gen = torch.Generator().manual_seed(seed)
        st = stack_states([encode_state(root, DIMS)], "cpu")
        walk, acts = [(-1, root)], []
        for _ in range(14):
            en, _ovf = v2.masks(st)
            g = torch.multinomial(en[0].double(), 1, generator=gen)
            _h, _l, st = v2.lane_out(st, v2.parent_hash(st), g)
            acts.append(int(g))
            walk.append((int(g), decode_state(
                StateBatch(*(f[0] for f in st)), DIMS)))
        assert sw.replay_actions(v2, DIMS, root, acts, "cpu") == walk
        naive, state = [(-1, root)], root
        for g in acts:
            step = sw.replay_actions(v2, DIMS, state, [g], "cpu")
            if len(step) < 2:
                break
            state = step[1][1]
            naive.append((g, state))
        left += naive != walk
    assert left > 0


def test_typeok_violating_root_ends_the_run_in_both():
    bad = dataclasses.replace(init_state(DIMS),
                              match_index=((0, -1, 0),) + ((0,) * 3,) * 2)
    want = jax_swarm(depth=4, walks=8, collect=False).run(
        [to_jax(bad)], seed=0, num_steps=8)
    res = port_swarm([bad], depth=4, walks=8, collect=False).run(
        [bad], seed=0, num_steps=8)
    assert res.violation.invariant == want.violation.invariant == "TypeOK"
    assert res.violation.fingerprint == want.violation.fingerprint
    assert res.violation_trace == [(-1, bad)]
    assert res.steps == want.steps == 0
    assert res.stop_reason == want.stop_reason == "violation"


def test_lane_out_fingerprint_equals_build_fingerprint():
    """lane_out's delta hash, on the walks' states and random enabled
    choices, equals the full hash of the successor that the swarm takes
    (as the JAX swarm does)."""
    setup = load_config(os.path.join(REPO, "configs/MCraft_bounded.cfg"))
    dims = setup.dims
    eng = make_swarm(setup, walks=64, max_depth=24, chunk=4, device="cpu")
    roots = initial_states(setup)
    eng._stage_roots(sw.root_rows(dims, sw.check_roots(
        dims, roots, eng._inv_id, eng._inv_fns, "cpu")[2], "cpu"))
    v2, fp = build_v2(dims, "cpu"), build_fingerprint(dims, "cpu")
    s = eng._slices(9, len(roots))[0]
    outs = torch.zeros((1, sw.OUT_VACTS + 24), dtype=torch.int64)
    gen = torch.Generator().manual_seed(2)
    checked = 0
    for k0 in range(0, 24, 4):
        eng._ctl.copy_(torch.tensor([k0, 9, sw.NO_LIMIT]))
        eng._runner(s, outs, None)
        st = unflatten_state(s.carry.rows, dims)
        en, _ovf = v2.masks(st)
        for _ in range(4):
            g = torch.multinomial(en.double(), 1, generator=gen).squeeze(1)
            hi, lo, succ = v2.lane_out(st, v2.parent_hash(st), g)
            want_hi, want_lo = fp(succ)
            assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
            checked += int(en.any(1).sum())
    assert checked >= 64 * 6 * 4


def test_frozen_steps_change_nothing_and_chunks_start_fresh():
    eng = port_swarm([seeded_root()], depth=8, walks=16, chunk=8,
                     collect=False)
    roots = [seeded_root()]
    eng._stage_roots(sw.root_rows(DIMS, sw.check_roots(
        DIMS, roots, eng._inv_id, eng._inv_fns, "cpu")[2], "cpu"))
    s = eng._slices(1, 1)[0]
    outs = torch.zeros((1, sw.OUT_VACTS + 8), dtype=torch.int64)
    for k0 in range(0, 64, 8):                  # until a chunk latches
        eng._ctl.copy_(torch.tensor([k0, 1, sw.NO_LIMIT]))
        eng._runner(s, outs, None)
        if outs[0, sw.OUT_VF]:
            break
    assert outs[0, sw.OUT_VF] == 1 and outs[0, sw.OUT_RESTARTS] > 0
    before = [t.clone() for t in s.carry.tensors()]
    eng._ctl.copy_(torch.tensor([k0 + 8, 1, k0 + 8]))   # all frozen
    eng._runner(s, outs, None)
    for a, b in zip(before, s.carry.tensors()):
        assert torch.equal(a, b)
    assert outs[0, :sw.OUT_VF + 1].tolist() == [0, 0, 0, 0]
    assert outs[0, sw.OUT_VINV:sw.OUT_VACTS].tolist() == \
        [-1, 0, 0, -1, -1, -1, 0, 0]


def test_make_swarm_lanes_a_dispatch():
    """Lanes a dispatch: the flag, else the cfg's BATCH, else the walks up
    to SWARM_BATCH."""
    bounded = load_config(os.path.join(REPO, "configs/MCraft_bounded.cfg"))
    assert "BATCH" not in bounded.backend
    assert make_swarm(bounded, walks=4096, device="cpu").batch == 4096
    assert make_swarm(bounded, walks=SWARM_BATCH + 1,
                      device="cpu").batch == SWARM_BATCH
    assert make_swarm(bounded, walks=4096, batch=1000,
                      device="cpu").batch == 1000
    noleader = load_config(NOLEADER)                  # BATCH = 256
    assert make_swarm(noleader, walks=1024, device="cpu").batch == 256
    assert make_swarm(noleader, walks=100, device="cpu").batch == 100


def test_unported_options_and_the_card_raise(monkeypatch, jax_determinism):
    # The hunt is ported (obs/hunt.py), and so is the v1 pipeline: its
    # walks are the JAX determinism run's, multiset for multiset.
    port_swarm([init_state(DIMS)], depth=4, hunt=True)
    want, want_fps = jax_determinism
    res = port_swarm([init_state(DIMS)], depth=12, pipeline="v1").run(
        [init_state(DIMS)], seed=5, num_steps=24)
    assert res.pipeline == "v1"
    assert counts(res) == counts(want)
    assert np.array_equal(sorted_fps(res), want_fps)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    setup = load_config(NOLEADER)
    with pytest.raises(RuntimeError, match="cuda"):
        make_swarm(setup)                   # the default is the card
