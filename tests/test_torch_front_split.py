"""The v4 front's lanes work in two halves (``csrc/chunk_front.cu``): the
keys of every live lane before the seen-set insert, the build of the
successors after it, on the lanes the insert found new.

On the CPU: the plain build (``ops/chunk_front.py build_plain``) on the
lanes of a mask against the whole plain front (``front_plain``), at
MCraft's, TPUraft's and the reconfiguration variant's dims, with the
TypeOK, suite and variant lists, with and without a POR table: rows,
``cons_ok`` and ``inv`` equal on the masked live lanes, nothing written
elsewhere, the lanes counted; and the v4 engine's ``built`` against its
distinct states.

On the card (marker ``cuda``; each test skips without one): the step's
rows, constraint and invariant ids on its new lanes, and its count,
against the standalone front's on the same batch; ``built`` equal to the
distinct states less the roots on whole checks.  This file imports no
JAX: the card's machine has none, so run it there without the suite's
conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_front_split.py
"""

import dataclasses
import os

import pytest
import torch

from raft_tla_tpu_torch.engine.bfs import EngineConfig
from raft_tla_tpu_torch.engine.check import (initial_states, make_engine,
                                             resolve_constraint,
                                             resolve_invariants)
from raft_tla_tpu_torch.models import smoke
from raft_tla_tpu_torch.models.actions2 import build_v2
from raft_tla_tpu_torch.models.schema import (encode_state, flatten_state,
                                              stack_states)
from raft_tla_tpu_torch.ops import chunk_front_cuda
from raft_tla_tpu_torch.ops.chunk_front import LIVE_ONLY, FrontOut
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUITE = ["TypeOK", "MessagesInv", "LeaderVotesQuorum",
         "CandidateTermNotInLog", "ElectionSafety", "LogMatching",
         "VotesGrantedInv", "QuorumLogInv", "MoreUpToDateCorrect",
         "LeaderCompleteness"]
B, K = 16, 1024


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cfg(name):
    return os.path.join(REPO, "configs", f"{name}.cfg")


def make_front(name, names, por, device="cpu", b=B, k=K):
    """A front of the named cfg's dims and constraint with the invariants
    ``names``; with ``por``, a forged table: every DuplicateMessage
    instance certified, priority g."""
    setup = load_config(cfg(name))
    dims = setup.dims
    invs = resolve_invariants(dataclasses.replace(setup, invariants=names))
    kw = {}
    if por:
        G = dims.n_instances
        mask = torch.zeros(G, dtype=torch.bool)
        off = dims.family_offsets[dims.family_names.index(
            "DuplicateMessage")]
        mask[off:off + dims.n_msg_slots] = True
        kw = dict(por_mask=mask, por_priority=torch.arange(
            G, dtype=torch.int32))
    return chunk_front_cuda.Front(
        dims=dims, v2=build_v2(dims, device),
        inv_fns=[invs[n] for n in names],
        constraint=resolve_constraint(setup), B=b, K=k, device=device, **kw)


def window(dims, seed, b=B, device="cpu"):
    """b random parents over the smoke domains, every fifth invalid."""
    states = smoke.random_states(dims, b, seed=seed, max_msgs=2)
    rows = flatten_state(stack_states([encode_state(s, dims)
                                       for s in states], device), dims)
    valid = torch.arange(b, device=device) % 5 != 4
    return rows, valid


def joint_lanes(dims, fo, m):
    """The lanes of ``m`` whose successor row (``fo.krows``) has a server
    whose latest config entry is joint."""
    from raft_tla_tpu_torch.models.reconfig import config_of_py
    from raft_tla_tpu_torch.models.schema import decode_state, unflatten_state
    cols = unflatten_state(fo.krows[m], dims)
    n = 0
    for i in range(int(m.sum())):
        s = decode_state(type(cols)(*(c[i].numpy() for c in cols)), dims)
        n += any(config_of_py(log, dims.n_servers)[0] for log in s.log)
    return n


def masks(total, seed):
    """Lane masks over K: a third of the lanes, every lane (dead ones
    too), none."""
    gen = torch.Generator().manual_seed(seed)
    return {"a third": torch.rand(K, generator=gen) < 0.35,
            "every lane": torch.ones(K, dtype=torch.bool),
            "none": torch.zeros(K, dtype=torch.bool)}


@pytest.mark.parametrize("name,names,por", [
    ("MCraft_bounded", ["TypeOK", "NoLeaderElected"], False),
    ("MCraft_bounded", ["TypeOK", "NoLeaderElected"], True),
    ("MCraft_safety", SUITE, False),
    ("MCraft_safety", SUITE, True),
    ("TPUraft", ["TypeOK"], False),
    ("TPUraft", SUITE, True),
    ("reconfig3", ["TypeOK", "NoLeaderElected"], False),
    ("reconfig3", ["TypeOK"], True),
    ("reconfig3", SUITE, False),
])
def test_build_of_a_mask_equals_the_whole_front(name, names, por):
    front = make_front(name, names, por)
    assert front.suite == (names == SUITE)
    failing = 0
    for seed in (3, 4):
        rows, valid = window(front.dims, seed)
        want = front.plain(rows, valid)
        total = int(want.total)
        live = torch.arange(K) < total
        for what, mask in masks(total, seed).items():
            out, edits = front.keys(rows, valid)
            assert edits is None             # the CPU rebuilds from parents
            for f in FrontOut._fields:
                if f in ("krows", "cons_ok", "inv"):
                    continue
                g, w = getattr(out, f), getattr(want, f)
                if f in LIVE_ONLY:
                    g, w = g[:total], w[:total]
                assert torch.equal(g, w), (what, f)
            built = torch.zeros(2, dtype=torch.int32)
            got = front.build(rows, out, edits, mask, None, built)
            m = mask & live
            assert got is out.cons_ok and int(built[0]) == int(m.sum())
            assert int(built[1]) == (joint_lanes(front.dims, want, m)
                                     if front.reconfig else 0)
            assert torch.equal(out.krows[m], want.krows[m]), what
            assert torch.equal(out.cons_ok[m], want.cons_ok[m]), what
            assert torch.equal(out.inv[m], want.inv[m]), what
            # No other lane is written.
            assert not out.krows[~m].any() and not out.cons_ok[~m].any()
            assert (out.inv[~m] == -1).all()
            failing += int((want.inv[:total] >= 0).sum())
        assert total > 0
    # The lists with more than TypeOK fail somewhere on random parents,
    # so inv is exercised there.
    assert failing > 0 or names == ["TypeOK"]


def test_the_step_counts_the_lanes_it_builds_on_the_cpu():
    """The v4 step builds the lanes the insert found new, and counts
    them: distinct less the root, on both tails; v3 builds before the
    insert and counts none."""
    setup = load_config(cfg("MCraft_safety"))
    got = {}
    for pipeline, method in (("v4", "fused"), ("v4", "kernel"),
                             ("v3", "fused")):
        eng = make_engine(setup, EngineConfig(
            batch=256, queue_capacity=1 << 14, seen_capacity=1 << 16,
            max_diameter=5, pipeline=pipeline, enqueue_method=method),
            device="cpu")
        res = eng.run(initial_states(setup))
        got[pipeline, method] = (res.distinct, res.generated, res.built)
        assert eng.metrics.counter_value("engine/built") == res.built
    assert got["v4", "fused"] == got["v4", "kernel"] == (2300, 5616, 2299)
    assert got["v3", "fused"] == (2300, 5616, 0)


# --------------------------------------------------------------------------
# On the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the lanes launches are CUDA "
                    "kernels, built with nvcc there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,names,depth", [
    ("MCraft_safety", SUITE, 7), ("MCraft_bounded", ["TypeOK"], 7),
    ("TPUraft", ["TypeOK"], 5), ("reconfig3", SUITE, 7)])
def test_the_steps_build_equals_the_front_on_its_new_lanes(card, name,
                                                           names, depth):
    """Each batch of a v4 check, its steps dispatched one by one: the
    step's rows, constraint and invariant ids on its new lanes equal the
    standalone front's (keys and build over every live lane) on the same
    parents, and the step's counter grows by its new lanes."""
    setup = dataclasses.replace(load_config(cfg(name)), invariants=names)
    eng = make_engine(setup, EngineConfig(
        batch=2048, queue_capacity=1 << 18, seen_capacity=1 << 22,
        max_diameter=depth, pipeline="v4", record_trace=False),
        device=card)
    step = eng._step
    body, batches = step.body, []
    front = body.stages.front
    eng._runner = lambda qcur, qnext, seen, res: (
        lambda: step(qcur, seen, qnext, eng._tbuf, eng._cs))

    def hook(rows, valid, seen, qnext, nc, mc=None, finish=None,
             built=None):
        before = int(built[0])

        def grab(valid, fo, new, fail, count):
            finish(valid, fo, new, fail, count)
            if bool(valid.any()):
                batches.append((rows.clone(), valid.clone(), FrontOut(
                    *(t.clone() for t in fo)), new.clone(),
                    int(built[0]) - before))
        return body(rows, valid, seen, qnext, nc, mc, grab, built)

    step.body = hook
    res = eng.run(initial_states(setup))
    step.body = body
    assert batches and res.built == res.distinct - 1
    assert sum(b[-1] for b in batches) == res.built
    for rows, valid, fo, new, built in batches:
        want = front(rows, valid)
        total = int(want.total)
        assert int(fo.total) == total and built == int(new.sum())
        assert not bool(new[total:].any())
        for f in ("kh", "kl", "parent_hi", "parent_lo"):
            assert torch.equal(getattr(fo, f)[:total],
                               getattr(want, f)[:total]), f
        assert torch.equal(fo.krows[new], want.krows[new])
        assert torch.equal(fo.cons_ok[new], want.cons_ok[new])
        assert torch.equal(fo.inv[new], want.inv[new])


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["fused", "kernel"])
def test_built_is_distinct_less_the_root_on_an_l8_check(card, method):
    setup = load_config(cfg("MCraft_bounded"))
    eng = make_engine(setup, EngineConfig(
        batch=2048, queue_capacity=1 << 21, seen_capacity=1 << 25,
        max_diameter=8, pipeline="v4", enqueue_method=method,
        record_trace=False), device=card)
    for _ in range(2):                      # a warm engine's second run
        res = eng.run(initial_states(setup))
        assert (res.distinct, res.built) == (139327, 139326)
    eng.release()
