"""The port's checks with the safety suite and the SmokeInit roots vs the
JAX engine.

``configs/MCraft_safety.cfg`` (TypeOK and the nine safety invariants) to
depth 6 on both plans: the suite holds on every reachable state, so the
counts and levels are MCraft_bounded's, equal to the JAX engine's.  Then
an ``Init <- SmokeInit`` check at the same dims (k = 2, seed
``SMOKE_SEED``: 512 roots sharing one random message bag) with the
invariants of the suite that hold on every root: the first violation
comes at depth 1, so on v4 the front finds it, not the roots' check.
Verdict, invariant, depth, counts, levels, the replayed path and every
trace link equal the JAX engine's, and the pinned values ``SMOKE_PIN``
that chip_smoke.py holds the card to.
"""

import dataclasses
import os

import pytest
import torch

from raft_tla_tpu.engine.bfs import BFSEngine as JEngine
from raft_tla_tpu.engine.bfs import EngineConfig as JConfig
from raft_tla_tpu.engine.check import initial_states as j_initial_states
from raft_tla_tpu.engine.check import resolve_constraint as j_constraint
from raft_tla_tpu.engine.check import resolve_invariants as j_invariants
from raft_tla_tpu.models.pystate import init_state as j_init_state
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch.engine.bfs import EngineConfig
from raft_tla_tpu_torch.engine.check import (initial_states, make_engine,
                                             run_check)
from raft_tla_tpu_torch.models.schema import encode_state, stack_states
from raft_tla_tpu_torch.ops.fingerprint import build_fingerprint
from raft_tla_tpu_torch.utils.cfg import load_config

from tests.test_torch_schema_fp import to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAFETY = os.path.join(REPO, "configs/MCraft_safety.cfg")
L6 = (9457, 24429, [1, 3, 18, 79, 318, 1218, 4433])     # MCraft_bounded's
SMOKE_SEED = 24
SMOKE_INVARIANTS = ["TypeOK", "LeaderVotesQuorum", "CandidateTermNotInLog",
                    "ElectionSafety", "LogMatching", "LeaderCompleteness"]
#: The JAX engine's result (v2 plan) at SMOKE_CONFIG: (invariant, depth,
#: distinct, generated, levels, the violating state's fingerprint).
SMOKE_PIN = ("CandidateTermNotInLog", 1, 2432, 2040, [256],
             0x737AF3816ACBA33D)
#: Its replayed path: (action, state fingerprint), the root first
#: (Timeout(i=1) from a root).
SMOKE_PATH = [(-1, 0xD0333C6874937F7D), (4, 0x737AF3816ACBA33D)]
SMOKE_CONFIG = dict(batch=128, queue_capacity=1 << 14,
                    seen_capacity=1 << 16, record_trace=True,
                    check_deadlock=False, max_diameter=8)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def links(trace):
    tf, tp, ta = trace.export()
    return set(zip(tf.tolist(), tp.tolist(), ta.tolist()))


@pytest.fixture(scope="module")
def jax_l6():
    setup = j_load_config(SAFETY)
    eng = JEngine(setup.dims, invariants=j_invariants(setup),
                  constraint=j_constraint(setup),
                  config=JConfig(batch=64, queue_capacity=1 << 13,
                                 seen_capacity=1 << 14, record_trace=False,
                                 check_deadlock=False, max_diameter=6,
                                 statespace_report=False))
    return eng.run([j_init_state(setup.dims)])


@pytest.mark.parametrize("pipeline", ["v3", "v4"])
def test_safety_cfg_to_l6_equals_jax(jax_l6, pipeline):
    res = run_check(SAFETY, EngineConfig(
        batch=64, queue_capacity=1 << 13, seen_capacity=1 << 14,
        record_trace=False, check_deadlock=False, max_diameter=6,
        pipeline=pipeline), device="cpu")
    assert res.violation is None and res.deadlock is None
    assert res.engine.inv_names == ["TypeOK", "MessagesInv",
                                    "LeaderVotesQuorum",
                                    "CandidateTermNotInLog",
                                    "ElectionSafety", "LogMatching",
                                    "VotesGrantedInv", "QuorumLogInv",
                                    "MoreUpToDateCorrect",
                                    "LeaderCompleteness"]
    assert (res.distinct, res.generated, res.levels) == L6
    assert jax_l6.violation is None
    assert (jax_l6.distinct, jax_l6.generated, jax_l6.levels) == L6
    assert res.action_counts == jax_l6.action_counts


def smoke_setup(load):
    """MCraft_safety.cfg's dims and bounds with ``Init <- SmokeInit``
    (k = 2) and the SMOKE_INVARIANTS."""
    return dataclasses.replace(load(SAFETY), smoke=True, smoke_k=2,
                               invariants=list(SMOKE_INVARIANTS))


@pytest.fixture(scope="module")
def jax_smoke():
    setup = smoke_setup(j_load_config)
    roots = j_initial_states(setup, seed=SMOKE_SEED)
    eng = JEngine(setup.dims, invariants=j_invariants(setup),
                  constraint=j_constraint(setup),
                  config=JConfig(**SMOKE_CONFIG, statespace_report=False))
    res = eng.run(roots)
    return res, eng.replay(res.violation.fingerprint), links(eng.trace)


@pytest.mark.parametrize("pipeline", ["v3", "v4"])
def test_smoke_init_check_equals_jax(jax_smoke, pipeline):
    jres, jpath, jlinks = jax_smoke
    setup = smoke_setup(load_config)
    roots = initial_states(setup, seed=SMOKE_SEED)
    assert len(roots) == 512
    engine = make_engine(setup, EngineConfig(**SMOKE_CONFIG,
                                             pipeline=pipeline),
                         device="cpu")
    res = engine.run(roots)
    path = engine.replay(res.violation.fingerprint)
    got = (res.violation.invariant, len(path) - 1, res.distinct,
           res.generated, res.levels, res.violation.fingerprint)
    want = (jres.violation.invariant, len(jpath) - 1, jres.distinct,
            jres.generated, jres.levels, jres.violation.fingerprint)
    assert got == want == SMOKE_PIN
    assert res.stop_reason == jres.stop_reason == "violation"
    assert res.violation.state == to_port(jres.violation.state)
    assert [(g, s) for g, s in path] == [(g, to_port(s)) for g, s in jpath]
    fingerprint = build_fingerprint(setup.dims, "cpu")
    fps = []
    for g, s in path:
        hi, lo = fingerprint(stack_states([encode_state(s, setup.dims)],
                                          "cpu"))
        fps.append((g, int(hi[0]) << 32 | int(lo[0])))
    assert fps == SMOKE_PATH
    assert path[0][1] in roots and path[0][0] == -1
    assert links(engine.trace) == jlinks


def test_cli_runs_smoke_roots_from_the_seed(tmp_path, capsys):
    """``check --seed`` on a cfg with ``Init <- SmokeInit``: the pinned
    violation, its depth-1 trace printed, exit code 1."""
    from raft_tla_tpu_torch.cli import main
    cfg = tmp_path / "Smoke3.cfg"
    body = open(SAFETY).read().split("INVARIANTS")[0]
    cfg.write_text(body.replace("MaxMsgCount = 1", "MaxMsgCount = 1\n"
                                "    Init <- SmokeInit")
                   + "INVARIANTS " + " ".join(SMOKE_INVARIANTS)
                   + "\nCONSTRAINT BoundedSpace\n")
    assert load_config(str(cfg)).smoke
    rc = main(["check", str(cfg), "--device", "cpu", "--seed",
               str(SMOKE_SEED), "--batch", "128", "--queue-capacity",
               str(1 << 14), "--seen-capacity", str(1 << 16),
               "--pipeline", "v4", "--progress-interval", "0"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "VIOLATION          CandidateTermNotInLog" in out
    assert "distinct states    2432" in out
    assert "State 2: <Timeout(i=1)>" in out
