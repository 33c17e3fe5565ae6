"""The port's simulator (``raft_tla_tpu_torch/engine/simulate.py``) under
the contract ``tests/test_simulate.py`` pins for the JAX one (steps,
restarts, a replayed violation whose every step the oracle allows, the
root check), a seeded run that repeats itself exactly, and the CLI:
``check --mode swarm``, the ``MODE`` directive, ``simulate``."""

import dataclasses
import os

import pytest
import torch

from raft_tla_tpu.models import oracle as orc
from raft_tla_tpu.models.dims import RaftDims as JDims
from raft_tla_tpu.models.pystate import PyState as JPyState
from raft_tla_tpu_torch import cli
from raft_tla_tpu_torch.engine.check import make_simulator
from raft_tla_tpu_torch.engine.simulate import Simulator, graph_steps
from raft_tla_tpu_torch.models.dims import LEADER, RaftDims
from raft_tla_tpu_torch.models.invariants import (Bounds, build_constraint,
                                                  build_type_ok)
from raft_tla_tpu_torch.models.pystate import init_state
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOLEADER = os.path.join(REPO, "configs/MCraft_noleader.cfg")
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")

DIMS = RaftDims(n_servers=3, n_values=2, max_log=4, n_msg_slots=24)
JD = JDims(n_servers=3, n_values=2, max_log=4, n_msg_slots=24)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_root():
    """A candidate one vote short of quorum (tests/test_simulate.py's)."""
    return dataclasses.replace(
        init_state(DIMS), role=(1, 0, 0), current_term=(2, 2, 2),
        voted_for=(1, 1, 1), votes_responded=(0b001, 0, 0),
        votes_granted=(0b001, 0, 0),
        messages=frozenset({((1, 1, 0, 2, 1, ()), 1)}))


def near_election_sim():
    return Simulator(
        DIMS, invariants={"NoLeader": lambda st: (st.role != LEADER).all(1)},
        constraint=build_constraint(
            DIMS, Bounds(max_term=3, max_log_len=1, max_msg_count=1)),
        batch=32, depth=16, chunk=64, device="cpu")


def to_jax(s):
    return JPyState(*dataclasses.astuple(s))


def test_walkers_advance_and_restart():
    sim = Simulator(DIMS, constraint=build_constraint(
        DIMS, Bounds(max_term=2, max_log_len=1, max_msg_count=1)),
        batch=16, depth=8, chunk=32, device="cpu")
    res = sim.run([init_state(DIMS)], num_steps=16 * 32, seed=1)
    assert res.steps == 16 * 32
    assert res.traces > 16          # the depth-8 bound forces restarts
    assert res.violation_invariant is None


@pytest.fixture(scope="module")
def violation_run():
    return near_election_sim().run([seeded_root()], num_steps=32 * 64 * 8,
                                   seed=0)


def test_simulation_finds_violation_and_replays(violation_run):
    res = violation_run
    assert res.violation_invariant == "NoLeader"
    assert LEADER in res.violation_state.role
    trace = res.violation_trace
    assert trace[0] == (-1, seeded_root())
    assert trace[-1][1] == res.violation_state
    for (_gp, prev), (_g, nxt) in zip(trace, trace[1:]):
        assert to_jax(nxt) in orc.successor_set(to_jax(prev), JD)


def test_seeded_run_repeats_itself(violation_run):
    sim = near_election_sim()
    for _ in range(2):               # a fresh simulator, then the same again
        res = sim.run([seeded_root()], num_steps=32 * 64 * 8, seed=0)
        assert (res.steps, res.traces, res.violation_trace) == \
            (violation_run.steps, violation_run.traces,
             violation_run.violation_trace)
    # Where the walkers stand after a run: equal for equal seeds.
    ends = []
    for seed in (1, 1, 2):
        sim.run([init_state(DIMS)], num_steps=32 * 64, seed=seed)
        ends.append(sim._w["rows"].clone())
    assert torch.equal(ends[0], ends[1])
    assert not torch.equal(ends[0], ends[2])


def test_simulation_checks_root_states():
    """TLC checks invariants on initial states; so does simulation mode."""
    bad_root = dataclasses.replace(
        init_state(DIMS), match_index=((0, -1, 0),) + ((0,) * 3,) * 2)
    sim = Simulator(DIMS, invariants={"TypeOK": build_type_ok(DIMS)},
                    batch=8, depth=4, chunk=8, device="cpu")
    res = sim.run([bad_root], num_steps=64, seed=0)
    assert res.violation_invariant == "TypeOK"
    assert res.violation_state == bad_root
    assert res.violation_trace == [(-1, bad_root)]
    assert res.steps == 0


@pytest.mark.parametrize("chunk,steps", [(128, 32), (64, 32), (100, 25),
                                         (8, 8), (7, 7)])
def test_graph_steps_divide_the_chunk(chunk, steps):
    assert graph_steps(chunk) == steps


def test_cli_swarm_mode_flag_prints_the_canary_trace(capsys):
    rc = cli.main(["check", NOLEADER, "--mode", "swarm", "--device", "cpu",
                   "--walks", "256", "--max-depth", "16", "--seed", "3"])
    out = capsys.readouterr().out
    assert rc == 1
    assert out.startswith("swarm: 256 walks x depth 16 | 4096 steps")
    assert "visited 2802 | traces 1550 | deepest 12 | stop: violation" in out
    assert ("Error: Invariant NoLeaderElected is violated (fingerprint "
            "0xd6467ee051491c1d).") in out
    assert "State 10: <BecomeLeader" in out


def test_cli_mode_directive_runs_the_swarm(tmp_path, capsys):
    cfg = tmp_path / "MCraft_noleader.cfg"
    cfg.write_text(open(NOLEADER).read()
                   + "\n\\* TPU: MODE = swarm\n\\* TPU: WALKS = 64\n")
    rc = cli.main(["check", str(cfg), "--device", "cpu", "--max-depth", "16",
                   "--seed", "3"])
    out = capsys.readouterr().out
    assert rc == 1
    assert out.startswith("swarm: 64 walks x depth 16 |")
    assert "Error: Invariant NoLeaderElected is violated" in out
    assert "State 1: <Initial predicate>" in out
    # The flag outranks the directive.
    rc = cli.main(["check", str(cfg), "--device", "cpu", "--mode",
                   "exhaustive", "--max-diameter", "2"])
    out = capsys.readouterr().out
    assert rc == 0 and "distinct states" in out and "swarm:" not in out
    cfg.write_text(open(NOLEADER).read() + "\n\\* TPU: MODE = hunt\n")
    with pytest.raises(SystemExit):
        cli.main(["check", str(cfg), "--device", "cpu"])


def test_cli_simulate(capsys):
    rc = cli.main(["simulate", BOUNDED, "--device", "cpu", "--batch", "16",
                   "--num-steps", "3000", "--depth", "20", "--seed", "4"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    # Two chunks of 16 walkers x 128 steps reach 3,000 walker-steps.
    assert out[0] == "steps visited      4096"
    assert out[1].startswith("traces ") and int(out[1].split()[1]) > 16
    assert out[3].startswith("states/sec")


def test_simulate_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_simulator(load_config(BOUNDED))
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["simulate", BOUNDED, "--num-steps", "1"])
