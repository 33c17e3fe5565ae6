"""The port's CLI and ops against the JAX package's where they had parted:

- ``simulate`` with ``--platform cpu``, ``--max-log``, ``--n-msg-slots``,
  ``--pipeline`` and ``--metrics-out`` through both CLIs on the same cfg:
  equal steps and traces (at depth 1 every walker restarts each step, so
  the count does not depend on the draws, which are each package's own),
  and a metrics file with the same keys and counters (the simulators'
  registries: ``sim_chunk`` / ``sim_fetch``, ``sim/steps``,
  ``sim/traces``);
- ``--platform`` as the JAX spelling of ``--device`` (``cpu``,
  ``gpu``/``cuda``, ``tpu`` refused with the PLATFORM directive's text) on
  ``check``, ``explain``, ``simulate`` and the server; ``check --por``
  certifying in process and printing the run's counts (22 distinct at
  depth 2, the JAX CLI's);
- the swarm's hunt on by default, as the JAX engine's;
- ``ops/fpset.py contains`` against the JAX ``contains`` after the same
  inserts, and ``ops/compact.py build_compactor`` with both JAX methods
  (and ``reduce_p``) against the JAX compactor on the same mask, also as
  the v1 and v3 chunk's compaction stage.
"""

import inspect
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tla_tpu import cli as jcli
from raft_tla_tpu.engine.swarm import SwarmEngine as JSwarm
from raft_tla_tpu.ops import compact as jcompact
from raft_tla_tpu.ops import fpset as jfpset
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch import cli, server
from raft_tla_tpu_torch.engine.bfs import BFSEngine, EngineConfig
from raft_tla_tpu_torch.engine.check import (initial_states, make_simulator,
                                             make_swarm, platform_device)
from raft_tla_tpu_torch.engine.swarm import SwarmEngine
from raft_tla_tpu_torch.ops import compact, fpset
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")
NOLEADER = os.path.join(REPO, "configs/MCraft_noleader.cfg")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIM_ARGS = ["--platform", "cpu", "--batch", "8", "--num-steps", "2048",
            "--depth", "1", "--max-log", "4", "--n-msg-slots", "20",
            "--seed", "3"]


def metrics_shape(path):
    with open(path) as f:
        m = json.load(f)
    return ({k: sorted(v) for k, v in m.items()}, m["counters"],
            m["gauges"], {k: v["count"] for k, v in m["histograms"].items()})


def test_simulate_overrides_and_metrics_equal_jax(tmp_path, capsys):
    pipeline = "v1"
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    assert jcli.main(["simulate", BOUNDED, *SIM_ARGS, "--pipeline",
                      pipeline, "--metrics-out", jpath]) == 0
    jout = capsys.readouterr().out
    assert cli.main(["simulate", BOUNDED, *SIM_ARGS, "--pipeline",
                     pipeline, "--metrics-out", tpath]) == 0
    out = capsys.readouterr().out
    for key in ("steps visited", "traces"):
        want = next(ln for ln in jout.splitlines() if ln.startswith(key))
        assert want in out.splitlines()
    # Two chunks of 8 walkers x 128 steps, every walker restarting at
    # each step: 8 + 2048 traces.
    assert "traces             2056" in out.splitlines()
    assert metrics_shape(tpath) == metrics_shape(jpath)
    sim = make_simulator(load_config(BOUNDED, max_log=4, n_msg_slots=20),
                         batch=8, device="cpu", pipeline=pipeline)
    assert sim.dims.max_log == 4 and sim.dims.n_msg_slots == 20
    assert sim.pipeline_name == "v1"


def test_platform_and_por(tmp_path, capsys):
    assert platform_device("cpu") == "cpu"
    assert platform_device("GPU") == platform_device("cuda") == "cuda"
    with pytest.raises(ValueError, match="tpu is the JAX package's"):
        platform_device("tpu")
    for cmd in (["check", BOUNDED, "--max-diameter", "2"],
                ["explain", NOLEADER, "--max-diameter", "2"],
                ["simulate", BOUNDED, "--num-steps", "8"]):
        with pytest.raises(SystemExit) as e:
            cli.main(cmd + ["--platform", "tpu"])
        assert e.value.code == 2
        assert "tpu is the JAX package's" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["check", BOUNDED, "--platform", "cpu", "--device",
                  "cuda"])
    assert "disagree" in capsys.readouterr().err
    assert cli.main(["check", BOUNDED, "--platform", "cpu",
                     "--max-diameter", "3", "--no-report"]) == 0
    out = capsys.readouterr().out
    assert "distinct states    113" in out and "device             cpu" in out
    assert cli.main(["check", BOUNDED, "--platform", "cpu", "--por",
                     "--max-diameter", "2", "--no-report"]) == 0
    cap = capsys.readouterr()
    assert "distinct states    22\n" in cap.out
    assert "unrecognized arguments" not in cap.err
    with pytest.raises(SystemExit) as e:
        server.main(["--platform", "tpu"])
    assert e.value.code == 2
    assert "tpu is the JAX package's" in capsys.readouterr().err


def test_hunt_is_on_by_default_as_in_jax():
    jdef = inspect.signature(JSwarm).parameters["hunt"].default
    assert inspect.signature(SwarmEngine).parameters["hunt"].default is \
        jdef is True
    jset, setup = j_load_config(NOLEADER), load_config(NOLEADER)
    assert JSwarm(jset.dims, walks=8, max_depth=4).hunt is True
    eng = make_swarm(setup, walks=8, max_depth=4, chunk=4, device="cpu")
    assert eng.hunt is True
    res = eng.run(initial_states(setup), seed=1, num_steps=8)
    assert res.report["hunt"]["observations"] > 0


def test_contains_equals_jax_after_the_same_inserts():
    rng = np.random.default_rng(16)
    hi = rng.integers(0, 1 << 32, 400, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, 400, dtype=np.uint64).astype(np.uint32)
    ins = np.arange(400) % 3 != 0                 # two thirds inserted
    s = jfpset.empty(1 << 10)
    s, _new, fail = jfpset.insert(s, jnp.asarray(hi), jnp.asarray(lo),
                                  jnp.asarray(ins))
    assert not bool(fail)
    q_hi = np.concatenate([hi, np.full(1, 0xFFFFFFFF, np.uint32)])
    q_lo = np.concatenate([lo, np.full(1, 0xFFFFFFFF, np.uint32)])
    want = np.asarray(jfpset.contains(s, jnp.asarray(q_hi),
                                      jnp.asarray(q_lo)))
    t = fpset.from_host_keys(hi[ins], lo[ins], 1 << 10, "cpu")
    keys = fpset.pack(torch.as_tensor(q_hi.astype(np.int64)),
                      torch.as_tensor(q_lo.astype(np.int64)))
    got = fpset.contains(t, keys).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got[:400], ins) and not got[400]


@pytest.mark.parametrize("method", ["scatter", "searchsorted"])
def test_build_compactor_methods_equal_jax(method):
    B, G, K = 16, 24, 128
    rng = np.random.default_rng(7)
    en = rng.random((B, G)) < 0.35
    en[3] = True                                 # a fan-out burst
    half = lambda p: p // 2                      # noqa: E731
    for reduce_p in (None, half):
        want = jcompact.build_compactor(B, G, K, reduce_p=reduce_p,
                                        method=method)(jnp.asarray(en))
        got = compact.build_compactor(
            B, G, K, method=method, device="cpu",
            reduce_p=reduce_p)(torch.as_tensor(en))
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w))
    with pytest.raises(ValueError, match="unknown compactor method"):
        jcompact.build_compactor(B, G, K, method="bogus")
    with pytest.raises(ValueError, match="unknown compactor method"):
        compact.build_compactor(B, G, K, method="bogus", device="cpu")
    # The chunk's compaction stage is this compactor: the same outputs
    # on a v1 and a v3 engine's grid.
    dims = load_config(BOUNDED).dims
    for pipeline in ("v1", "v3"):
        eng = BFSEngine(dims, config=EngineConfig(
            batch=16, queue_capacity=1 << 10, seen_capacity=1 << 12,
            pipeline=pipeline), device="cpu")
        B, G, K = eng._B, eng._G, eng._K
        en = rng.random((B, G)) < 0.1
        want = jcompact.build_compactor(B, G, K, method=method)(
            jnp.asarray(en))
        got = eng._step.body.stages.compact(torch.as_tensor(en))
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w))
