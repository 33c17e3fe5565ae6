"""The port's v4 plan (one front call + the fused tail) vs the JAX v4 engine.

The JAX side runs ``pipeline="v4"`` with its Pallas front and fused tail
in interpret mode; the port runs ``pipeline="v4"`` on the CPU, where the
front and the tail take their plain versions.  Counts, levels,
per-family counts and the recorded trace links must be equal.  Also the
plan's selection: the cfg's ``PIPELINE`` directive, the CLI's
``--pipeline``, the JAX package's plan names and v1, the classical plan,
against the same JAX run.
"""

import os

import pytest
import torch

from raft_tla_tpu.engine.bfs import BFSEngine as JEngine
from raft_tla_tpu.engine.bfs import EngineConfig as JConfig
from raft_tla_tpu.models.invariants import build_constraint as j_constraint
from raft_tla_tpu.models.pystate import init_state as j_init_state
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch import cli
from raft_tla_tpu_torch.engine.bfs import EngineConfig
from raft_tla_tpu_torch.engine.check import (engine_config_from_backend,
                                             make_engine, run_check)
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")


def port_config(**kw):
    base = dict(batch=128, queue_capacity=1 << 14, seen_capacity=1 << 16,
                check_deadlock=False, pipeline="v4")
    base.update(kw)
    return EngineConfig(**base)


@pytest.fixture(scope="module")
def jax_v4_l5():
    setup = j_load_config(BOUNDED)
    dims = setup.dims
    eng = JEngine(dims, constraint=j_constraint(dims, setup.bounds),
                  config=JConfig(batch=128, queue_capacity=1 << 14,
                                 seen_capacity=1 << 16, record_trace=True,
                                 check_deadlock=False, max_diameter=5,
                                 pipeline="v4", statespace_report=False))
    res = eng.run([j_init_state(dims)])
    assert res.fused_stages["masks"] == "fused"
    tf, tp, ta = eng.trace.export()
    return res, set(zip(tf.tolist(), tp.tolist(), ta.tolist()))


def test_v4_l5_equals_jax_v4_with_trace_links(jax_v4_l5):
    jres, jlinks = jax_v4_l5
    res = run_check(BOUNDED, port_config(max_diameter=5), device="cpu")
    assert res.pipeline == "v4"
    assert set(res.fused_stages.values()) == {"fused-plain"}
    assert res.distinct == jres.distinct == 2300
    assert res.generated == jres.generated
    assert res.levels == jres.levels
    assert res.action_counts == jres.action_counts
    tf, tp, ta = res.engine.trace.export()
    assert set(zip(tf.tolist(), tp.tolist(), ta.tolist())) == jlinks


@pytest.mark.parametrize("pipeline", ["v1"])
def test_plans_the_port_lacks_raise(pipeline, jax_v4_l5):
    """The classical v1 plan runs: its counts, levels, per-family counts
    and trace links equal the JAX engine's at the same size (the JAX v4
    run; the JAX package holds its plans equal)."""
    jres, jlinks = jax_v4_l5
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # the suite runs in several workers
    try:
        res = run_check(BOUNDED, port_config(
            pipeline=pipeline, max_diameter=5, enqueue_method="kernel"),
            device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert res.pipeline == pipeline
    assert (res.distinct, res.generated, res.levels) == \
        (jres.distinct, jres.generated, jres.levels)
    assert res.action_counts == jres.action_counts
    tf, tp, ta = res.engine.trace.export()
    assert set(zip(tf.tolist(), tp.tolist(), ta.tolist())) == jlinks


@pytest.mark.parametrize("pipeline", ["auto", "v2"])
def test_jax_plan_names_run_the_v3_plan(pipeline, capsys):
    """The JAX package's default ("auto") and its delta pipeline ("v2")
    run the port's v3 plan, with v3's counts."""
    want = run_check(BOUNDED, port_config(pipeline="v3", max_diameter=4),
                     device="cpu")
    res = run_check(BOUNDED, port_config(pipeline=pipeline, max_diameter=4),
                    device="cpu")
    assert res.pipeline == "v3"
    assert (res.distinct, res.generated, res.levels, res.action_counts) == \
        (want.distinct, want.generated, want.levels, want.action_counts)
    assert cli.main(["check", BOUNDED, "--pipeline", pipeline, "--device",
                     "cpu", "--max-diameter", "3", "--no-trace",
                     "--progress-interval", "0"]) == 0
    assert "distinct states    113" in capsys.readouterr().out


def test_pipeline_directive_is_read(tmp_path):
    assert engine_config_from_backend(load_config(BOUNDED)).pipeline == "v3"
    cfg = tmp_path / "v4.cfg"
    cfg.write_text(open(BOUNDED).read() + "\n\\* TPU: PIPELINE = v4\n")
    setup = load_config(str(cfg))
    assert engine_config_from_backend(setup).pipeline == "v4"
    assert make_engine(setup, device="cpu").config.pipeline == "v4"


def test_cli_pipeline_v4_prints_the_pinned_l6(capsys):
    rc = cli.main(["check", BOUNDED, "--pipeline", "v4", "--device", "cpu",
                   "--max-diameter", "6", "--no-trace"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "distinct states    9457" in out
    assert "states generated   24429" in out
    assert "pipeline           v4 (" in out
