"""The port's split tail vs the JAX package's.

Kernel level: ``enqueue_plain`` (the plain version of the CUDA enqueue
kernel) and the two PyTorch lowerings against the JAX Pallas enqueue in
interpret mode and the JAX scatter lowering, on the live rows
``[0, next_count + sum(enq))``.  Engine level: the port's split tail
against the JAX engine on its Pallas insert + Pallas enqueue, and against
the port's own fused tail, queue rows byte for byte at every level.
Every comparison is exact (bytes and integers: tolerance 0).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tla_tpu.engine.bfs import BFSEngine as JEngine
from raft_tla_tpu.engine.bfs import EngineConfig as JConfig
from raft_tla_tpu.models.invariants import build_constraint as j_constraint
from raft_tla_tpu.models.pystate import init_state as j_init_state
from raft_tla_tpu.ops import compact as j_compact
from raft_tla_tpu.ops import enqueue_pallas
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch.engine import checkpoint as ckpt
from raft_tla_tpu_torch.engine.bfs import EngineConfig
from raft_tla_tpu_torch.engine.check import make_engine, run_check
from raft_tla_tpu_torch.engine.chunk import build_chunk_body
from raft_tla_tpu_torch.ops import enqueue as enq_mod
from raft_tla_tpu_torch.ops import enqueue_cuda, pipeline_v3, pipeline_v4
from raft_tla_tpu_torch.ops.compact import inv_positions
from raft_tla_tpu_torch.utils import build
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")

K, Q, NEXT = 256, 512, 37        # lanes, live queue rows, rows already there
TILE = 64                        # lanes of a tile of the CUDA enqueue
SEG = enqueue_pallas.SEG


def _mask(case: str, rng) -> np.ndarray:
    m = np.zeros(K, bool)
    if case == "full":
        m[:] = True
    elif case == "short_run":                 # one run shorter than SEG
        m[40:40 + SEG - 3] = True
    elif case == "long_run":                  # one run longer than SEG
        m[17:17 + 5 * SEG + 3] = True
    elif case == "many_short_runs":
        for start in range(3, K - 4, 7):
            m[start:start + 1 + start % 3] = True
    elif case == "random":
        m = rng.rand(K) < 0.15
    elif case == "last_lanes":                # a run ending on the last lane
        m[K - SEG - 2:] = True
    elif case == "cross_tile_runs":           # a run across each 64-lane
        for edge in range(TILE, K, TILE):     # tile edge, one across two
            m[edge - 1 - edge % 5:edge + 3 + edge // TILE] = True
        m[TILE - 20:3 * TILE + 7] = True
    elif case == "tile_last_lanes":           # one flag, each tile's last
        m[TILE - 1::TILE] = True
    elif case == "ragged_k":                  # K no multiple of a tile
        m = rng.rand(K - 56) < 0.4
        m[TILE - 3:TILE + 2] = True
        m[-5:] = True
    else:
        assert case == "empty"
    return m


MASKS = ("empty", "full", "short_run", "long_run", "many_short_runs",
         "random", "last_lanes", "cross_tile_runs", "tile_last_lanes",
         "ragged_k")


@pytest.mark.parametrize("sw", [473, 403, 679, 951])
@pytest.mark.parametrize("case", MASKS)
def test_enqueue_lowerings_equal_jax_on_live_rows(case, sw):
    """Row widths of MCraft_bounded (473), MCraft_noleader (403),
    raft5_bounded (679) and TPUraft (951)."""
    rng = np.random.RandomState(1000 * MASKS.index(case) + sw)
    enq = _mask(case, rng)
    k = enq.shape[0]
    krows = rng.randint(0, 256, (k, sw)).astype(np.uint8)
    q0 = rng.randint(0, 256, (Q + k, sw)).astype(np.uint8)   # sentinel rows
    live = NEXT + int(enq.sum())

    jq = np.asarray(enqueue_pallas.enqueue(
        jnp.asarray(q0), jnp.int32(NEXT), jnp.asarray(krows),
        jnp.asarray(enq), interpret=True))
    epos = NEXT + np.cumsum(enq) - 1
    epos = np.where(enq, epos, Q + np.arange(k))
    jscatter = np.asarray(jnp.asarray(q0).at[jnp.asarray(epos)].set(
        jnp.asarray(krows)))
    assert np.array_equal(jq[:live], jscatter[:live])
    assert np.array_equal(jq[:NEXT], q0[:NEXT])

    t_rows, t_enq = torch.as_tensor(krows), torch.as_tensor(enq)
    lowerings = {
        "plain": lambda q: enq_mod.enqueue_plain(q, NEXT, t_rows, t_enq),
        "wrapper": lambda q: enqueue_cuda.enqueue(q, NEXT, t_rows, t_enq),
        "scatter": lambda q: enq_mod.enqueue_scatter(q, NEXT, t_rows, t_enq,
                                                     Q),
        "window": lambda q: enq_mod.enqueue_window(q, NEXT, t_rows, t_enq),
    }
    for name, fn in lowerings.items():
        q = torch.as_tensor(q0.copy())
        count = fn(q)
        assert count.dtype == torch.int32 and count.dim() == 0, name
        assert int(count) == live, name
        assert np.array_equal(q.numpy()[:live], jq[:live]), name
        if name == "scatter":                 # trash rows too, all of them
            assert np.array_equal(q.numpy(), jscatter)
        if name in ("plain", "wrapper"):      # nothing else is touched
            assert np.array_equal(q.numpy()[live:], q0[live:]), name


def test_inv_positions_equals_jax():
    rng = np.random.RandomState(5)
    for density, out_len in ((0.0, 64), (0.2, 64), (1.0, 64), (0.5, 200)):
        m = rng.rand(64) < density
        want = np.asarray(j_compact.inv_positions(jnp.asarray(m), out_len))
        got = inv_positions(torch.as_tensor(m), out_len).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n,tiles", [(0, 1), (1, 1), (64, 1), (65, 2),
                                     (1000, 16), (32768, 512)])
def test_enqueue_count_scratch(n, tiles):
    """One int32 a 64-lane tile (at least one: the n = 0 launch still
    writes the count), sized without loading the library."""
    scratch = enqueue_cuda.count_scratch(n, TILE, "cpu")
    assert scratch.dtype == torch.int32 and scratch.shape == (tiles,)
    assert "enqueue" not in build._libs


def test_wrapper_checks_bounds_and_counts_no_launch_on_cpu():
    before = enqueue_cuda.launches
    q = torch.zeros((K + 10, 5), dtype=torch.uint8)
    rows = torch.ones((K, 5), dtype=torch.uint8)
    enq = torch.ones(K, dtype=torch.bool)
    with pytest.raises(ValueError, match="overrun"):
        enqueue_cuda.enqueue(q, 11, rows, enq)
    with pytest.raises(ValueError, match="overrun"):
        enqueue_cuda.enqueue(q, -1, rows, enq)
    with pytest.raises(ValueError, match="trash rows"):
        enq_mod.enqueue_scatter(q, 0, rows, enq, Q=11)
    assert int(enqueue_cuda.enqueue(q, 10, rows, enq)) == K + 10
    assert enqueue_cuda.launches == before     # the kernel only on the card


@pytest.mark.parametrize("method,insert,enqueue", [
    ("fused", "fused-plain", "fused-plain"), ("kernel", "plain", "plain"),
    ("scatter", "plain", "scatter"), ("window", "plain", "window")])
def test_plan_records_the_tail(method, insert, enqueue):
    for plan in (pipeline_v3, pipeline_v4):
        stages = plan.resolve_plan("cpu", method)
        assert (stages["insert"], stages["enqueue"]) == (insert, enqueue)
    assert pipeline_v3.resolve_plan("cuda", "kernel")["enqueue"] == "cuda"
    assert pipeline_v4.resolve_plan("cuda", "kernel")["insert"] == "cuda"


def test_unknown_enqueue_method_raises():
    setup = load_config(BOUNDED)
    with pytest.raises(ValueError, match="enqueue_method"):
        make_engine(setup, EngineConfig(enqueue_method="pallas"),
                    device="cpu")
    with pytest.raises(ValueError, match="enqueue_method"):
        build_chunk_body(dims=setup.dims, v2=None, inv_fns=None,
                         constraint=None, B=8, K=256, record_trace=False,
                         device="cpu", enqueue_method="dma")


# ---------------------------------------------------------------------------
# Engine level


def port_config(**kw):
    base = dict(batch=64, queue_capacity=1 << 13, seen_capacity=1 << 14,
                check_deadlock=False, max_diameter=4)
    base.update(kw)
    return EngineConfig(**base)


@pytest.fixture(scope="module")
def jax_split_l4():
    """The JAX engine with its insert and its enqueue as separate Pallas
    kernels (interpret mode), as tests/test_actions2.py runs them."""
    setup = j_load_config(BOUNDED)
    dims = setup.dims
    eng = JEngine(dims, constraint=j_constraint(dims, setup.bounds),
                  config=JConfig(batch=64, queue_capacity=1 << 13,
                                 seen_capacity=1 << 14, record_trace=True,
                                 check_deadlock=False, max_diameter=4,
                                 enqueue_method="pallas",
                                 insert_method="pallas",
                                 statespace_report=False))
    res = eng.run([j_init_state(dims)])
    tf, tp, ta = eng.trace.export()
    return res, set(zip(tf.tolist(), tp.tolist(), ta.tolist()))


@pytest.mark.parametrize("pipeline", ["v3", "v4"])
def test_split_tail_l4_equals_jax_split_tail(jax_split_l4, pipeline):
    jres, jlinks = jax_split_l4
    res = run_check(BOUNDED, port_config(pipeline=pipeline,
                                         enqueue_method="kernel"),
                    device="cpu")
    assert res.stop_reason == jres.stop_reason == "diameter_budget"
    assert res.violation is None and jres.violation is None
    assert res.distinct == jres.distinct == 527
    assert res.generated == jres.generated
    assert res.levels == jres.levels
    assert res.action_counts == jres.action_counts
    tf, tp, ta = res.engine.trace.export()
    assert set(zip(tf.tolist(), tp.tolist(), ta.tolist())) == jlinks


def _levels_of(tmp_path, name, **kw):
    """A run to L5 with a snapshot at every level: its result and each
    level's queue rows (the snapshots' frontiers)."""
    ckdir = str(tmp_path / name)
    res = run_check(BOUNDED, port_config(max_diameter=5, batch=128,
                                         checkpoint_dir=ckdir, **kw),
                    device="cpu")
    rows = [ckpt.load(os.path.join(ckdir, f"level_{d:05d}.npz")).frontier
            for d in range(6)]
    return res, rows


@pytest.fixture(scope="module")
def fused_levels(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fused")
    return {p: _levels_of(tmp, p, pipeline=p) for p in ("v3", "v4")}


@pytest.mark.parametrize("method", ["kernel", "scatter", "window"])
@pytest.mark.parametrize("pipeline", ["v3", "v4"])
def test_split_tail_equals_fused_tail_level_by_level(fused_levels, tmp_path,
                                                     pipeline, method):
    fres, frows = fused_levels[pipeline]
    res, rows = _levels_of(tmp_path, method, pipeline=pipeline,
                           enqueue_method=method)
    assert res.distinct == fres.distinct == 2300
    assert (res.generated, res.levels, res.action_counts) == \
        (fres.generated, fres.levels, fres.action_counts)
    for level, (a, b) in enumerate(zip(rows, frows)):
        assert a.shape == b.shape == (fres.levels[level], a.shape[1])
        assert np.array_equal(a, b), f"queue rows differ at level {level}"
    a, b = res.engine.trace.export(), fres.engine.trace.export()
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("method", ["kernel", "scatter"])
def test_split_tail_spills_and_grows_to_the_pinned_l6(method):
    """A tiny queue and seen set: the watermark keeps every batch's rows
    (and the scatter lowering's trash rows) inside the queue."""
    res = run_check(BOUNDED, port_config(batch=32, queue_capacity=1024,
                                         seen_capacity=256, max_diameter=6,
                                         record_trace=False,
                                         enqueue_method=method),
                    device="cpu")
    assert len(res.growth_stalls) >= 2 and res.spills >= 2
    assert (res.distinct, res.generated) == (9457, 24429)
