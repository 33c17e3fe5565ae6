"""The port's spill pool and capacity rules against the JAX package's.

``SpillPool`` (RAM- and disk-backed) is held against the JAX
``engine/spillpool.py`` on the same appends and pops; a tiny-queue run
that spills to files gives the pinned MCraft_bounded L6 counts; the
capacities sized from device memory equal the JAX formula.
"""

import os

import jax
import numpy as np
import pytest
import torch

from raft_tla_tpu.engine import bfs as jbfs
from raft_tla_tpu.engine.spillpool import SpillPool as JSpillPool
from raft_tla_tpu_torch import cli
from raft_tla_tpu_torch.engine.bfs import (EngineConfig, auto_capacities,
                                           device_memory)
from raft_tla_tpu_torch.engine.check import make_engine, run_check
from raft_tla_tpu_torch.engine.spillpool import SpillPool
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")
L6 = (9457, 24429, [1, 3, 18, 79, 318, 1218, 4433])     # PERF.md §4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread for these runs of many small operations: the
    suite runs in several worker processes at once, and a thread a core
    in each oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def drive(pool, rng):
    """Appends and pops of segments of 473-byte rows; what each step
    returns or reports."""
    out = []
    for step in range(12):
        if step % 3 == 2:
            seg = pool.pop(0)
            out.append(("pop", np.array(seg)))
        else:
            rows = rng.randint(0, 256, (rng.randint(0, 40), 473),
                               dtype=np.uint8)
            pool.append(rows, copy=True)
            rows[:] = 0           # the pool keeps its own copy
        out.append(("state", len(pool), bool(pool), pool.total_rows()))
        out.append(("segments", [np.array(s) for s in pool.segments()]))
    pool.clear()
    out.append(("cleared", len(pool), bool(pool), pool.total_rows()))
    return out


def same(a, b):
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("disk", [False, True])
def test_spill_pool_equals_jax(tmp_path, disk):
    port_dir = str(tmp_path / "port") if disk else None
    jax_dir = str(tmp_path / "jax") if disk else None
    got = drive(SpillPool(port_dir), np.random.RandomState(3))
    want = drive(JSpillPool(jax_dir), np.random.RandomState(3))
    assert same(got, want)
    if disk:
        assert os.listdir(port_dir) == []     # popped and cleared files go


def test_disk_pool_iterates_for_checkpoints(tmp_path):
    pool = SpillPool(str(tmp_path))
    a = np.arange(20, dtype=np.uint8).reshape(4, 5)
    pool.append(a)
    pool.append(a[:2] + 1)
    assert [s.shape for s in pool.segments()] == [(4, 5), (2, 5)]
    assert np.array_equal(np.concatenate([a[:1], *pool.segments()])[1:5],
                          a)
    assert len(os.listdir(tmp_path)) == 2
    del pool
    assert os.listdir(tmp_path) == []       # a dropped pool leaves no file


@pytest.mark.parametrize("pipeline", ["v3", "v4"])
def test_tiny_queue_spills_to_disk_to_the_pinned_l6(tmp_path, pipeline):
    spill = tmp_path / "spill"
    res = run_check(BOUNDED, EngineConfig(
        batch=32, queue_capacity=1024, seen_capacity=1 << 14,
        check_deadlock=False, max_diameter=6, spill_dir=str(spill),
        pipeline=pipeline, sync_every=8), device="cpu")
    assert (res.distinct, res.generated, res.levels) == L6
    assert res.spills >= 2
    assert os.listdir(spill) == []


@pytest.mark.parametrize("gib", [16, 80])
@pytest.mark.parametrize("sw,record", [(473, False), (951, True)])
def test_auto_capacities_equal_jax(monkeypatch, gib, sw, record):
    limit = gib << 30

    class Card:
        platform = "gpu"

        def memory_stats(self):
            return {"bytes_limit": limit}

    monkeypatch.setattr(jax, "devices", lambda *a: [Card()])
    want = jbfs._auto_capacities(sw, 2048, record)
    assert auto_capacities(sw, 2048, record, limit) == want


def test_auto_capacities_on_the_cpu():
    """No card: the JAX package's non-TPU defaults, and the engine takes
    them when a capacity is None."""
    assert device_memory("cpu") is None
    assert auto_capacities(951, 8192, True, None) == (1 << 20, 1 << 22)
    setup = load_config(BOUNDED)
    eng = make_engine(setup, EngineConfig(batch=64, queue_capacity=None,
                                          seen_capacity=None), device="cpu")
    assert (eng._Q, eng._seen_cap) == (1 << 20, 1 << 22)


def test_cli_flags_reach_the_engine(monkeypatch, tmp_path):
    """The check flags of this slice land in the EngineConfig."""
    seen = {}

    def fake(setup, cfg, device):
        seen["cfg"], seen["device"] = cfg, device
        raise SystemExit(0)

    monkeypatch.setattr(cli, "make_engine", fake)
    with pytest.raises(SystemExit):
        cli.main(["check", BOUNDED, "--device", "cpu", "--batch", "96",
                  "--queue-capacity", "4096", "--seen-capacity", "8192",
                  "--max-seconds", "2.5",
                  "--spill-dir", str(tmp_path), "--no-degrade",
                  "--progress-interval", "7"])
    cfg = seen["cfg"]
    assert (cfg.batch, cfg.queue_capacity, cfg.seen_capacity,
            cfg.max_seconds, cfg.spill_dir, cfg.degrade_on_oom,
            cfg.progress_interval_seconds) == (
        96, 4096, 8192, 2.5, str(tmp_path), False, 7.0)
    with pytest.raises(SystemExit):
        cli.main(["check", BOUNDED, "--device", "cpu"])
    cfg = seen["cfg"]
    assert (cfg.degrade_on_oom, cfg.progress_interval_seconds,
            cfg.spill_dir, cfg.max_seconds) == (True, 60.0, None, None)


def test_spill_and_progress_directives_are_read(tmp_path):
    cfg = tmp_path / "D.cfg"
    cfg.write_text(open(BOUNDED).read()
                   + f"\n\\* TPU: SPILL_DIR = {tmp_path}/spill\n"
                   + "\\* TPU: PROGRESS_SECONDS = 3\n")
    from raft_tla_tpu_torch.engine.check import engine_config_from_backend
    ec = engine_config_from_backend(load_config(str(cfg)))
    assert (ec.spill_dir, ec.progress_interval_seconds) == (
        f"{tmp_path}/spill", 3.0)
