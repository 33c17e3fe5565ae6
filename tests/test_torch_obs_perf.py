"""The port's chunk profiler, roofline and perf accounting against the JAX
package's ``obs/profile.py``, ``roofline.py`` and ``perf.py``, on the CPU.

- Stage names: v3, v4 and swarm profiles sample the JAX profiler's
  stages (``STAGES_V3``, ``STAGES_V4``, ``STAGES_SWARM``), and v1 its
  classical ``STAGES``, on a profiled v1 check whose counts, levels,
  family counts and trace links equal the JAX v1 engine's.  Counts, levels, family counts and trace records are
  bit-identical with ``--profile-chunks 1`` on and off, and with
  ``--perf`` on (the wrappers' launch counters too).
- The perf block has the JAX block's keys at every level (the launch
  counts are not compared: the JAX counts are pre-fusion jaxpr equations,
  the port's are device operations of a step and kernel launches).
- The roofline's walked floors of the v3 and v4 stages at the main path's
  shapes (MCraft_bounded, B 2048, K 32768), pinned by hand arithmetic
  from the stage tensors' shapes, with their device ops; the kernels'
  hand byte counts that chip_smoke.py prices their bounds with; the peak
  for an unknown card and the CPU.
- The CLI's ``--perf``, ``--profile-chunks`` and ``--xla-profile``: the
  ``chunk_profile``, ``perf`` and ``xla_profile`` events and a Chrome
  trace holding the ``chunk`` steps.
"""

import json
import os

import pytest
import torch

from raft_tla_tpu.engine.bfs import BFSEngine as JEngine
from raft_tla_tpu.engine.bfs import EngineConfig as JConfig
from raft_tla_tpu.models.invariants import build_constraint as j_constraint
from raft_tla_tpu.models.pystate import init_state as j_init_state
from raft_tla_tpu.obs import perf as jperf
from raft_tla_tpu.obs import profile as jprofile
from raft_tla_tpu.obs import roofline as jroofline
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch import cli
from raft_tla_tpu_torch.engine.bfs import EngineConfig
from raft_tla_tpu_torch.engine.check import make_swarm, run_check
from raft_tla_tpu_torch.engine.check import initial_states
from raft_tla_tpu_torch.obs import perf, profile, roofline
from raft_tla_tpu_torch.obs.profile import ChunkProfiler, kernel_modules
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


def config(**kw):
    base = dict(batch=64, queue_capacity=1 << 12, seen_capacity=1 << 14,
                check_deadlock=False, max_diameter=4)
    base.update(kw)
    return EngineConfig(**base)


def summary(res):
    tf, tp, ta = res.engine.trace.export()
    return (res.distinct, res.generated, res.levels, res.action_counts,
            res.batches, res.chunks,
            sorted(zip(tf.tolist(), tp.tolist(), ta.tolist())))


def test_stage_names_are_the_jax_profilers():
    assert profile.STAGES_V3 == jprofile.STAGES_V3
    assert profile.STAGES_V4 == jprofile.STAGES_V4
    assert profile.STAGES_SWARM == jprofile.STAGES_SWARM
    assert profile.STAGES == jprofile.STAGES
    dims = load_config(BOUNDED).dims
    # The v1 stages run: the JAX profiler's classical ones, sampled from
    # a v1 check whose counts equal the unprofiled run's and the JAX v1
    # engine's at the same size.
    prof = ChunkProfiler(dims, batch=8, lanes=256, seen_capacity=1 << 10,
                         pipeline="v1", device="cpu")
    assert prof.stages == jprofile.STAGES
    off = run_check(BOUNDED, config(pipeline="v1", max_diameter=3),
                    device="cpu")
    on = run_check(BOUNDED, config(pipeline="v1", max_diameter=3,
                                   profile_chunks_every=1), device="cpu")
    assert summary(on) == summary(off)
    jsetup = j_load_config(BOUNDED)
    jeng = JEngine(jsetup.dims,
                   constraint=j_constraint(jsetup.dims, jsetup.bounds),
                   config=JConfig(batch=64, queue_capacity=1 << 12,
                                  seen_capacity=1 << 14, record_trace=True,
                                  check_deadlock=False, max_diameter=3,
                                  pipeline="v1", statespace_report=False))
    jres = jeng.run([j_init_state(jsetup.dims)])
    tf, tp, ta = jeng.trace.export()
    want = (jres.distinct, jres.generated, jres.levels, jres.action_counts)
    got = summary(on)
    assert got[:4] == want
    assert got[6] == sorted(zip(tf.tolist(), tp.tolist(), ta.tolist()))
    assert tuple(on.chunk_stages)[:len(jprofile.STAGES)] == jprofile.STAGES


@pytest.mark.parametrize("pipeline", ["v3", "v4"])
def test_profiling_and_perf_change_no_count(pipeline):
    mods = kernel_modules()
    base = [m.launches for m in mods]
    off = run_check(BOUNDED, config(pipeline=pipeline), device="cpu")
    on = run_check(BOUNDED, config(pipeline=pipeline,
                                   profile_chunks_every=1, perf=True),
                   device="cpu")
    assert summary(on) == summary(off)
    assert [m.launches for m in mods] == base
    stages = {"v3": jprofile.STAGES_V3, "v4": jprofile.STAGES_V4}[pipeline]
    assert set(on.chunk_stages) == set(stages) | {"total"}
    assert not off.chunk_stages and not off.perf
    assert on.perf["pipeline"] == pipeline
    assert set(on.perf["roofline"]["stages"]) == set(stages)
    hists = on.engine.metrics.snapshot()["histograms"]
    assert hists["chunk_stage/total"]["count"] == on.chunks
    assert on.phases["profile"] > 0


def test_swarm_profile_and_perf_change_no_walk():
    setup = load_config(NOLEADER)

    def run(**kw):
        e = make_swarm(setup, walks=64, max_depth=12, batch=32,
                       device="cpu", collect_fingerprints=True, **kw)
        r = e.run(initial_states(setup), seed=3, num_steps=48)
        f = r.visited_fingerprints
        return r, (r.steps, r.visited, r.traces, r.diameter, r.stop_reason,
                   sorted(map(tuple, f.tolist())))

    off, a = run()
    on, b = run(profile_chunks_every=1, perf=True)
    assert a == b
    assert set(on.chunk_stages) == set(jprofile.STAGES_SWARM) | {"total"}
    assert set(on.perf["roofline"]["stages"]) == set(jprofile.STAGES_SWARM)


def jax_block(collectives: bool):
    """A JAX perf block from the JAX module itself (no engine build)."""
    traffic = {"front": {"bytes_read": 10, "bytes_written": 5,
                         "bytes_total": 15, "launches": 3, "notes": []}}
    acc = jperf.PerfAccounting(
        pipeline="v4",
        launch_model={"launches_per_batch": 7, "launches_fixed": 2,
                      "collectives_per_batch": 4, "model": "m",
                      "notes": []},
        stage_traffic=traffic, plan_launches={"front": 1})
    acc.add_chunk(4, 0.5)
    acc.end_level(1)
    if collectives:
        acc.note_collective_probe(0.001)
    return acc.summary({"front": 0.1, "total": 0.2})


def keys(block, path=()):
    """Every key path of a nested block (a stage row's keys once, under
    '*'; a ranking entry's under '#')."""
    out = set()
    for k, v in block.items():
        if path and path[-1] == "stages":
            k = "*"
        p = path + (k,)
        out.add(p)
        if isinstance(v, dict) and k != "plan_launches":   # keyed by data
            out |= keys(v, p)
        elif isinstance(v, list) and v and isinstance(v[0], dict) \
                and k in ("ranking", "per_level"):
            out |= keys(v[0], p + ("#",))
    return out


def test_perf_block_keys_equal_jax():
    res = run_check(BOUNDED, config(pipeline="v4", perf=True), device="cpu")
    assert keys(res.perf) == keys(jax_block(False))
    from raft_tla_tpu_torch.parallel.mesh import MeshBFSEngine
    setup = load_config(BOUNDED)
    from raft_tla_tpu_torch.engine.check import (resolve_constraint,
                                                 resolve_invariants)
    eng = MeshBFSEngine(setup.dims, resolve_invariants(setup),
                        resolve_constraint(setup),
                        config(max_diameter=3, perf=True),
                        devices=["cpu"] * 2)
    mres = eng.run(initial_states(setup))
    want = keys(jax_block(True))
    got = keys(mres.perf)
    # The mesh has no stage rows (a one-device instrument, as in JAX).
    assert got == {p for p in want if "*" not in p and "#" not in p
                   or p[:2] == ("launch", "per_level")}
    assert mres.perf["collectives"]["collectives_per_batch"] == 4


def test_roofline_floors_by_hand():
    """The walked floors of the v4 and v3 stages (``obs/roofline.py``): each
    stage input read once (or its gathered window), each output written
    once, an input written in place counted at its extent; a kernel reads
    and writes its operands in full.  Launches are device ops."""
    dims = load_config(BOUNDED).dims
    B, K, G, sw = 2048, 32768, 132, 473
    seen = 8 * roofline.WALK_SEEN_CAPACITY + 8    # keys and size, int64
    qnext = 2 * K * sw                            # K + max(B, K) rows
    lanes = 16 * K + K * sw + K                   # kh, kl, krows, cons_ok
    # The tail reads the queue, krows, kh, kl, kvalid, cons_ok, the seen
    # set and the count; writes the queue and the seen set (the kernel's
    # operands), the zeroed count, is_new, fail and the count out.
    tail = (qnext + K * sw + 16 * K + K + K + seen + 4,
            qnext + seen + 4 + K + 1 + 4)
    v4 = roofline.stage_traffic(dims, B, K, pipeline="v4")
    assert (v4["front"]["bytes_read"], v4["front"]["bytes_written"]) \
        == (B * sw + B, lanes + K) == (970752, 16089088)
    assert (v4["insert_enqueue"]["bytes_read"],
            v4["insert_enqueue"]["bytes_written"]) \
        == tail == (47218700, 31162385)
    v3 = roofline.stage_traffic(dims, B, K, pipeline="v3")
    assert {s: (r["bytes_read"], r["bytes_written"]) for s, r in v3.items()} \
        == {"masks": (B * sw + B, 8 * B * sw + B * G),
            "compact": (B * G, 4 * K + K),
            "fingerprint": (8 * B * sw + 4 * K, lanes),
            "insert_enqueue": tail}
    assert v3["masks"]["bytes_total"] == 8990720
    # The front and the compaction: one kernel each; the tail: zero_,
    # fpset.pack's five ops and the fused tail; masks and fingerprint:
    # their PyTorch ops.
    assert [v4[s]["launches"] for s in v4] == [1, 7]
    assert [v3[s]["launches"] for s in v3] == [360, 1, 2691, 7]
    # The roofline rows and the advisor carry the JAX module's keys.
    peak = {"bytes_per_sec": 3.35e12, "source": "datasheet (h100)"}
    rows = roofline.build_roofline(v4, {"front": 1e-4}, peak)
    jrows = jroofline.build_roofline(v4, {"front": 1e-4}, peak)
    assert rows == jrows
    assert roofline.advise(rows, 5e-6).keys() == \
        jroofline.advise(jrows, 5e-6).keys()


SALTS = 4 * (2 + 2 * (7 * 3 + 2 * 3 * 3 + 2 * 3 * 3) + 2 * 12)


@pytest.mark.parametrize("helper, args, want", [
    # The mask once, kspread in the dead slots, lane_id, kvalid, (P, total).
    ("compact_bytes", (2048, 132, 32768, 20000),
     2048 * 132 + (32768 - 20000) * 4 + 32768 * 4 + 32768 + 8),
    # Queries, valid, is_new, fail; a sector a distinct key and a claim.
    ("insert_bytes", (32768, 30000, 20000),
     32768 * 10 + 1 + 32 * 30000 + 32 * 20000),
    ("fused_tail_bytes", (32768, 30000, 20000, 15000, 473),
     32768 * 10 + 1 + 32 * 30000 + 32 * 20000 + 32768 + 4
     + 2 * 15000 * 473),
    ("enqueue_bytes", (32768, 15000, 473), 32768 + 2 * 15000 * 473 + 4),
    ("salt_bytes", ("dims",), SALTS),
    ("lane_bytes", ("dims", 20000), 20000 * (473 + 8 * 5 + 1)),
    ("front_bytes", ("dims", 2048, 32768, 20000),
     2048 * 473 + 2048 + (32768 - 20000) * 4 + SALTS + 3 * 2048 * 132 + 8
     + 32768 * 4 + 32768 + 20000 * (473 + 8 * 5 + 1)),
])
def test_kernel_bound_bytes_by_hand(helper, args, want):
    """The hand byte counts ``chip_smoke.py`` prices each kernel's bound
    with, from a batch's live counts (MCraft_bounded's dims)."""
    dims = load_config(BOUNDED).dims
    args = [dims if a == "dims" else a for a in args]
    assert getattr(roofline, helper)(*args) == want


def test_peak_bandwidth_off_the_card(monkeypatch):
    monkeypatch.delenv("RAFT_PEAK_GBPS", raising=False)
    assert roofline.peak_bandwidth("cpu") == {
        "bytes_per_sec": roofline.CPU_ASSUMED_BW,
        "source": "assumed (cpu ddr-class)"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "Some Card 9000")
    got = roofline.peak_bandwidth()
    assert got["source"] == "assumed (unknown accelerator 'some card 9000')"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert roofline.peak_bandwidth()["bytes_per_sec"] == 3.35e12
    monkeypatch.setenv("RAFT_PEAK_GBPS", "100")
    assert roofline.peak_bandwidth()["bytes_per_sec"] == 100e9
    assert perf.launch_overhead_seconds("cpu") > 0


def test_cli_perf_profile_and_capture(tmp_path, capsys):
    ev, xp = tmp_path / "ev.jsonl", tmp_path / "xp"
    rc = cli.main(["check", BOUNDED, "--device", "cpu", "--max-diameter",
                   "3", "--batch", "64", "--perf", "--profile-chunks",
                   "--xla-profile", "2", "--xla-profile-dir", str(xp),
                   "--events-out", str(ev), "--pipeline", "v4"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "chunk profile (" in err and "perf (v4 pipeline" in err
    events = [json.loads(x) for x in ev.read_text().splitlines()]
    by = {e["event"]: e for e in events}
    assert set(by["chunk_profile"]["stages"]) == set(jprofile.STAGES_V4)
    assert by["perf"]["perf"]["launch"]["launches_per_batch"] > 0
    cap = by["xla_profile"]["capture"]
    assert cap["status"] == "ok" and cap["steps"] == 2
    trace = json.loads(open(cap["trace_file"]).read())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "chunk" in names
