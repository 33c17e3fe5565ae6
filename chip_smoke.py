#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It builds the port's kernels from ``raft_tla_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version on the card at the main path's
shapes (exactly: the checker computes integers and bytes), then drives
the port's main path: the exhaustive check of ``configs/MCraft_bounded.cfg``
to depth 9 at batch 2048, with the pinned state counts, and the
``configs/MCraft_noleader.cfg`` counterexample replayed to depth 9; then
a depth-6 check with a tiny seen-set and queue (growth through the insert
kernel and host spill, pinned counts), a depth-8 check whose batch
dispatches run under CUDA sync debug mode "error" (no host wait for the
device outside the one stats read per batch), the check to depth 11
(pinned level profile) and a run to depth 8 under ``torch.profiler`` for
the device's busy share.

Output: the card's name and power limit, one line per phase, then a JSON
line ``{"kernels": [...]}`` with each kernel's launches on the main path,
its error against the plain version and its times beside its bound, and
last ``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero
before those two lines.  Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
B, G, K = 2048, 132, 32768      # main-path batch, grid, compacted lanes
QUEUE, SEEN = 1 << 21, 1 << 25  # main-path queue rows, seen-set slots
MCRAFT_L9_LEVELS = [1, 3, 18, 79, 318, 1218, 4433, 15510, 52467, 172129]
MCRAFT_L9_DISTINCT, MCRAFT_L9_GENERATED = 505004, 1421121
MCRAFT_L6_DISTINCT, MCRAFT_L6_GENERATED = 9457, 24429
MCRAFT_L11_LEVELS = MCRAFT_L9_LEVELS + [548904, 1703703]


class PhaseFailed(Exception):
    pass


def need(cond, what):
    if not cond:
        raise PhaseFailed(what)


def cuda_ms(torch, fn, reps, setup=None):
    """Median milliseconds of ``fn`` between two CUDA events, after one
    warm-up call; ``setup`` runs before each call, outside the events."""
    if setup:
        setup()
    fn()
    times = []
    for _ in range(reps):
        if setup:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs(torch, pairs):
    """Largest |kernel - plain| over integer outputs (float64)."""
    err = 0.0
    for a, b in pairs:
        a = torch.as_tensor(a).double().reshape(-1)
        b = torch.as_tensor(b).double().reshape(-1).to(a.device)
        need(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, float((a - b).abs().max()))
    return err


def random_keys(torch, n, gen, device):
    from raft_tla_tpu_torch.ops.fpset import pack
    hi = torch.randint(0, 1 << 32, (n,), generator=gen, device=device)
    lo = torch.randint(0, 1 << 32, (n,), generator=gen, device=device)
    lo = torch.where((hi == 0xFFFFFFFF) & (lo == 0xFFFFFFFF), 0, lo)
    return hi, lo, pack(hi, lo)


def prefilled_table(torch, gen, device, load):
    """A SEEN-slot table holding ``load * SEEN`` random keys."""
    from raft_tla_tpu_torch.ops import fpset
    from raft_tla_tpu_torch.ops.fpset_cuda import insert
    s = fpset.empty(SEEN, device)
    _hi, _lo, keys = random_keys(torch, int(load * SEEN), gen, device)
    keys = torch.unique(keys)
    for base in range(0, keys.shape[0], 1 << 20):
        q = keys[base:base + (1 << 20)]
        _new, fail = insert(s, q, torch.ones_like(q, dtype=torch.bool))
        need(not bool(fail), "prefill probe failure")
    return s, keys


def dup_heavy_queries(torch, gen, device, present):
    """32,768 queries drawn from a pool of 12,288 keys, a third of them
    already in the table; about 90% of the lanes valid."""
    _h, _l, fresh = random_keys(torch, 8192, gen, device)
    old = present[torch.randint(0, present.shape[0], (4096,), generator=gen,
                                device=device)]
    pool = torch.cat([old, fresh])
    q = pool[torch.randint(0, pool.shape[0], (K,), generator=gen,
                           device=device)]
    valid = torch.rand(K, generator=gen, device=device) < 0.9
    return q, valid


def copy_table(torch, s):
    from raft_tla_tpu_torch.ops.fpset import FPSet
    return FPSet(keys=s.keys.clone(), size=s.size.clone(),
                 owner=s.owner.clone())


def phase_compact(torch, device, gen):
    from raft_tla_tpu_torch.ops import compact_cuda
    from raft_tla_tpu_torch.ops.compact import kspread
    kspr = kspread(B, G, K, device)
    err = 0.0
    for density in (0.0, 0.06, 1.0):
        en = torch.rand((B, G), generator=gen, device=device) < density
        got = compact_cuda.compact(en, K, kspr)
        want = compact_cuda.compact_plain(en, K, kspr)
        torch.cuda.synchronize()
        e = max_abs(torch, zip(got, want))
        print(f"compact density {density}: P={int(got[0][0])} "
              f"total={int(got[0][1])} max_abs_err={e}")
        need(e == 0.0, f"compact differs from its plain version at "
             f"density {density}")
        err = max(err, e)
    en = torch.rand((B, G), generator=gen, device=device) < 0.06
    ms = cuda_ms(torch, lambda: compact_cuda.compact(en, K, kspr), 50)
    plain_ms = cuda_ms(torch, lambda: compact_cuda.compact_plain(
        en, K, kspr), 10)
    pt, _lid, _kv = compact_cuda.compact_plain(en, K, kspr)
    P, total = int(pt[0]), int(pt[1])
    flat = (en & (torch.arange(B, device=device) < P)[:, None]).reshape(-1)
    library_ms = cuda_ms(torch, lambda: torch.nonzero(flat), 50)
    # The mask once, kspread only for the dead slots, lane_id, kvalid and
    # (P, total) written once.
    nbytes = B * G + (K - total) * 4 + K * 4 + K + 8
    row = dict(name="compact", route="cuda",
               source="raft_tla_tpu_torch/csrc/compact.cu",
               replaces="raft_tla_tpu/ops/compact_pallas.py:73",
               max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=library_ms)
    print(f"compact [{B},{G}] -> K={K} at density 0.06: kernel {ms} ms, "
          f"plain {plain_ms} ms, torch.nonzero {library_ms} ms, "
          f"bound {row['bound_ms']} ms ({nbytes} bytes)")
    return row


def distinct_valid(torch, q, valid):
    return int(torch.unique(q[valid]).numel())


def insert_bytes(n, n_distinct, n_new):
    # queries + valid + is_new + fail, one 32-byte sector read per distinct
    # valid key (a duplicate finds its key where the first lane did) and
    # one written per claimed slot.
    return n * (8 + 1 + 1) + 4 + 32 * n_distinct + 32 * n_new


def phase_insert(torch, device, gen, base, present):
    from raft_tla_tpu_torch.ops import fpset_cuda
    q, valid = dup_heavy_queries(torch, gen, device, present)
    load = int(base.size[0]) / base.capacity
    a, b = copy_table(torch, base), copy_table(torch, base)
    new_k, fail_k = fpset_cuda.insert(a, q, valid)
    new_p, fail_p = fpset_cuda.insert_plain(b, q, valid)
    torch.cuda.synchronize()
    err = max_abs(torch, [
        (new_k, new_p), (fail_k, fail_p), (a.size, b.size),
        (torch.sort(a.keys).values, torch.sort(b.keys).values)])
    n_new = int(new_k.sum())
    print(f"fpset_insert {K} queries into 2^25 slots at load {load}: "
          f"new={n_new} fail={bool(fail_k)} size={int(a.size[0])} "
          f"max_abs_err={err}")
    need(err == 0.0, "fpset_insert differs from its plain version")
    need(n_new > 0 and not bool(fail_k), "fpset_insert phase inserted nothing")
    work = copy_table(torch, base)

    def restore():
        work.keys.copy_(base.keys)
        work.size.copy_(base.size)

    ms = cuda_ms(torch, lambda: fpset_cuda.insert(work, q, valid), 20,
                 setup=restore)
    plain_ms = cuda_ms(torch, lambda: fpset_cuda.insert_plain(
        work, q, valid), 2, setup=restore)
    nbytes = insert_bytes(K, distinct_valid(torch, q, valid), n_new)
    row = dict(name="fpset_insert", route="cuda",
               source="raft_tla_tpu_torch/csrc/fpset.cu",
               replaces="raft_tla_tpu/ops/fpset_pallas.py:161",
               max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=None)
    print(f"fpset_insert: kernel {ms} ms, plain {plain_ms} ms, "
          f"bound {row['bound_ms']} ms ({nbytes} bytes)")
    del a, b, work
    return row


def phase_fused_tail(torch, device, gen, base, present):
    from raft_tla_tpu_torch.models.schema import state_width
    from raft_tla_tpu_torch.models.dims import RaftDims
    from raft_tla_tpu_torch.ops import fused_tail_cuda
    sw = state_width(RaftDims(n_servers=3, n_values=2, max_log=3,
                              n_msg_slots=32))
    q, valid = dup_heavy_queries(torch, gen, device, present)
    enq_ok = torch.rand(K, generator=gen, device=device) < 0.7
    krows = torch.randint(0, 256, (K, sw), generator=gen, device=device,
                          dtype=torch.uint8)
    rows_total = QUEUE + K
    next_count = 123457
    qa = torch.randint(0, 256, (rows_total, sw), generator=gen, device=device,
                       dtype=torch.uint8)
    qb = qa.clone()
    a, b = copy_table(torch, base), copy_table(torch, base)
    new_k, fail_k, cnt_k = fused_tail_cuda.insert_enqueue(
        a, q, valid, krows, enq_ok, qa, next_count)
    new_p, fail_p, cnt_p = fused_tail_cuda.insert_enqueue_plain(
        b, q, valid, krows, enq_ok, qb, next_count)
    torch.cuda.synchronize()
    rows_equal = bool(torch.equal(qa, qb))
    err = max_abs(torch, [
        (new_k, new_p), (fail_k, fail_p), (cnt_k, cnt_p), (a.size, b.size),
        (torch.sort(a.keys).values, torch.sort(b.keys).values)])
    n_enq = int(cnt_k) - next_count
    print(f"fused_tail K={K} rows of {sw} B into a {rows_total}-row queue: "
          f"new={int(new_k.sum())} enqueued={n_enq} queue_equal={rows_equal} "
          f"max_abs_err={err}")
    need(err == 0.0 and rows_equal,
         "fused_tail differs from its plain version")
    need(n_enq > 0, "fused_tail phase enqueued nothing")
    del qb, b
    work = copy_table(torch, base)

    def restore():
        work.keys.copy_(base.keys)
        work.size.copy_(base.size)

    ms = cuda_ms(torch, lambda: fused_tail_cuda.insert_enqueue(
        work, q, valid, krows, enq_ok, qa, next_count), 20,
        setup=restore)
    plain_ms = cuda_ms(torch, lambda: fused_tail_cuda.insert_enqueue_plain(
        work, q, valid, krows, enq_ok, qa, next_count), 2,
        setup=restore)
    # The insert's bytes, enq_ok and the count, and each enqueued row read
    # once and written once (no other row need be touched).
    nbytes = (insert_bytes(K, distinct_valid(torch, q, valid),
                           int(new_k.sum()))
              + K + 4 + 2 * n_enq * sw)
    row = dict(name="fused_tail", route="cuda",
               source="raft_tla_tpu_torch/csrc/fused_tail.cu",
               replaces="raft_tla_tpu/ops/fused_tail_pallas.py:103",
               max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=None)
    print(f"fused_tail: kernel {ms} ms, plain {plain_ms} ms, "
          f"bound {row['bound_ms']} ms ({nbytes} bytes)")
    del a, work, qa
    return row


def counters():
    from raft_tla_tpu_torch.ops import compact_cuda, fpset_cuda
    from raft_tla_tpu_torch.ops import fused_tail_cuda
    return {"compact": compact_cuda, "fpset_insert": fpset_cuda,
            "fused_tail": fused_tail_cuda}


def reset_counts():
    for mod in counters().values():
        mod.launches = 0


def read_counts():
    return {name: mod.launches for name, mod in counters().items()}


def phase_main_path(torch):
    from raft_tla_tpu_torch.engine.bfs import EngineConfig
    from raft_tla_tpu_torch.engine.check import run_check
    cfg = EngineConfig(batch=B, queue_capacity=QUEUE, seen_capacity=SEEN,
                       record_trace=False, max_diameter=9)
    torch.cuda.synchronize()
    reset_counts()
    t = time.time()
    res = run_check(os.path.join(HERE, "configs/MCraft_bounded.cfg"), cfg,
                    device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = read_counts()
    ph = res.phases
    print(f"MCraft_bounded L9: distinct={res.distinct} "
          f"generated={res.generated} levels={res.levels} "
          f"stop={res.stop_reason} batches={res.batches} "
          f"spills={res.spills} growths={res.growth_stalls}")
    print(f"MCraft_bounded L9: {res.states_per_second} distinct states/s, "
          f"{res.generated / res.wall_seconds} generated/s, "
          f"check {res.wall_seconds} s, call {wall} s, phases {ph}, "
          f"host blocked on the device {ph['sync'] / res.wall_seconds} "
          f"of the check, launches {counts}")
    need(res.violation is None and res.deadlock is None,
         "MCraft_bounded reported a violation or deadlock")
    need(res.distinct == MCRAFT_L9_DISTINCT
         and res.generated == MCRAFT_L9_GENERATED
         and res.levels == MCRAFT_L9_LEVELS,
         "MCraft_bounded L9 counts differ from the pinned oracle")
    need(all(c > 0 for c in counts.values()),
         f"a kernel was not launched on the main path: {counts}")
    return counts


def phase_small_table(torch):
    """MCraft_bounded to L6 with a tiny seen-set and queue: the table
    grows by rehashing through the insert kernel, the next-level queue
    spills to the host, and the counts still equal the pinned ones."""
    from raft_tla_tpu_torch.engine.bfs import EngineConfig
    from raft_tla_tpu_torch.engine.check import run_check
    cfg = EngineConfig(batch=32, queue_capacity=1024, seen_capacity=256,
                       record_trace=False, max_diameter=6)
    reset_counts()
    res = run_check(os.path.join(HERE, "configs/MCraft_bounded.cfg"), cfg,
                    device="cuda")
    counts = read_counts()
    print(f"MCraft_bounded L6, tiny seen-set and queue: "
          f"distinct={res.distinct} generated={res.generated} "
          f"levels={res.levels} batches={res.batches} spills={res.spills} "
          f"growths (capacity, seconds)={res.growth_stalls} "
          f"launches {counts}")
    need(len(res.growth_stalls) >= 2 and res.spills >= 2,
         "the tiny run neither grew the seen-set twice nor spilled twice")
    need(counts["fpset_insert"] > len(res.growth_stalls),
         f"seen-set growth did not go through the insert kernel: {counts}")
    need(res.distinct == MCRAFT_L6_DISTINCT
         and res.generated == MCRAFT_L6_GENERATED
         and res.levels == MCRAFT_L9_LEVELS[:7],
         "MCraft_bounded L6 with growth and spill differs from the pinned "
         "oracle")


def phase_dispatch_sync_free(torch):
    """MCraft_bounded to L8 at the main path's sizes with every batch's
    dispatch under CUDA sync debug mode "error": a host wait for the
    device inside a dispatch raises, so the engine's "sync" phase (the
    one stats read per batch) holds every wait of the level loop."""
    from raft_tla_tpu_torch.engine.bfs import EngineConfig
    from raft_tla_tpu_torch.engine.check import initial_states, make_engine
    from raft_tla_tpu_torch.utils.cfg import load_config
    setup = load_config(os.path.join(HERE, "configs/MCraft_bounded.cfg"))
    cfg = EngineConfig(batch=B, queue_capacity=QUEUE, seen_capacity=SEEN,
                       record_trace=False, max_diameter=8)
    engine = make_engine(setup, cfg, device="cuda")
    body, checked = engine._body, []

    def strict(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = body(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        checked.append(1)
        return out

    engine._body = strict
    try:
        res = engine.run(initial_states(setup))
    except RuntimeError as e:
        site = [f for f in traceback.extract_tb(e.__traceback__)
                if "raft_tla_tpu_torch" in f.filename]
        where = (f"{os.path.relpath(site[-1].filename, HERE)}:"
                 f"{site[-1].lineno}" if site else "an unknown line")
        raise PhaseFailed(f"a batch dispatch waited for the device at "
                          f"{where}: {e}")
    print(f"dispatch sync check L8: {len(checked)} batch dispatches under "
          f"sync debug mode 'error', none waited for the device; "
          f"distinct={res.distinct}")
    need(len(checked) == res.batches > 0, "no batch was dispatched")
    need(res.levels == MCRAFT_L9_LEVELS[:9],
         "MCraft_bounded L8 levels differ from the pinned oracle")


def phase_deep(torch):
    """MCraft_bounded to L11: the pinned level profile at 4.5M states."""
    from raft_tla_tpu_torch.engine.bfs import EngineConfig
    from raft_tla_tpu_torch.engine.check import run_check
    cfg = EngineConfig(batch=B, queue_capacity=QUEUE, seen_capacity=SEEN,
                       record_trace=False, max_diameter=11)
    reset_counts()
    res = run_check(os.path.join(HERE, "configs/MCraft_bounded.cfg"), cfg,
                    device="cuda")
    ph = res.phases
    print(f"MCraft_bounded L11: distinct={res.distinct} "
          f"generated={res.generated} levels={res.levels} "
          f"batches={res.batches} spills={res.spills} "
          f"growths={res.growth_stalls}")
    print(f"MCraft_bounded L11: {res.states_per_second} distinct states/s, "
          f"{res.generated / res.wall_seconds} generated/s, check "
          f"{res.wall_seconds} s, phases {ph}, launches {read_counts()}")
    need(res.levels == MCRAFT_L11_LEVELS,
         "MCraft_bounded L11 levels differ from the pinned oracle")


def phase_profile(torch):
    """Device busy share of a check to L8 under torch.profiler: the union
    of the device-side intervals over the wall time of the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from raft_tla_tpu_torch.engine.bfs import EngineConfig
    from raft_tla_tpu_torch.engine.check import run_check
    cfg = EngineConfig(batch=B, queue_capacity=QUEUE, seen_capacity=SEEN,
                       record_trace=False, max_diameter=8)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_check(os.path.join(HERE, "configs/MCraft_bounded.cfg"),
                        cfg, device="cuda")
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    if not spans:
        print("profile L8: the profiler saw no device time (not measured)")
        return
    wall_us = res.wall_seconds * 1e6
    print(f"profile L8 (under torch.profiler): check {res.wall_seconds} s, "
          f"{res.batches} batches, device busy {busy / 1e6} s = "
          f"{busy / wall_us} of the check, idle {1 - busy / wall_us}, "
          f"{len(spans) / res.batches} device ops per batch, "
          f"host dispatch {res.phases['dispatch'] / res.batches} s per batch")


def phase_counterexample(torch):
    from raft_tla_tpu_torch.engine.check import run_check
    from raft_tla_tpu_torch.models.dims import LEADER
    reset_counts()
    t = time.time()
    res = run_check(os.path.join(HERE, "configs/MCraft_noleader.cfg"),
                    device="cuda")
    steps = res.engine.replay(res.violation.fingerprint) \
        if res.violation is not None else []
    counts = read_counts()
    print(f"MCraft_noleader: stop={res.stop_reason} distinct={res.distinct} "
          f"depth={len(steps) - 1} in {time.time() - t} s, "
          f"launches {counts}")
    need(res.violation is not None
         and res.violation.invariant == "NoLeaderElected",
         "MCraft_noleader did not stop on NoLeaderElected")
    need(len(steps) - 1 == 9, f"counterexample depth {len(steps) - 1} != 9")
    need(steps[-1][1] == res.violation.state
         and LEADER in steps[-1][1].role
         and all(LEADER not in st.role for _g, st in steps[:-1]),
         "replay does not end at the first leader")
    need(all(c > 0 for c in counts.values()),
         f"a kernel was not launched on the counterexample path: {counts}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "raft_tla_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout holding raft_tla_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else f"nvidia-smi failed: {smi.stderr.strip()}")
    from raft_tla_tpu_torch.utils import build
    t = time.time()
    took = build.build_all()
    print(f"build: {time.time() - t} s (per source {took})")
    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(20261016)
    t = time.time()
    rows = [phase_compact(torch, device, gen)]
    base, present = prefilled_table(torch, gen, device, 0.4)
    rows.append(phase_insert(torch, device, gen, base, present))
    rows.append(phase_fused_tail(torch, device, gen, base, present))
    del base, present
    torch.cuda.empty_cache()
    print(f"kernel phases: {time.time() - t} s")
    counts = phase_main_path(torch)
    phase_counterexample(torch)
    phase_small_table(torch)
    phase_dispatch_sync_free(torch)
    phase_deep(torch)
    phase_profile(torch)
    for row in rows:
        row["launches"] = counts[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
