#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels           (the kernel phases and the
                                               v4 profile only)
    python3 chip_smoke.py --enqueue-variants  (a tuning table, no smoke run)
    python3 chip_smoke.py --front-variants    (a tuning table, no smoke run)
    python3 chip_smoke.py --tail-variants     (a tuning table, no smoke run)
    python3 chip_smoke.py --walks             (the walk tier's phases only)
    python3 chip_smoke.py --reconfig          (the reconfiguration
                                               variant's phases only)
    python3 chip_smoke.py --outputs           (what check prints and
                                               writes, and its cost only)
    python3 chip_smoke.py --mesh              (the mesh's phases only)
    python3 chip_smoke.py --multihost         (the multi-controller
                                               mesh's phases only)

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It builds the port's five kernels from ``raft_tla_tpu_torch/csrc`` (one
nvcc each, all at once), holds each kernel against its plain PyTorch
version on the card at the main path's shapes (exactly: the checker
computes integers and bytes; the chunk front on parent windows of a v3
check, the enqueue on the mask and rows of a real batch, the whole queue
compared), then drives
both plans of the port's main path, v3 (PyTorch front around the
compaction kernel) and v4 (the chunk-front kernel), each with its launch
counts checked: the exhaustive check of
``configs/MCraft_bounded.cfg`` to depth 9 at batch 2048 with the pinned
state counts, the ``configs/MCraft_noleader.cfg`` counterexample replayed
to depth 9, a depth-6 check with a tiny seen-set and queue (growth
through the insert kernel and host spill, pinned counts), a depth-8
check whose batch dispatches run under CUDA sync debug mode "error" (no
host wait for the device outside the one stats read per batch), the
check to depth 11 (pinned levels and counts) and a run to depth 8 under
``torch.profiler`` for the device's busy share.  Then the split tail
(``enqueue_method="kernel"``: the insert kernel and the enqueue kernel in
place of the fused one) drives the same check to depth 9 on both plans
and to depth 11 on v4, with its own launch counts, the sync check (also
for the two PyTorch enqueue lowerings) and the profile; a depth-9 run
writes a checkpoint from which a second engine resumes to depth 11 (the
seen set rebuilt through the insert kernel, timed); and a forged POR
table runs through ``--por-table`` on both plans.  The engine runs
``sync_every`` batches a host round trip, one step captured as a CUDA
graph and replayed: the launch counts are counted a step (a replay
launches what the wrappers recorded at capture), the tiny-table run also
at ``sync_every`` 8 (growth and spill inside chunks), the sync check
covers each chunk's dispatch, and MCraft_bounded L9 and L11 run at
``sync_every`` 1 and 32 in turns.  Then the north-star model: the front,
the fused tail and the trace append held and timed at the shapes of
``configs/TPUraft.cfg`` on a real window; the cfg as written (batch
8192, queue 4,194,304 rows, seen 2^25) to depth 9 with trace on, against
the oracle's 24,753,442 distinct, 84,522,610 generated and ten levels,
an L9 state replayed from the trace; a profile to L6; the split tail to
L8, a 2^20-row queue spilling to files to L8, v3 to L6,
``configs/raft5_bounded.cfg`` with capacities from the card to L8; and a
run capped (``set_per_process_memory_fraction``) between what batch 4096
and batch 8192 need, which must degrade to 4096 and give the L8 counts.
The safety suite (``models/safety.py``, device code in the front's
lanes launch): the front with it held exactly against ``front_plain`` at
MCraft_bounded's and TPUraft's shapes on a real window (where it holds),
random states and the nine crafted violating states, with
MCraft_safety.cfg's ten in order and each of the nine alone (each must be
the first failing id on a crafted lane), and its lanes launch timed
against the TypeOK-only build; ``configs/MCraft_safety.cfg`` as written
to L11 on v4 with both tails and to L9 on v3 (MCraft_bounded's pinned
counts); an ``Init <- SmokeInit`` check equal to its JAX pin
(``tests/test_torch_safety_engine.py``); and TPUraft.cfg with the suite
in place of TypeOK to L8 (the oracle's counts), in turns with TypeOK
alone.
The joint-consensus reconfiguration variant (``models/reconfig.py``,
``configs/reconfig3.cfg``: 474-byte rows with value high-byte planes, 12
families; the front's ``kReconfig`` builds): the front held exactly
against ``front_plain`` on a full window of the L11 frontier, on leader
states at depth 6-8 with InitiateReconfig and FinalizeReconfig lanes and
on those states with their config values aliased to a client value's low
byte, timed, with its launches' registers, spills and blocks an SM beside
the spec's builds'; the cfg to L12 on v4 (the JAX pins: 13 levels,
distinct, generated and every family), to L11 on v3 and on the split
tail, a level-10 snapshot resumed to L12, an L10 profile; and the three
leader roots (built here, ``leader_roots``) to D10 on v4 and D8 on v3
against the JAX engine's counts.
The walk tier (``engine/swarm.py``, ``engine/simulate.py``; no kernel of
its own, a chunk of walk steps is a CUDA graph): the swarm canary
(``CANARY``, the CI canary's configuration) with its JAX pin
(``CANARY_PIN``) and its time to the violation beside the exhaustive
check's; a seeded violation equal to the CPU run; the visited-fingerprint
multiset of one MCraft_bounded run (4,096 walks x 128 steps) identical at
batch 4,096 / 1,024 / 1,000, chunk 8 / 32, graph and eager, and card and
CPU (256 walks x 64 steps); each replayed trace checked step by step;
swarm throughput at 1,024, 16,384 and 65,536 walks of MCraft_bounded and
16,384 of TPUraft (steps/s, device ops and time a step, peak memory);
the BASELINE simulate workload through the CLI cut to 2^21 steps, a
seeded violation, two graph replays drawing differently and a seed
repeating its run.  ``--walks`` runs these phases alone, without the
kernel build.

What ``check`` prints and writes (``obs/``, ``engine/explain.py``, the
CLI): ``python3 -m raft_tla_tpu_torch`` in subprocesses started together,
``check configs/MCraft_noleader.cfg`` on v3 and on v4 with
``--counterexample-dir``, ``--events-out`` and ``--metrics-out``
(``counterexample.txt`` with the sha256 the CPU test pins, depth 9, its
text in the printout, the events file valid with the run's levels in its
statespace report), under ``--no-trace`` (the violating state printed),
``explain`` as JSON and HTML and a one-server model's graph as DOT; a
model with one more guard in its masks deadlocks through the chunk on
the card and prints its state; MCraft_bounded L11 on v4 with the report
and events off and on in turns (off, on, on, off: counts identical, each
wall printed) and the sync check with events on; TPUraft L9's report
printed, its level table the pinned one.  ``--outputs`` runs these phases
(but the TPUraft one) alone, after the kernel build.

The mesh (``parallel/mesh.py``, ``parallel/simulate.py``; n logical
shards on the card, the card count printed, and n = 2 across two cards
where there are two): the routed insert at the main path's shapes (n = 2
and 8 shards of K = 32,768 lanes from a real L8 batch, duplicates within
and across shards, owner tables of 2^25 / n slots at load 0.4) exact
against the same routing through ``insert_plain``, timed; the compaction
kernel cut to a shared P exact against ``compact_plain`` with the cap on
real masks; ``__graft_entry__.py``'s dryrun model at n = 8 (46,553
distinct, diameter 31, shard growth, generated equal to the single
engine's); MCraft_bounded at batch 2048 a shard to L9 at n = 1, 2, 4
(asked for v4: the mesh resolves it to v3's arrangement) with the single
v3 engine in turns, and at n = 2 to L11; tiny tables at n = 4 (spill and
growth inside chunks); the sync check at n = 2; ``check --engine mesh``
on MCraft_noleader through the CLI (the pinned ``counterexample.txt``)
and at n = 4 a depth-9 trace checked step by step; a mesh L9 snapshot
resumed by the single engine to L11 and a single one resumed on the mesh;
TPUraft at n = 2 (4,096 rows a shard) to L8; ``MeshSimulator`` at n = 4
(a seed repeating its run, the near-election violation); with
``--mesh`` also profiles of L8 at n = 2 and 8 (~100 s under the
profiler, so not in the full smoke).  Every mesh run's launches are
checked: the compaction,
the insert and the enqueue once on each shard a step (the enqueue twice
with trace recording), never the fused tail nor the front; the kernels
line carries them as ``mesh`` entries of those three rows.
``--mesh`` runs these phases alone, after the kernel build.

The multi-controller mesh (``parallel/multihost.py``): the parent builds
the kernels, then starts two workers (``chip_smoke.py
--multihost-worker`` with the ``RAFT_*`` launch variables and a free
port), both on the one card over gloo, staged through pinned host
memory; a worker that fails or a pair past ``MH_TIMEOUT`` fails the
phase.  The card count and each worker's transport are printed.  Each
controller runs: the routed insert across processes at n = 2 (one shard
a process) and n = 4 (two), K = 32,768 keys a shard from a real L8
batch with duplicates within shards and across processes, exact against
the same routing through ``insert_plain`` in one process and timed (one
call between events, staging included); MCraft_bounded L9 at n = 2,
batch 2048 a shard, twice, with the pinned counts, the one-process n = 2
run's batches and chunks and each controller's launches (B3, B1 and B5
once a local shard a step), in turns with the one-process run for the
walls; MCraft_noleader through the engine with a trace directory (depth
9, ``counterexample.p{i}of2.txt`` byte-equal across the controllers and
to the one-process n = 2 mesh's file, two trace pieces of one run id)
and ``check --no-trace`` through the CLI under the launch contract (the
same counts on both); an L7 piece group, resumed to L9 by the pair and
by the single engine in the parent; ``MeshSimulator`` at n = 2 equal to
the one-process one walk for walk.  Where more than one card is visible
the L9 phase also runs with one card a process over NCCL.  The kernels
line's B1, B3 and B5 rows carry a ``multihost`` entry (launches a
controller on the L9 run, the routed call's ms).  ``--multihost`` runs
these phases alone, after the kernel build.

The compaction is also held on masks built around its traps (zero
fan-out rows after the last row that fits, total == K on and inside a
scan block, P == 1, B not a multiple of the scan block), the front on
a window whose boundary falls inside a scan block, and the insert and
the fused tail on batches built around theirs (n = 1, 512, 1,000 and
2^20 lanes, a 4,096-slot table grown through the kernel, one new key on
every lane, one present key on every lane, no valid lane, a table that
fails, enq_ok all false and all true, the last row on the queue's last
row, rows of 403 bytes, of configs/raft5_bounded.cfg's width (a tile
staged in several turns) and of the widest the kernel takes; the whole
queue compared, the owner scratch clear
after every call), and the enqueue on masks built around its own (runs
across 64-lane tile edges, one flag in each tile's last lane, an
unaligned flags view, empty, full and alternating masks, 1,000 lanes,
all lanes ending on the queue's last row, rows of 5, 403, 679, 951,
30,704 bytes and the widest); each kernel phase prints the kernel's time for one
call between two CUDA events, its device time among calls queued back
to back, its launches' device microseconds under torch.profiler (for
the insert and the fused tail also at the seen-set loads of L9 and L11,
and checked to be the wrapper's kernels and nothing else for the insert,
the fused tail and the enqueue) and each launch's grid, registers, spill
bytes and shared memory.  ``--enqueue-variants``, ``--front-variants``
and ``--tail-variants`` build the designs the shipped kernels were
measured against by source substitution and time them.

Output: the card's name and power limit, one line per phase, the total
seconds, then a JSON
line ``{"kernels": [...]}`` with each kernel's launches on the main path
(compact on the fused v3 run, the fused tail and the front on the fused
v4 run, the insert and the enqueue on the split v4 run, all to depth 9),
its error against the plain version and its times beside its bound (the
front's entry also holds its reconfiguration builds' under
``"reconfig"``: launches on the reconfig3 L12 run, error, times,
bound), and last ``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero
before those two lines.
Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
B, G, K = 2048, 132, 32768      # main-path batch, grid, compacted lanes
QUEUE, SEEN = 1 << 21, 1 << 25  # main-path queue rows, seen-set slots
NEXT_COUNT = 123457             # rows already queued when a tail is held
MCRAFT_L9_LEVELS = [1, 3, 18, 79, 318, 1218, 4433, 15510, 52467, 172129]
MCRAFT_L9_DISTINCT, MCRAFT_L9_GENERATED = 505004, 1421121
MCRAFT_L6_DISTINCT, MCRAFT_L6_GENERATED = 9457, 24429
MCRAFT_L8_DISTINCT = 139327
MCRAFT_L11_LEVELS = MCRAFT_L9_LEVELS + [548904, 1703703]
MCRAFT_L11_DISTINCT, MCRAFT_L11_GENERATED = 6005282, 17354955
# The oracle's north-star model (BASELINE.md, configs/TPUraft.cfg):
# enqueued states per level, and cumulative distinct / generated.
TPURAFT_LEVELS = [1, 5, 45, 310, 1995, 12306, 72870, 417420, 2324195,
                  12619505]
TPURAFT_DISTINCT = {5: 17852, 6: 114187, 7: 706142, 8: 4237772,
                    9: 24753442}
TPURAFT_GENERATED = {5: 50900, 6: 348800, 7: 2265410, 8: 14090975,
                     9: 84522610}
# The swarm canary (the CI canary's configuration, hunt off) and what the
# JAX package's swarm gives for it: the invariant, the latched
# fingerprint, the trace's action ids, and steps / visited / traces /
# diameter (tests/test_torch_swarm.py holds both packages to it).
CANARY = dict(cfg="configs/MCraft_noleader.cfg", walks=256, max_depth=16,
              chunk=8, ring=16, seed=3)
CANARY_PIN = ("NoLeaderElected", 0xD6467EE051491C1D,
              [-1, 3, 8, 36, 36, 36, 6, 36, 36, 15], 4096, 2802, 1550, 12)


#: The keys of each kernel's entry in the JSON line: `ms` is one wrapper
#: call between two CUDA events (the host's launch path included),
#: `queued_ms` the device time of one call among calls queued back to
#: back, `library_ms` one call of the library yardstick between two events,
#: `headers` the headers of raft_tla_tpu_torch/csrc the source includes.
ROW_KEYS = ("name", "route", "source", "headers", "replaces", "launches",
            "max_abs_err", "ms", "queued_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")


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


def queued_ms(torch, fn, reps=20, samples=5):
    """Milliseconds of one ``fn`` on the device when ``reps`` calls run
    back to back: the calls are queued behind ~8 ms of device copies, so
    the two events bracket device time only, not the host's launch path
    (which a short kernel's single-call median mostly is).  ``fn`` must
    not wait for the device.  Median over the samples in which the host
    did stay ahead; None if it never did."""
    pad = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    pad2 = torch.empty_like(pad)
    fn()
    times = []
    for _ in range(samples):
        torch.cuda.synchronize()
        for _ in range(12):
            pad2.copy_(pad)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        ahead = not a.query()       # the device has not yet reached `a`
        torch.cuda.synchronize()
        if ahead:
            times.append(a.elapsed_time(b) / reps)
    return statistics.median(times) if times else None


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


QUEUED_REPS, QUEUED_SAMPLES = 10, 5


def fresh_batches(torch, gen, device, present):
    """One ``dup_heavy_queries`` batch for each call ``queued_ms`` makes
    with QUEUED_REPS and QUEUED_SAMPLES: an insert queued back to back
    must not meet its own keys again (its table cannot be restored
    between calls without timing the copy).  The ~8,000 new keys of each
    batch raise the table's load by about 0.00024."""
    return [dup_heavy_queries(torch, gen, device, present)
            for _ in range(1 + QUEUED_REPS * QUEUED_SAMPLES)]


def copy_table(torch, s):
    from raft_tla_tpu_torch.ops.fpset import FPSet
    return FPSet(keys=s.keys.clone(), size=s.size.clone(),
                 owner=s.owner.clone())


def fanout_mask(torch, gen, device, counts, n_lanes=G):
    """[len(counts), n_lanes] bool with counts[b] enabled lanes in row b, at
    places drawn from ``gen``."""
    c = torch.as_tensor(counts, device=device)
    order = torch.rand((c.shape[0], n_lanes), generator=gen,
                       device=device).argsort(1)
    return order < c[:, None]


def compact_cases(torch, gen, device):
    """``(name, en, K, P)``: random masks at densities 0, 0.06 and
    1, then masks built around the compaction's traps (the expected P
    beside each).  All at the main path's B, G and K except the two that
    cannot be there: P == 1 needs two rows' fan-out above K (K = 256, the
    least power of two at or above G) and B - 7 rows is no multiple of a
    scan block's 16 rows."""
    def rand(b, density):
        return torch.rand((b, G), generator=gen, device=device) < density

    def fan(head, rest_lo=40):
        rest = torch.randint(rest_lo, G + 1, (B - len(head),), generator=gen,
                             device=device).tolist()
        return fanout_mask(torch, gen, device, list(head) + rest)

    full_rows = K // G                    # 248 full rows fit, 32,736 lanes
    return [
        ("density 0.0", rand(B, 0.0), K, B),
        ("density 0.06", rand(B, 0.06), K, B),
        ("density 1.0", rand(B, 1.0), K, full_rows),
        # cum stays <= K over the zero rows after the last row that fits
        ("zero rows after the last fitting row",
         fan([G] * full_rows + [0] * 12), K, full_rows + 12),
        ("total == K on a block edge", fan([128] * 256), K, 256),
        ("total == K inside a block",
         fan([64] + [128] * 255 + [64]), K, 257),
        ("boundary inside a block", fan([100] * 327, rest_lo=69), K, 327),
        ("P == 1 (K = 256)", rand(B, 1.0), 256, 1),
        ("B - 7 rows, density 0.06", rand(B - 7, 0.06), K, B - 7),
        ("B - 7 rows, boundary inside a block",
         fan([100] * 327, rest_lo=69)[:B - 7].contiguous(), K, 327),
    ]


def phase_compact(torch, device, gen):
    from raft_tla_tpu_torch.ops import compact_cuda
    from raft_tla_tpu_torch.ops.compact import kspread
    err = 0.0
    for name, en, k, want_p in compact_cases(torch, gen, device):
        kspr = kspread(en.shape[0], G, k, device)
        got = compact_cuda.compact(en, k, kspr)
        want = compact_cuda.compact_plain(en, k, kspr)
        torch.cuda.synchronize()
        e = max_abs(torch, zip(got, want))
        P, total = int(got[0][0]), int(got[0][1])
        print(f"compact {name} [{en.shape[0]},{G}] -> K={k}: P={P} "
              f"total={total} max_abs_err={e}")
        need(e == 0.0, f"compact differs from its plain version on the "
             f"{name} mask")
        need(int(want[0][0]) == want_p, f"the {name} mask has P="
             f"{int(want[0][0])}, built for {want_p}")
        err = max(err, e)
    kspr = kspread(B, G, K, device)
    en = torch.rand((B, G), generator=gen, device=device) < 0.06

    def kernel():
        compact_cuda.compact(en, K, kspr)

    ms = cuda_ms(torch, kernel, 50)
    queued = queued_ms(torch, kernel)
    dev_us = device_ops(torch, kernel)
    plain_ms = cuda_ms(torch, lambda: compact_cuda.compact_plain(
        en, K, kspr), 10)
    pt, _lid, _kv = compact_cuda.compact_plain(en, K, kspr)
    P, total = int(pt[0]), int(pt[1])
    flat = (en & (torch.arange(B, device=device) < P)[:, None]).reshape(-1)
    # torch.nonzero reads its output size back to the host, so it can only
    # be timed one call at a time, as `ms` is.
    library_ms = cuda_ms(torch, lambda: torch.nonzero(flat), 50)
    library_us = device_ops(torch, lambda: torch.nonzero(flat))
    # The mask once, kspread only for the dead slots, lane_id, kvalid and
    # (P, total) written once.
    nbytes = B * G + (K - total) * 4 + K * 4 + K + 8
    row = dict(name="compact", route="cuda",
               source="raft_tla_tpu_torch/csrc/compact.cu",
               headers=["compact.cuh", "common.cuh"],
               replaces="raft_tla_tpu/ops/compact_pallas.py:73",
               max_abs_err=err, ms=ms, queued_ms=queued, plain_ms=plain_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=library_ms)
    print(f"compact [{B},{G}] -> K={K} at density 0.06: one call between "
          f"two events: kernel {ms} ms, torch.nonzero {library_ms} ms (it "
          f"waits for the host to read its size), plain {plain_ms} ms; "
          f"kernel queued back to back {queued} ms; bound {row['bound_ms']} "
          f"ms ({nbytes} bytes); device microseconds under the profiler: "
          f"kernel {dev_us or 'not measured'}, torch.nonzero "
          f"{library_us or 'not measured'}")
    info = compact_cuda.launch_info(B, G, K)
    print(f"compact launches at [{B},{G}] -> K={K}: {info}")
    need(all(i["grid"] > 1 for i in info.values()),
         "a compaction launch runs on one block")
    return row


def distinct_valid(torch, q, valid):
    return int(torch.unique(q[valid]).numel())


def insert_bytes(n, n_distinct, n_new):
    # queries + valid + is_new + fail, one 32-byte sector read per distinct
    # valid key (a duplicate finds its key where the first lane did) and
    # one written per claimed slot.
    return n * (8 + 1 + 1) + 1 + 32 * n_distinct + 32 * n_new


def owner_clear(torch, s):
    from raft_tla_tpu_torch.ops.fpset import NO_OWNER
    return bool((s.owner == NO_OWNER).all())


def insert_traps(torch, gen, device, base, present):
    """``[(name, table, keys, valid)]``: the batches the insert must
    survive beside the main path's.  ``table()`` makes the batch's table
    on the card (the 2^25-slot table at load 0.4 unless named)."""
    from raft_tla_tpu_torch.ops import fpset
    q, _v = dup_heavy_queries(torch, gen, device, present)
    ones = torch.ones(K, dtype=torch.bool, device=device)
    _h, _l, one = random_keys(torch, 1, gen, device)
    _h, _l, wide = random_keys(torch, 1 << 20, gen, device)
    small_pool = random_keys(torch, 300, gen, device)[2]
    small = small_pool[torch.randint(0, 300, (512,), generator=gen,
                                     device=device)]
    _h, _l, over = random_keys(torch, 1024, gen, device)

    def main():
        return copy_table(torch, base)

    def rand_valid(n, p=0.8):
        return torch.rand(n, generator=gen, device=device) < p

    return [
        ("n = 1 (the root ingest)", main, one, ones[:1]),
        ("n = 512 into 4,096 slots (the L6 front's K)",
         lambda: fpset.empty(4096, device), small, rand_valid(512)),
        ("n = 1,000 (no multiple of a tile)", main, q[:1000],
         rand_valid(1000)),
        ("all 32,768 lanes one new key", main, one.expand(K).contiguous(),
         ones),
        ("one present key on every lane", main,
         present[:1].expand(K).contiguous(), ones),
        ("no valid lane", main, q, ones & False),
        ("n = 2^20 distinct keys into 2^21 slots (a rehash chunk, load 0.5)",
         lambda: fpset.empty(1 << 21, device), torch.unique(wide),
         None),
        ("a 64-slot table that fails", lambda: fpset.empty(64, device),
         over, ones[:1024]),
    ]


def held_insert(torch, name, s, q, valid):
    """The insert kernel against insert_plain on copies of ``s``: exact
    (is_new, fail, size, key set; only fail where a query fails), and the
    owner scratch all NO_OWNER after the call.  Returns max_abs_err."""
    from raft_tla_tpu_torch.ops import fpset_cuda
    a, b = copy_table(torch, s), copy_table(torch, s)
    new_k, fail_k = fpset_cuda.insert(a, q, valid)
    new_p, fail_p = fpset_cuda.insert_plain(b, q, valid)
    torch.cuda.synchronize()
    failed = bool(fail_p) or bool(fail_k)
    pairs = [(fail_k, fail_p)] if failed else [
        (new_k, new_p), (fail_k, fail_p), (a.size, b.size),
        (torch.sort(a.keys).values, torch.sort(b.keys).values)]
    err = max_abs(torch, pairs)
    clear = owner_clear(torch, a)
    print(f"fpset_insert trap {name}: n={q.shape[0]} capacity={s.capacity} "
          f"new={int(new_k.sum())} fail={bool(fail_k)} max_abs_err={err} "
          f"owner scratch clear={clear}")
    need(err == 0.0 and clear, f"fpset_insert differs from its plain "
         f"version on the {name} batch")
    return err


def grow_trap(torch, gen, device):
    """Batches of 512 into a 4,096-slot table that doubles through the
    insert kernel (fpset.grow) whenever the next batch could take it past
    half full, against the plain version on a CPU table grown the same
    way; every batch exact, the owner scratch clear."""
    from raft_tla_tpu_torch.ops import fpset, fpset_cuda
    pool = random_keys(torch, 9000, gen, device)[2]
    tk, tp = fpset.empty(4096, device), fpset.empty(4096, "cpu")
    err, grows, peak = 0.0, 0, 0.0
    while grows < 2:
        if int(tp.size[0]) + 512 > tp.capacity // 2:
            tk = fpset.grow(tk, 2 * tk.capacity)
            tp = fpset.grow(tp, 2 * tp.capacity)
            grows += 1
        q = pool[torch.randint(0, pool.shape[0], (512,), generator=gen,
                               device=device)]
        v = torch.rand(512, generator=gen, device=device) < 0.9
        new_k, fail_k = fpset_cuda.insert(tk, q, v)
        new_p, fail_p = fpset_cuda.insert(tp, q.cpu(), v.cpu())
        err = max(err, max_abs(torch, [
            (new_k, new_p), (fail_k, fail_p), (tk.size, tp.size),
            (torch.sort(tk.keys).values, torch.sort(tp.keys).values)]))
        need(owner_clear(torch, tk), "owner scratch left set in the grow "
             "trap")
        peak = max(peak, int(tp.size[0]) / tp.capacity)
    print(f"fpset_insert trap 4,096 slots grown twice through the kernel: "
          f"capacity {tk.capacity}, size {int(tk.size[0])}, highest load "
          f"{peak}, max_abs_err={err}")
    need(err == 0.0, "fpset_insert differs from its plain version on the "
         "growing table")
    return err


def launch_check(torch, what, fn, kernels, setup=None):
    """The profiled call's device operations are exactly the wrapper's
    kernel launches, in order (nothing else of PyTorch's).  The profiler
    now and then sees nothing of a call, so up to five profiles are taken:
    none may show another operation, and one must show all of them."""
    for _ in range(5):
        ops = device_ops(torch, fn, setup=setup)
        names = [n for n, _us in ops]
        need(set(names) <= set(kernels),
             f"{what} issued {names}, not just {list(kernels)}")
        if names == list(kernels):
            break
    print(f"{what}: {len(ops)} CUDA launches a call, device microseconds "
          f"{ops}")
    need(names == list(kernels), f"{what}: the profiler saw {names} in five "
         f"profiles, not {list(kernels)}")


def probe_loads(torch, device, gen):
    """The insert at the main path's real loads (the 2^25-slot table at
    L9 holds ~0.015, at L11 ~0.18): queued time and per-launch device
    microseconds of the load-0.4 phase's batch kind."""
    from raft_tla_tpu_torch.ops import fpset_cuda
    for load in (0.015, 0.18):
        table, present = prefilled_table(torch, gen, device, load)
        batches = iter(fresh_batches(torch, gen, device, present))
        queued = queued_ms(torch, lambda: fpset_cuda.insert(
            table, *next(batches)), QUEUED_REPS, QUEUED_SAMPLES)
        q, valid = dup_heavy_queries(torch, gen, device, present)
        ops = device_ops(torch, lambda: fpset_cuda.insert(table, q, valid))
        print(f"fpset_insert at load {load} (2^25 slots): queued back to "
              f"back {queued} ms; device microseconds {ops or 'not measured'}")
        del table, present, batches
        torch.cuda.empty_cache()


def phase_insert(torch, device, gen, base, present):
    from raft_tla_tpu_torch.ops import fpset_cuda
    err = 0.0
    for name, table, q, valid in insert_traps(torch, gen, device, base,
                                              present):
        if valid is None:
            valid = torch.ones_like(q, dtype=torch.bool)
        err = max(err, held_insert(torch, name, table(), q, valid))
        torch.cuda.empty_cache()
    err = max(err, grow_trap(torch, gen, device))
    q, valid = dup_heavy_queries(torch, gen, device, present)
    load = int(base.size[0]) / base.capacity
    a = copy_table(torch, base)
    new_k, fail_k = fpset_cuda.insert(a, q, valid)
    torch.cuda.synchronize()
    n_new = int(new_k.sum())
    err = max(err, held_insert(torch, f"main path at load {load}", base, q,
                               valid))
    need(n_new > 0 and not bool(fail_k), "fpset_insert phase inserted nothing")
    work = copy_table(torch, base)

    def restore():
        work.keys.copy_(base.keys)
        work.size.copy_(base.size)

    ms = cuda_ms(torch, lambda: fpset_cuda.insert(work, q, valid), 20,
                 setup=restore)
    plain_ms = cuda_ms(torch, lambda: fpset_cuda.insert_plain(
        work, q, valid), 2, setup=restore)
    restore()
    batches = iter(fresh_batches(torch, gen, device, present))
    queued = queued_ms(torch, lambda: fpset_cuda.insert(
        work, *next(batches)), QUEUED_REPS, QUEUED_SAMPLES)
    nbytes = insert_bytes(K, distinct_valid(torch, q, valid), n_new)
    row = dict(name="fpset_insert", route="cuda",
               source="raft_tla_tpu_torch/csrc/fpset.cu",
               headers=["fpset.cuh", "common.cuh"],
               replaces="raft_tla_tpu/ops/fpset_pallas.py:162",
               max_abs_err=err, ms=ms, queued_ms=queued, plain_ms=plain_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=None)
    print(f"fpset_insert {K} queries into 2^25 slots at load {load}: one "
          f"call between two events: kernel {ms} ms, plain {plain_ms} ms; "
          f"kernel queued back to back (a fresh batch of the same kind each "
          f"call) {queued} ms; bound {row['bound_ms']} ms ({nbytes} bytes)")
    launch_check(torch, "fpset_insert", lambda: fpset_cuda.insert(
        work, q, valid), fpset_cuda.KERNELS, setup=restore)
    info = fpset_cuda.launch_info(K)
    print(f"fpset_insert launches at n={K}: {info}; at n=2^20: "
          f"{fpset_cuda.launch_info(1 << 20)}")
    del a, work
    return row


def device_count(torch, value, device):
    """``value`` as the int32 count a kernel reads on the card, written by
    a kernel launched just before (a fill): the way the level loop hands
    a count over, the launch before having written it."""
    nc = torch.empty(1, dtype=torch.int32, device=device)
    nc.fill_(value)
    return nc


def held_tail(torch, name, s, q, valid, krows, enq_ok, qa, qb, next_count):
    """The fused tail against insert_enqueue_plain on copies of ``s`` and
    on the two queues ``qa`` / ``qb`` (equal before): is_new, fail, count,
    size, key set and the WHOLE queue equal (only fail where a query
    fails), the owner scratch clear.  The kernel reads ``next_count``
    from the card, written by the launch just before.  Returns
    max_abs_err."""
    from raft_tla_tpu_torch.ops import fused_tail_cuda
    a, b = copy_table(torch, s), copy_table(torch, s)
    new_k, fail_k, cnt_k = fused_tail_cuda.insert_enqueue(
        a, q, valid, krows, enq_ok, qa,
        device_count(torch, next_count, q.device), next_count)
    new_p, fail_p, cnt_p = fused_tail_cuda.insert_enqueue_plain(
        b, q, valid, krows, enq_ok, qb, next_count)
    torch.cuda.synchronize()
    failed = bool(fail_p) or bool(fail_k)
    if failed:
        err, rows_equal = max_abs(torch, [(fail_k, fail_p)]), True
        qa.copy_(qb)
    else:
        rows_equal = bool(torch.equal(qa, qb))
        err = max_abs(torch, [
            (new_k, new_p), (fail_k, fail_p), (cnt_k, cnt_p),
            (a.size, b.size),
            (torch.sort(a.keys).values, torch.sort(b.keys).values)])
    clear = owner_clear(torch, a)
    n_enq = int(cnt_k) - next_count
    print(f"fused_tail trap {name}: n={q.shape[0]} rows of {krows.shape[1]} "
          f"B, new={int(new_k.sum())} enqueued={n_enq} at {next_count} of "
          f"{qa.shape[0]} rows, fail={bool(fail_k)} queue_equal={rows_equal} "
          f"max_abs_err={err} owner scratch clear={clear}")
    need(err == 0.0 and rows_equal and clear,
         f"fused_tail differs from its plain version on the {name} batch")
    return err, n_enq


def phase_fused_tail(torch, device, gen, base, present):
    from raft_tla_tpu_torch.models.schema import state_width
    from raft_tla_tpu_torch.models.dims import RaftDims
    from raft_tla_tpu_torch.ops import fpset, fused_tail_cuda
    from raft_tla_tpu_torch.utils.cfg import load_config
    sw = state_width(RaftDims(n_servers=3, n_values=2, max_log=3,
                              n_msg_slots=32))
    krows = torch.randint(0, 256, (K, sw), generator=gen, device=device,
                          dtype=torch.uint8)
    rows_total = QUEUE + K
    qa = torch.randint(0, 256, (rows_total, sw), generator=gen, device=device,
                       dtype=torch.uint8)
    qb = qa.clone()
    err = 0.0
    ok_rand = torch.rand(K, generator=gen, device=device) < 0.7
    for name, table, q, valid in insert_traps(torch, gen, device, base,
                                              present):
        if valid is None:
            continue                # the rehash chunk is the insert's alone
        n = q.shape[0]
        e, _n = held_tail(torch, name, table(), q, valid, krows[:n],
                          ok_rand[:n], qa, qb, NEXT_COUNT)
        err = max(err, e)
    q, valid = dup_heavy_queries(torch, gen, device, present)
    for name, ok in (("enq_ok all false", ok_rand & False),
                     ("enq_ok all true", ok_rand | True)):
        err = max(err, held_tail(torch, name, base, q, valid, krows, ok, qa,
                                 qb, NEXT_COUNT)[0])
    # K distinct new keys, all enqueued: the last row lands on the queue's
    # last row.
    _h, _l, fresh = random_keys(torch, K, gen, device)
    need(torch.unique(fresh).shape[0] == K, "the fresh keys collide")
    e, n_enq = held_tail(torch, "the last live row on the queue's last row",
                         base, fresh, ok_rand | True, krows, ok_rand | True,
                         qa, qb, QUEUE)
    need(n_enq == K, f"{n_enq} rows enqueued, not {K}")
    err = max(err, e)
    # Rows of MCraft_noleader's width, into a smaller queue.
    sw403 = state_width(RaftDims(n_servers=3, n_values=2, max_log=2,
                                 n_msg_slots=32))
    r403 = torch.randint(0, 256, (K, sw403), generator=gen, device=device,
                         dtype=torch.uint8)
    q403a = torch.randint(0, 256, ((1 << 16) + K, sw403), generator=gen,
                          device=device, dtype=torch.uint8)
    q403b = q403a.clone()
    err = max(err, held_tail(torch, f"rows of {sw403} B",
                             fpset.empty(1 << 18, device), q, valid, r403,
                             ok_rand, q403a, q403b, 12345)[0])
    del r403, q403a, q403b
    # Rows too wide for a 64-lane tile to fit the stage at once, so that a
    # tile is staged in turns: raft5_bounded's rows at K lanes, and the
    # widest rows the kernel takes (a turn a row) on 1,000 lanes.
    sw5 = state_width(load_config(os.path.join(
        HERE, "configs/raft5_bounded.cfg")).dims)
    _tile, widest = fused_tail_cuda.geometry()
    need(64 * sw5 > widest, f"{sw5}-byte rows fit the stage at once")
    for w, n in ((sw5, K), (widest, 1000)):
        rw = torch.randint(0, 256, (n, w), generator=gen, device=device,
                           dtype=torch.uint8)
        qwa = torch.randint(0, 256, (4096 + n, w), generator=gen,
                            device=device, dtype=torch.uint8)
        qwb = qwa.clone()
        err = max(err, held_tail(torch, f"rows of {w} B",
                                 fpset.empty(1 << 18, device), q[:n],
                                 valid[:n], rw, ok_rand[:n], qwa, qwb,
                                 777)[0])
        del rw, qwa, qwb
    e, n_enq = held_tail(torch, "main path", base, q, valid, krows, ok_rand,
                         qa, qb, NEXT_COUNT)
    err = max(err, e)
    # Two tails chained as in a chunk: the second reads, as its count, the
    # count the first one's last launch wrote on the card.
    a, b = copy_table(torch, base), copy_table(torch, base)
    (_h, _l, k1), (_h, _l, k2) = (random_keys(torch, K, gen, device)
                                  for _ in range(2))
    _n, _f, c1 = fused_tail_cuda.insert_enqueue(
        a, k1, valid, krows, ok_rand, qa,
        device_count(torch, NEXT_COUNT, device), NEXT_COUNT)
    new_k, _f, c2 = fused_tail_cuda.insert_enqueue(
        a, k2, valid, krows, ok_rand, qa, c1.view(1), NEXT_COUNT + K)
    _n, _f, p1 = fused_tail_cuda.insert_enqueue_plain(
        b, k1, valid, krows, ok_rand, qb, NEXT_COUNT)
    new_p, _f, p2 = fused_tail_cuda.insert_enqueue_plain(
        b, k2, valid, krows, ok_rand, qb, p1)
    torch.cuda.synchronize()
    e = max_abs(torch, [(c2, p2), (new_k, new_p), (a.size, b.size)])
    equal = bool(torch.equal(qa, qb))
    print(f"fused_tail chained (the count the launch before wrote): "
          f"{int(c2) - NEXT_COUNT} rows, queue_equal={equal} "
          f"max_abs_err={e}")
    need(e == 0.0 and equal, "two chained fused tails differ from the "
         "plain version")
    err = max(err, e)
    del a, b
    need(n_enq > 0, "fused_tail phase enqueued nothing")
    enq_ok, next_count = ok_rand, NEXT_COUNT
    nc = device_count(torch, next_count, device)
    del qb
    work = copy_table(torch, base)
    a = copy_table(torch, base)
    new_k, _f, _c = fused_tail_cuda.insert_enqueue(a, q, valid, krows, enq_ok,
                                                   qa, next_count)
    n_new = int(new_k.sum())

    def restore():
        work.keys.copy_(base.keys)
        work.size.copy_(base.size)

    def kernel():
        fused_tail_cuda.insert_enqueue(work, q, valid, krows, enq_ok, qa,
                                       nc, next_count)

    ms = cuda_ms(torch, kernel, 20, setup=restore)
    plain_ms = cuda_ms(torch, lambda: fused_tail_cuda.insert_enqueue_plain(
        work, q, valid, krows, enq_ok, qa, next_count), 2,
        setup=restore)
    restore()
    batches = iter(fresh_batches(torch, gen, device, present))
    queued = queued_ms(torch, lambda: fused_tail_cuda.insert_enqueue(
        work, *next(batches), krows, enq_ok, qa, nc, next_count),
        QUEUED_REPS, QUEUED_SAMPLES)
    # The insert's bytes, enq_ok and the count, and each enqueued row read
    # once and written once (no other row need be touched).
    nbytes = (insert_bytes(K, distinct_valid(torch, q, valid), n_new)
              + K + 4 + 2 * n_enq * sw)
    row = dict(name="fused_tail", route="cuda",
               source="raft_tla_tpu_torch/csrc/fused_tail.cu",
               headers=["fpset.cuh", "enqueue.cuh", "common.cuh"],
               replaces="raft_tla_tpu/ops/fused_tail_pallas.py:104",
               max_abs_err=err, ms=ms, queued_ms=queued, plain_ms=plain_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=None)
    print(f"fused_tail K={K} rows of {sw} B into a {rows_total}-row queue, "
          f"{n_enq} enqueued: one call between two events: kernel {ms} ms, "
          f"plain {plain_ms} ms; kernel queued back to back (a fresh batch "
          f"of the same kind each call) {queued} ms; bound {row['bound_ms']} "
          f"ms ({nbytes} bytes)")
    launch_check(torch, "fused_tail", kernel, fused_tail_cuda.KERNELS,
                 setup=restore)
    info = fused_tail_cuda.launch_info(K)
    print(f"fused_tail launches at K={K}: {info}")
    need(all(i["grid"] > 1 for i in info.values()),
         "a fused-tail launch runs on one block")
    del a, work, qa
    return row


def front_err(torch, got, want):
    """Largest |kernel - plain| over the front's 14 outputs, the per-lane
    ones the kernel leaves unwritten on dead lanes compared on live lanes
    (the plain version's total, so a wrong total shows)."""
    from raft_tla_tpu_torch.ops.chunk_front import LIVE_ONLY, FrontOut
    total = int(want.total)
    return max_abs(torch, [(g[:total], w[:total]) if f in LIVE_ONLY
                           else (g, w)
                           for f, g, w in zip(FrontOut._fields, got, want)])


def dispatch_eagerly(engine):
    """Have ``engine`` dispatch each chunk step itself in place of a graph
    replay, so that a hook on ``engine._step.body`` sees every batch (a
    graph runs the body once, at capture).  Instrumentation only."""
    def runner(qcur, qnext, seen, res):
        return lambda: engine._step(qcur, seen, qnext, engine._tbuf,
                                    engine._cs)
    engine._runner = runner


def front_rig(torch, device):
    """``(setup, v2, Front keywords, windows)`` of MCraft_bounded at the
    main path's sizes: the parent windows a v3 check to L8 dispatched
    (its steps dispatched eagerly, so a hook on the body sees each)."""
    from raft_tla_tpu_torch.engine.bfs import EngineConfig
    from raft_tla_tpu_torch.engine.check import initial_states, make_engine
    from raft_tla_tpu_torch.models.actions2 import build_v2
    from raft_tla_tpu_torch.models.invariants import (build_constraint,
                                                      build_no_leader,
                                                      build_type_ok)
    from raft_tla_tpu_torch.utils.cfg import load_config
    setup = load_config(os.path.join(HERE, "configs/MCraft_bounded.cfg"))
    dims = setup.dims
    engine = make_engine(setup, EngineConfig(
        batch=B, queue_capacity=QUEUE, seen_capacity=SEEN,
        record_trace=False, max_diameter=8, pipeline="v3"), device="cuda")
    dispatch_eagerly(engine)
    body, windows = engine._step.body, []

    def capture(rows, valid, *args):
        windows.append((rows.clone(), valid.clone()))
        return body(rows, valid, *args)

    engine._step.body = capture
    engine.run(initial_states(setup))
    # Steps whose cond failed ran on no valid row.
    windows = [w for w in windows if bool(w[1].any())]
    v2 = build_v2(dims, device)
    kw = dict(dims=dims, v2=v2,
              inv_fns=[build_type_ok(dims), build_no_leader(dims)],
              constraint=build_constraint(dims, setup.bounds), B=B, K=K,
              device=device)
    return setup, v2, kw, windows


def phase_front(torch, device):
    """The v4 chunk front at the main path's shapes on real rows: parent
    windows that a v3 check to L8 dispatched on the card.  Three calls
    are held exactly against ``front_plain``: the 2048 rows of least
    fan-out (the whole window fits K), a full window of the engine's own
    (progress-limited) and the same window under the forged POR arrays
    (every DuplicateMessage instance certified, priority = g)."""
    from raft_tla_tpu_torch.models.schema import state_width, unflatten_state
    from raft_tla_tpu_torch.ops import chunk_front_cuda
    setup, v2, kw, windows = front_rig(torch, device)
    dims = setup.dims
    pool = torch.cat([r[v] for r, v in windows])
    fanout = v2.masks(unflatten_state(pool, dims))[0].sum(1)
    least = torch.sort(torch.argsort(fanout)[:B]).values
    full = [w for w in windows if bool(w[1].all())]
    need(full, "the v3 run dispatched no full window")
    G = dims.n_instances
    por_mask = torch.zeros(G, dtype=torch.bool)
    off = dims.family_offsets[dims.family_names.index("DuplicateMessage")]
    por_mask[off:off + dims.n_msg_slots] = True
    por_pri = torch.arange(G, dtype=torch.int32)
    front = chunk_front_cuda.Front(**kw)
    front_por = chunk_front_cuda.Front(
        **kw, por_mask=por_mask.numpy(), por_priority=por_pri.numpy())
    cases = [("fitting", front, pool[least], torch.ones_like(full[-1][1])),
             ("progress-limited", front, *full[-1]),
             ("POR", front_por, *full[-1]),
             ("mid-block boundary", front, *mid_block_window(
                 torch, pool, fanout))]
    err = 0.0
    for name, fr, rows, valid in cases:
        got = fr(rows, valid)
        e = front_err(torch, got, fr.plain(rows, valid))
        total, P = int(got.total), int(got.P)
        print(f"chunk_front {name} window: P={P} total={int(got.total)} "
              f"pruned={int(got.pruned.sum())} "
              f"invariant hits={int((got.inv[:total] >= 0).sum())} "
              f"constraint fails={int((~got.cons_ok[:total]).sum())} "
              f"max_abs_err={e}")
        need(e == 0.0, f"chunk_front differs from front_plain on the {name} "
             "window")
        if name == "POR":
            need(bool(got.pruned.any()), "the POR window pruned nothing")
        elif name == "mid-block boundary":
            need(P % 16 == 7 and not bool(valid[P - 4:P].any())
                 and bool(valid[P]), f"the {name} window has P={P}")
        else:
            need((P == B) == (name == "fitting"),
                 f"the {name} window has P={P}")
        err = max(err, e)
    rows, valid = full[-1]
    out = front(rows, valid)
    total = int(out.total)
    ms = cuda_ms(torch, lambda: front(rows, valid), 50)
    queued = queued_ms(torch, lambda: front(rows, valid))
    plain_ms = cuda_ms(torch, lambda: front.plain(rows, valid), 5)
    ops = device_ops(torch, lambda: front(rows, valid))
    sw = state_width(dims)
    nbytes = front_bytes(dims, B, K, total)
    row = dict(name="chunk_front", route="cuda",
               source="raft_tla_tpu_torch/csrc/chunk_front.cu",
               headers=["raft_model.cuh", "compact.cuh", "common.cuh"],
               replaces="raft_tla_tpu/ops/chunk_front_pallas.py:94",
               max_abs_err=err, ms=ms, queued_ms=queued, plain_ms=plain_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=None)
    print(f"chunk_front [{B},{sw}] -> K={K} (total {total}): one call "
          f"between two events {ms} ms, plain {plain_ms} ms; queued back to "
          f"back {queued} ms; bound {row['bound_ms']} ms ({nbytes} bytes), "
          f"CUDA launches per call "
          f"{len(ops) if ops else 'not measured'} "
          f"(device microseconds under the profiler: {ops})")
    info = front.launch_info()
    print(f"chunk_front launches at [{B},{sw}] -> K={K}: {info}; blocks an "
          f"SM {front.occupancy()}")
    need(all(i["grid"] > 1 for i in info.values()),
         "a front launch runs on one block")
    need(info["masks_kernel"]["dynamic_smem"]
         == chunk_front_cuda.masks_smem(dims)
         and info["lanes_kernel"]["dynamic_smem"]
         == chunk_front_cuda.lanes_smem(dims),
         "check_dims counts other shared memory than the launches take")
    del windows, pool, cases, out
    return row


def front_bytes(dims, b, k, total):
    """Bytes one front call must move.  Read: the parent rows, valid,
    kspread in the dead slots and the salt tables; written: the three
    [b, G] masks, (P, total), lane_id, kvalid and on each live lane its
    row and six scalars (dead lanes are left unwritten by contract)."""
    from raft_tla_tpu_torch.models.schema import state_width
    sw, g = state_width(dims), dims.n_instances
    salts = 4 * (2 + 2 * (7 * dims.n_servers + 2 * dims.n_servers
                          * dims.max_log + 2 * dims.n_servers ** 2)
                 + 2 * dims.msg_width)
    return (b * sw + b + (k - total) * 4 + salts + 3 * b * g + 8
            + k * 4 + k + total * (sw + 8 * 5 + 1))


def mid_block_window(torch, pool, fanout):
    """A progress-limited window of real rows whose last taken row falls
    inside a 16-row block of the compaction, with 4-19 invalid (zero
    fan-out) rows right before it: the rows of most fan-out that fit K,
    the invalid rows, then the row that does not fit, then any rows."""
    order = torch.argsort(fanout, descending=True)
    n1 = int((fanout[order].cumsum(0) <= K).sum())
    nz = (7 - n1) % 16
    nz += 16 if nz < 4 else 0
    need(n1 + nz + 1 <= B, f"{n1} rows of most fan-out fit K")
    n_rest = B - n1 - nz
    rows = torch.cat([pool[order[:n1]], pool[order[:nz]],
                      pool[order[n1:n1 + n_rest]]])
    valid = torch.ones(B, dtype=torch.bool, device=rows.device)
    valid[n1:n1 + nz] = False
    return rows, valid


def phase_other_dims(torch, device):
    """The front at dims other than the main path's, as the kernel takes
    them at run time: more message slots than a warp has lanes, a wider
    message row, five servers.  A v3 check and a v4 check of each must
    agree on every count, and the front kernel must equal front_plain on
    every parent window the v3 check dispatched."""
    from raft_tla_tpu_torch.engine.bfs import BFSEngine, EngineConfig
    from raft_tla_tpu_torch.models.actions2 import build_v2
    from raft_tla_tpu_torch.models.dims import RaftDims
    from raft_tla_tpu_torch.models.invariants import (Bounds,
                                                      build_constraint,
                                                      build_type_ok)
    from raft_tla_tpu_torch.models.pystate import init_state
    from raft_tla_tpu_torch.ops import chunk_front_cuda
    from raft_tla_tpu_torch.ops.compact import choose_k
    cases = ((RaftDims(n_servers=3, n_values=2, max_log=4, n_msg_slots=40),
              Bounds(max_term=2, max_log_len=3, max_msg_count=1), 7),
             (RaftDims(n_servers=5, n_values=1, max_log=2, n_msg_slots=64),
              Bounds(max_term=2, max_log_len=1, max_msg_count=1), 5))
    for dims, bounds, depth in cases:
        invs = {"TypeOK": build_type_ok(dims)}
        cons = build_constraint(dims, bounds)
        res, windows = {}, []
        for pipeline in ("v3", "v4"):
            engine = BFSEngine(dims, invariants=invs, constraint=cons,
                               config=EngineConfig(
                                   batch=256, queue_capacity=1 << 16,
                                   seen_capacity=1 << 18, record_trace=False,
                                   check_deadlock=False, max_diameter=depth,
                                   pipeline=pipeline), device="cuda")
            body = engine._step.body
            if pipeline == "v3":
                dispatch_eagerly(engine)

                def capture(rows, valid, *args, body=body):
                    if bool(valid.any()):
                        windows.append((rows.clone(), valid.clone()))
                    return body(rows, valid, *args)
                engine._step.body = capture
            reset_counts()
            r = engine.run([init_state(dims)])
            check_launches(pipeline, read_counts(), r.steps, f"dims {dims}")
            res[pipeline] = (r.distinct, r.generated, r.levels,
                             r.action_counts)
        front = chunk_front_cuda.Front(
            dims=dims, v2=build_v2(dims, device), inv_fns=list(invs.values()),
            constraint=cons, B=256, K=choose_k(256, dims.n_instances),
            device=device)
        err = 0.0
        for rows, valid in windows:
            err = max(err, front_err(torch, front(rows, valid),
                                     front.plain(rows, valid)))
        print(f"dims {dims} to L{depth}: v3 and v4 distinct/generated/levels "
              f"{res['v3'][:3]} / {res['v4'][:3]}; chunk_front on "
              f"{len(windows)} windows max_abs_err={err}")
        need(res["v3"] == res["v4"], f"v3 and v4 differ at dims {dims}")
        need(err == 0.0, f"chunk_front differs from front_plain at dims "
             f"{dims}")


def device_ops(torch, fn, setup=None):
    """``[(kernel name, device microseconds)]`` of the device operations
    one call of ``fn`` issues, as torch.profiler sees them (empty when the
    profiler sees no device activity); ``setup`` runs before each call,
    outside the profile.

    The profiler drops device activity that it dates to before its own
    start, and on some machines that was the first launch of the call.
    So the profile opens with a marker launch (``torch.cuda._sleep``) and
    a host pause, and only what starts after the marker ends is the
    call's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if setup:
        setup()
    fn()
    if setup:
        setup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.02)
        fn()
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    marks = [e.time_range.end for e in dev if "spin_kernel" in e.name]
    after = max(marks, default=None)
    return [(short_name(e.name), e.time_range.end - e.time_range.start)
            for e in dev if "spin_kernel" not in e.name
            and (after is None or e.time_range.start >= after)]


def short_name(name):
    """A kernel's own name out of its demangled signature."""
    m = re.search(r"(\w+)(?:<[^()]*>)?\(", name)
    return (m.group(1) if m else name)[:48]


def counters():
    from raft_tla_tpu_torch.ops import chunk_front_cuda, compact_cuda
    from raft_tla_tpu_torch.ops import enqueue_cuda, fpset_cuda
    from raft_tla_tpu_torch.ops import fused_tail_cuda
    return {"compact": compact_cuda, "fpset_insert": fpset_cuda,
            "fused_tail": fused_tail_cuda, "chunk_front": chunk_front_cuda,
            "enqueue": enqueue_cuda}


def reset_counts():
    for mod in counters().values():
        mod.launches = 0


def read_counts():
    return {name: mod.launches for name, mod in counters().items()}


def check_launches(pipeline, counts, steps, what, method="fused",
                   inserts=None, trace=False):
    """Each path's kernels launched once per step, where they run per
    batch (a step is dispatched whether or not its cond lets its batch
    run: a graph replay, or an eager call; under a graph each replay
    launches what the wrappers recorded at capture and is counted so);
    the v4 path never runs the v3 compaction (nor so the plain front), the
    v3 path never the front kernel.  The fused tail runs the fused kernel
    each step and the insert kernel only outside the steps (root ingest,
    growth, a resume's rebuild); a split tail never runs the fused kernel,
    runs the insert kernel each step besides, and the enqueue kernel each
    step when that is its enqueue.  With trace recording the enqueue
    kernel also appends each step's trace records.  ``inserts``, where
    given, is the exact number of insert launches outside the steps."""
    front, other = (("compact", "chunk_front") if pipeline == "v3"
                    else ("chunk_front", "compact"))
    ok = counts[front] == steps > 0 and counts[other] == 0
    per_step = 0 if method == "fused" else steps
    ok = ok and counts["fused_tail"] == steps - per_step
    ok = ok and counts["enqueue"] == ((steps if method == "kernel" else 0)
                                      + (steps if trace else 0))
    outside = counts["fpset_insert"] - per_step
    ok = ok and (outside > 0 if inserts is None else outside == inserts)
    need(ok, f"{what} ({pipeline}, {method} tail): launches {counts} over "
         f"{steps} steps")


def bounded_config(pipeline, depth, **kw):
    from raft_tla_tpu_torch.engine.bfs import EngineConfig
    base = dict(batch=B, queue_capacity=QUEUE, seen_capacity=SEEN,
                record_trace=False, max_diameter=depth, pipeline=pipeline)
    base.update(kw)
    return EngineConfig(**base)


def phase_main_path(torch, pipeline, method="fused"):
    """MCraft_bounded to L9 at the main path's sizes, launches counted."""
    from raft_tla_tpu_torch.engine.check import run_check
    torch.cuda.synchronize()
    reset_counts()
    t = time.time()
    res = run_check(os.path.join(HERE, "configs/MCraft_bounded.cfg"),
                    bounded_config(pipeline, 9, enqueue_method=method),
                    device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = read_counts()
    ph = res.phases
    what = f"{pipeline} {method} tail"
    print(f"MCraft_bounded L9 {what}: distinct={res.distinct} "
          f"generated={res.generated} levels={res.levels} "
          f"stop={res.stop_reason} batches={res.batches} "
          f"spills={res.spills} growths={res.growth_stalls}")
    print(f"MCraft_bounded L9 {what}: {res.states_per_second} distinct "
          f"states/s, {res.generated / res.wall_seconds} generated/s, "
          f"check {res.wall_seconds} s, call {wall} s, phases {ph}, "
          f"host blocked on the device {ph['sync'] / res.wall_seconds} "
          f"of the check, launches {counts}")
    need(res.pipeline == pipeline, f"the engine ran {res.pipeline}")
    need(res.violation is None and res.deadlock is None,
         "MCraft_bounded reported a violation or deadlock")
    need(res.distinct == MCRAFT_L9_DISTINCT
         and res.generated == MCRAFT_L9_GENERATED
         and res.levels == MCRAFT_L9_LEVELS,
         f"MCraft_bounded L9 ({what}) counts differ from the pinned "
         "oracle")
    need(not res.growth_stalls, "the main path's seen set grew")
    check_launches(pipeline, counts, res.steps, "MCraft_bounded L9",
                   method, inserts=1)
    return counts


def phase_small_table(torch, pipeline, sync_every=32):
    """MCraft_bounded to L6 with a tiny seen-set and queue: the table
    grows by rehashing through the insert kernel, the next-level queue
    spills to the host (both land inside chunks), and the counts still
    equal the pinned ones."""
    from raft_tla_tpu_torch.engine.check import run_check
    cfg = bounded_config(pipeline, 6, batch=32, queue_capacity=1024,
                         seen_capacity=256, sync_every=sync_every)
    reset_counts()
    res = run_check(os.path.join(HERE, "configs/MCraft_bounded.cfg"), cfg,
                    device="cuda")
    counts = read_counts()
    print(f"MCraft_bounded L6 {pipeline} sync_every {sync_every}, tiny "
          f"seen-set and queue: chunks={res.chunks} steps={res.steps} "
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
         f"MCraft_bounded L6 ({pipeline}) with growth and spill differs "
         "from the pinned oracle")
    check_launches(pipeline, counts, res.steps, "MCraft_bounded L6")


def phase_dispatch_sync_free(torch, pipeline, method="fused", events=False):
    """MCraft_bounded to L8 at the main path's sizes and sync_every 32
    with every chunk's dispatch (its queued steps, graph replays, and the
    cond after them) under CUDA sync debug mode "error": a host wait for
    the device inside a chunk raises, so the engine's "sync" phase (the
    one stats read a chunk) holds every wait of the level loop.  With
    ``events`` the run writes its events file as well."""
    from raft_tla_tpu_torch.engine.check import initial_states, make_engine
    from raft_tla_tpu_torch.utils.cfg import load_config
    setup = load_config(os.path.join(HERE, "configs/MCraft_bounded.cfg"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sync_") if events else None
    engine = make_engine(setup, bounded_config(
        pipeline, 8, enqueue_method=method,
        events_out=os.path.join(tmp, "ev.jsonl") if events else None),
        device="cuda")
    what = f"{pipeline} {method} tail" + (", events on" if events else "")
    dispatch, checked = engine._dispatch, []

    def strict(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = dispatch(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        checked.append(args[1])
        return out

    engine._dispatch = strict
    try:
        res = engine.run(initial_states(setup))
        if events:
            from raft_tla_tpu_torch.obs.events import validate_run_events
            n_events = len(validate_run_events(os.path.join(tmp,
                                                            "ev.jsonl")))
            shutil.rmtree(tmp, ignore_errors=True)
            print(f"dispatch sync check with events on: {n_events} events")
    except RuntimeError as e:
        site = [f for f in traceback.extract_tb(e.__traceback__)
                if "raft_tla_tpu_torch" in f.filename]
        where = (f"{os.path.relpath(site[-1].filename, HERE)}:"
                 f"{site[-1].lineno}" if site else "an unknown line")
        raise PhaseFailed(f"a {what} chunk dispatch waited for the "
                          f"device at {where}: {e}")
    print(f"dispatch sync check L8 {what}, sync_every "
          f"{engine.config.sync_every}: {len(checked)} dispatches of "
          f"{sum(checked)} steps ({res.batches} batches, {res.chunks} "
          f"chunks) under sync debug mode 'error', none waited for the "
          f"device; distinct={res.distinct}")
    need(len(checked) >= res.chunks > 0 and sum(checked) >= res.batches,
         "no chunk was dispatched")
    need(res.distinct == MCRAFT_L8_DISTINCT
         and res.levels == MCRAFT_L9_LEVELS[:9],
         f"MCraft_bounded L8 ({what}) differs from the pinned oracle")


def phase_deep(torch, pipeline, method="fused"):
    """MCraft_bounded to L11: the pinned level profile and the pinned
    6,005,282 distinct / 17,354,955 generated (BASELINE.md)."""
    from raft_tla_tpu_torch.engine.check import run_check
    reset_counts()
    res = run_check(os.path.join(HERE, "configs/MCraft_bounded.cfg"),
                    bounded_config(pipeline, 11, enqueue_method=method),
                    device="cuda")
    counts = read_counts()
    ph = res.phases
    what = f"{pipeline} {method} tail"
    print(f"MCraft_bounded L11 {what}: distinct={res.distinct} "
          f"generated={res.generated} levels={res.levels} "
          f"batches={res.batches} spills={res.spills} "
          f"growths={res.growth_stalls}")
    print(f"MCraft_bounded L11 {what}: {res.states_per_second} distinct "
          f"states/s, {res.generated / res.wall_seconds} generated/s, check "
          f"{res.wall_seconds} s, phases {ph}, launches {counts}")
    need(res.levels == MCRAFT_L11_LEVELS
         and res.distinct == MCRAFT_L11_DISTINCT
         and res.generated == MCRAFT_L11_GENERATED,
         f"MCraft_bounded L11 ({what}) differs from the pinned oracle")
    check_launches(pipeline, counts, res.steps, "MCraft_bounded L11",
                   method, inserts=1)
    return res


def phase_profile(torch, pipeline, method="fused", cfg_name=None,
                  config=None, devices=None):
    """Device busy share of a check under torch.profiler (MCraft_bounded
    to L8 at the main path's sizes, or ``cfg_name`` with ``config``; on
    the mesh over ``devices`` where given): the union of the device-side
    intervals over the wall time of the run, device ops a step and a
    batch, and the ops by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from raft_tla_tpu_torch.engine.check import run_check
    cfg_name = cfg_name or "MCraft_bounded.cfg"
    config = config or bounded_config(pipeline, 8, enqueue_method=method)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_check(os.path.join(HERE, "configs", cfg_name), config,
                        device="cuda", devices=devices,
                        engine_cls="mesh" if devices else None)
        torch.cuda.synchronize()
    what = (f"{cfg_name[:-4]} L{config.max_diameter} {pipeline} {method} "
            f"tail, sync_every {config.sync_every}"
            + (f", mesh n={len(devices)}" if devices else ""))
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    if not spans:
        print(f"profile {what}: the profiler saw no device time "
              "(not measured)")
        return
    wall_us = res.wall_seconds * 1e6
    print(f"profile {what} (under torch.profiler): check "
          f"{res.wall_seconds} s, {res.batches} batches, {res.steps} "
          f"steps, {res.chunks} chunks, device busy {busy / 1e6} s = "
          f"{busy / wall_us} of the check, idle {1 - busy / wall_us}, "
          f"{len(spans) / res.steps} device ops a step, "
          f"{len(spans) / res.batches} a batch, device time a batch "
          f"{busy / res.batches} us, host dispatch "
          f"{res.phases['dispatch'] / res.batches} s a batch, phases "
          f"{res.phases}")
    by_name = collections.defaultdict(lambda: [0, 0])
    for e in dev:
        n = by_name[short_name(e.name)]
        n[0] += 1
        n[1] += e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    print(f"profile {what}: device ops by total time, as (name, ops "
          f"a batch, device microseconds a batch): " + ", ".join(
              f"({n}, {c / res.batches}, {us / res.batches})"
              for n, (c, us) in top))


#: The capture run's tensors (``capture_l8``), kept for the phases after.
_L8 = {}


def capture_l8(torch):
    """A split-tail v4 check to L8 at the main path's sizes (its steps
    dispatched eagerly, so the hooks see each call), run once: the
    fullest batch the enqueue kernel is given (``krows``, ``enq``), the
    fullest insert's queries (``keys``, ``kvalid``) and the parent
    windows of the last few batches (``windows``)."""
    if _L8:
        return _L8
    from raft_tla_tpu_torch.engine import chunk as chunk_mod
    from raft_tla_tpu_torch.engine.check import initial_states, make_engine
    from raft_tla_tpu_torch.utils.cfg import load_config
    real_enq, real_ins = chunk_mod.enqueue, chunk_mod.insert
    best_enq, best_ins, windows = [], [], []

    def enqueue(qnext, next_count, krows, enq, max_count=None):
        n = int(enq.sum())
        if not best_enq or n > best_enq[0]:
            best_enq[:] = [n, krows.clone(), enq.clone()]
        return real_enq(qnext, next_count, krows, enq, max_count)

    def insert(seen, keys, valid):
        n = int(valid.sum())
        if not best_ins or n > best_ins[0]:
            best_ins[:] = [n, keys.clone(), valid.clone()]
        return real_ins(seen, keys, valid)

    setup = load_config(os.path.join(HERE, "configs/MCraft_bounded.cfg"))
    engine = make_engine(setup, bounded_config("v4", 8,
                                               enqueue_method="kernel"),
                         device="cuda")
    dispatch_eagerly(engine)
    body = engine._step.body

    def hook(rows, valid, *args):
        if bool(valid.any()):
            windows[:] = windows[-5:] + [(rows.clone(), valid.clone())]
        return body(rows, valid, *args)

    engine._step.body = hook
    chunk_mod.enqueue, chunk_mod.insert = enqueue, insert
    try:
        res = engine.run(initial_states(setup))
    finally:
        chunk_mod.enqueue, chunk_mod.insert = real_enq, real_ins
    need(res.distinct == MCRAFT_L8_DISTINCT and best_enq and best_ins
         and windows,
         "the capture run of the split tail differs from the pinned oracle")
    _L8.update(krows=best_enq[1], enq=best_enq[2], keys=best_ins[1],
               kvalid=best_ins[2], windows=windows)
    return _L8


def capture_enqueue_batch(torch):
    """``(krows, enq)`` of the fullest batch of ``capture_l8``'s run: what
    the enqueue kernel is given there."""
    c = capture_l8(torch)
    return c["krows"], c["enq"]


def enqueue_traps(torch, gen, device, rand_rows):
    """The masks phase_enqueue holds the kernel on at K lanes of 473-byte
    rows, beyond the real batch: ``[(name, rows, enq)]``."""
    lanes = torch.arange(K, device=device)
    cross = torch.zeros(K, dtype=torch.bool, device=device)
    for edge in range(64, K, 64):     # a run across each tile edge
        cross[edge - 1 - edge % 5:edge + 3 + (edge // 64) % 40] = True
    # Flags past a 16-byte boundary of an allocation: the wrapper clones.
    shifted = torch.zeros(K + 1, dtype=torch.bool, device=device)
    shifted[1:] = torch.rand(K, generator=gen, device=device) < 0.3
    need(shifted[1:].data_ptr() % 16 == 1, "the flags view is aligned")
    return [("empty", rand_rows, lanes < 0),
            ("full", rand_rows, lanes >= 0),
            ("alternating", rand_rows, lanes % 2 == 1),
            ("runs across tile edges", rand_rows, cross),
            ("one flag in each tile's last lane", rand_rows,
             lanes % 64 == 63),
            ("an unaligned flags view", rand_rows, shifted[1:]),
            ("1,000 lanes", rand_rows[:1000],
             torch.rand(1000, generator=gen, device=device) < 0.3)]


def held_enqueue(torch, name, qa, qb, next_count, rows, enq):
    """The enqueue kernel against ``enqueue_plain`` on the two queues ``qa``
    / ``qb`` (equal before): the WHOLE queue and the count equal.  The
    kernel reads ``next_count`` from the card, written by the launch just
    before.  Returns max_abs_err."""
    from raft_tla_tpu_torch.ops import enqueue as enq_mod
    from raft_tla_tpu_torch.ops import enqueue_cuda
    cnt_k = enqueue_cuda.enqueue(
        qa, device_count(torch, next_count, rows.device), rows, enq,
        next_count)
    cnt_p = enq_mod.enqueue_plain(qb, next_count, rows, enq)
    torch.cuda.synchronize()
    equal = bool(torch.equal(qa, qb))
    err = max_abs(torch, [(cnt_k, cnt_p)])
    n_enq = int(cnt_k) - next_count
    print(f"enqueue {name}: {rows.shape[0]} lanes of {rows.shape[1]} B, "
          f"enqueued={n_enq} at {next_count} of {qa.shape[0]} rows, "
          f"queue_equal={equal} max_abs_err={err}")
    need(err == 0.0 and equal and n_enq == int(enq.sum()),
         f"enqueue differs from its plain version on {name}")
    return err


def phase_enqueue(torch, device, gen):
    """The enqueue kernel against ``enqueue_plain``, exactly (whole queue
    and count): at K lanes of 473-byte rows into the main path's queue at
    a non-zero ``next_count`` on the rows and mask of a real L8 batch and
    on the masks of ``enqueue_traps``; all K lanes with the last live row
    on the queue's last row; rows of 403, 679 and 951 bytes (a tile staged
    in one, two and two turns), of 30,704 bytes and of the widest the
    stage takes (a turn a row), and of 5 bytes.  Timed on the real batch
    and on the full mask."""
    from raft_tla_tpu_torch.models.dims import RaftDims
    from raft_tla_tpu_torch.models.schema import state_width
    from raft_tla_tpu_torch.ops import enqueue as enq_mod
    from raft_tla_tpu_torch.ops import enqueue_cuda
    from raft_tla_tpu_torch.utils.cfg import load_config
    krows, real = capture_enqueue_batch(torch)
    sw = krows.shape[1]
    need(krows.shape == (K, sw) and sw == 473, f"captured rows {krows.shape}")
    rand_rows = torch.randint(0, 256, (K, sw), generator=gen, device=device,
                              dtype=torch.uint8)
    next_count = NEXT_COUNT
    qa = torch.randint(0, 256, (QUEUE + K, sw), generator=gen, device=device,
                       dtype=torch.uint8)
    qb = qa.clone()
    err = held_enqueue(torch, "real L8 batch", qa, qb, next_count, krows,
                       real)
    for name, rows, enq in enqueue_traps(torch, gen, device, rand_rows):
        err = max(err, held_enqueue(torch, name, qa, qb, next_count, rows,
                                    enq))
    all_lanes = torch.ones(K, dtype=torch.bool, device=device)
    err = max(err, held_enqueue(
        torch, "all lanes, the last live row on the queue's last row", qa,
        qb, QUEUE, rand_rows, all_lanes))
    # Two calls chained as in a chunk: the second reads, as its count,
    # the count the first one's last launch wrote on the card.
    lanes = torch.arange(K, device=device)
    e1, e2 = lanes % 3 == 0, lanes % 5 == 1
    c1 = enqueue_cuda.enqueue(qa, device_count(torch, next_count, device),
                              rand_rows, e1, next_count)
    c2 = enqueue_cuda.enqueue(qa, c1.view(1), rand_rows, e2, next_count + K)
    p2 = enq_mod.enqueue_plain(qb, enq_mod.enqueue_plain(
        qb, next_count, rand_rows, e1), rand_rows, e2)
    torch.cuda.synchronize()
    e = max_abs(torch, [(c2, p2)])
    equal = bool(torch.equal(qa, qb))
    print(f"enqueue chained (the count the launch before wrote): "
          f"{int(c2) - next_count} rows, queue_equal={equal} "
          f"max_abs_err={e}")
    need(e == 0.0 and equal, "two chained enqueues differ from the plain "
         "version")
    err = max(err, e)
    del qb
    # Other widths: MCraft_noleader (403), raft5_bounded (679: 45 rows a
    # stage turn), TPUraft (951: 33 a turn), 30,704 and the widest (a turn
    # a row), and 5 bytes (a 16-byte line spans several runs).
    _tile, widest = enqueue_cuda.geometry()
    widths = [state_width(RaftDims(n_servers=3, n_values=2, max_log=2,
                                   n_msg_slots=32))]
    widths += [state_width(load_config(os.path.join(HERE, f"configs/{c}"))
                           .dims) for c in ("raft5_bounded.cfg",
                                            "TPUraft.cfg")]
    need(widths == [403, 679, 951], f"row widths {widths}")
    for w, n in ([(w, K) for w in widths + [5]]
                 + [(30704, 1000), (widest, 1000)]):
        rw = torch.randint(0, 256, (n, w), generator=gen, device=device,
                           dtype=torch.uint8)
        wa = torch.randint(0, 256, (4096 + n, w), generator=gen,
                           device=device, dtype=torch.uint8)
        wb = wa.clone()
        enq = torch.rand(n, generator=gen, device=device) < 0.5
        err = max(err, held_enqueue(torch, f"rows of {w} B", wa, wb, 777,
                                    rw, enq))
        del rw, wa, wb
    n_enq = int(real.sum())
    need(n_enq > 0, "the captured batch enqueued nothing")

    nc = device_count(torch, next_count, device)

    def kernel():
        enqueue_cuda.enqueue(qa, nc, krows, real, next_count)

    def kernel_full():
        enqueue_cuda.enqueue(qa, nc, rand_rows, all_lanes, next_count)

    def scatter():
        enq_mod.enqueue_scatter(qa, nc, krows, real, QUEUE)

    def window():
        enq_mod.enqueue_window(qa, nc, krows, real)

    # One wrapper call between two events is mostly the host's launch path
    # at this size, so the kernel and the lowerings (none waits for the
    # device) are also timed queued back to back; the profiler's figure
    # stands beside.
    ms = cuda_ms(torch, kernel, 50)
    queued = queued_ms(torch, kernel)
    full_ms = queued_ms(torch, kernel_full) or cuda_ms(torch, kernel_full,
                                                       20)
    # The one-call library form: index_copy_ of all K rows, the others to
    # their trash rows (the "scatter" lowering); "window" beside it.
    library_ms = cuda_ms(torch, scatter, 50)
    library_queued = queued_ms(torch, scatter)
    window_ms = queued_ms(torch, window) or cuda_ms(torch, window, 20)
    plain_ms = cuda_ms(torch, lambda: enq_mod.enqueue_plain(
        qa, next_count, krows, real), 10)
    launch_check(torch, "enqueue", kernel, enqueue_cuda.KERNELS)
    full_us = device_ops(torch, kernel_full)
    # The mask once, each enqueued row read once and written once, the count.
    nbytes = K + 2 * n_enq * sw + 4
    full_bytes = K + 2 * K * sw + 4
    row = dict(name="enqueue", route="cuda",
               source="raft_tla_tpu_torch/csrc/enqueue.cu",
               headers=["enqueue.cuh", "common.cuh"],
               replaces="raft_tla_tpu/ops/enqueue_pallas.py:98",
               max_abs_err=err, ms=ms, queued_ms=queued, plain_ms=plain_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=library_ms)
    print(f"enqueue K={K} rows of {sw} B, {n_enq} enqueued, into a "
          f"{QUEUE + K}-row queue, queued back to back: kernel {queued} ms "
          f"(full mask {full_ms} ms, bound "
          f"{full_bytes / HBM_BYTES_PER_S * 1e3} ms), index_copy_ with "
          f"trash rows {library_queued} ms, window lowering {window_ms} ms; "
          f"one call between two events: kernel {ms} ms, index_copy_ with "
          f"trash rows {library_ms} ms, plain {plain_ms} ms; "
          f"bound {row['bound_ms']} ms ({nbytes} bytes); device "
          f"microseconds of the full mask's launches under the profiler "
          f"{full_us or 'not measured'}")
    print(f"enqueue launches at K={K}: {enqueue_cuda.launch_info(K)}")
    del qa
    return row


#: ``--enqueue-variants``: the designs B5 was measured against, and steps
#: of the built one left out, each a list of (source in
#: raft_tla_tpu_torch/csrc, text, replacement); a text of None replaces
#: the whole file, a (start, end) pair the text from start up to end.
_FIRST_ENQUEUE = r"""#include "common.cuh"
namespace {
constexpr int kThreads = 256, kWarps = kThreads / 32, kTile = 64;
__device__ __forceinline__ void copy_row(const uint8_t* __restrict__ src,
                                         uint8_t* __restrict__ out, int sw,
                                         int lane) {
  const int head = min(sw, (int)((4 - ((uintptr_t)out & 3)) & 3));
  if (lane < head) out[lane] = src[lane];
  const int words = (sw - head) >> 2;
  const uint8_t* s = src + head;
  uint32_t* o = (uint32_t*)(out + head);
#pragma unroll 4
  for (int w = lane; w < words; w += 32) {
    const uint8_t* p = s + 4 * w;
    o[w] = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
  }
  const int done = head + 4 * words;
  if (lane < sw - done) out[done + lane] = src[done + lane];
}
__global__ void __launch_bounds__(kThreads)
enqueue_kernel(const uint8_t* __restrict__ enq, int n,
               const uint8_t* __restrict__ krows, int sw,
               uint8_t* __restrict__ qnext, const int* next_count_p,
               int* __restrict__ count_out) {
  const long long next_count = __ldcg(next_count_p);
  __shared__ int scratch[32];
  __shared__ int src_lane[kTile];
  const int t0 = blockIdx.x * kTile;
  int mine = 0;
  const uint4* v = (const uint4*)enq;
  for (int i = threadIdx.x; i < t0 / 16; i += kThreads) {
    const uint4 w = v[i];
    mine += __popc(__vsetne4(w.x, 0u)) + __popc(__vsetne4(w.y, 0u)) +
            __popc(__vsetne4(w.z, 0u)) + __popc(__vsetne4(w.w, 0u));
  }
  int before;
  rtt::block_exclusive_scan(mine, &before, scratch);
  const int l = t0 + threadIdx.x;
  const int flag = (threadIdx.x < kTile && l < n && enq[l]) ? 1 : 0;
  int tile_total;
  const int rank = rtt::block_exclusive_scan(flag, &tile_total, scratch);
  if (flag) src_lane[rank] = l;
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x == gridDim.x - 1)
    count_out[0] = (int)(next_count + before + tile_total);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t first = (size_t)(next_count + before);
  for (int r = warp; r < tile_total; r += kWarps)
    copy_row(krows + (size_t)src_lane[r] * sw, qnext + (first + r) * sw, sw,
             lane);
}
}  // namespace
extern "C" int enqueue_launch(const void* enq, int n, const void* krows,
                              int sw, void* qnext, const void* next_count,
                              void* tile_count, void* count_out,
                              void* stream) {
  const int blocks = n > 0 ? (n + kTile - 1) / kTile : 1;
  enqueue_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)enq, n, (const uint8_t*)krows, sw, (uint8_t*)qnext,
      (const int*)next_count, (int*)count_out);
  return (int)cudaGetLastError();
}
"""

_LOOKBACK_ENQUEUE = r"""#include "enqueue.cuh"
namespace {
enum : unsigned { kAgg = 1u << 30, kIncl = 2u << 30, kVal = kAgg - 1 };
// Tiles by ticket (count_out counts them out, so a tile's predecessors
// are running), each publishing its flag count, then its inclusive
// prefix; warp 0 looks back 32 tiles at a time while the copies fly.
__global__ void __launch_bounds__(rtt::kCopyThreads)
enqueue_lookback_kernel(const uint8_t* __restrict__ enq, int n,
                        const uint8_t* __restrict__ krows, int sw,
                        uint8_t* __restrict__ qnext, const int* next_count_p,
                        unsigned* status, int* count_out) {
  const long long next_count = __ldcg(next_count_p);
  __shared__ __align__(16) rtt::TileStage st;
  __shared__ int tile, before;
  if (threadIdx.x == 0) {
    rtt::stage_init(st);
    tile = atomicAdd(count_out, 1);
  }
  __syncthreads();
  const int t = tile;
  const int t0 = t * rtt::kCopyTile;
  const unsigned long long f = rtt::tile_flags<true>(enq, nullptr, t0, n);
  const int total = __popcll(f);
  const uint8_t* kend = krows + (size_t)n * sw;
  const int per = rtt::turn_rows(sw);
  int rows = min(per, total);
  rtt::stage_issue(krows, kend, sw, t0, f, 0, rows, st);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    volatile unsigned* vs = status;
    if (lane == 0) vs[t] = (t ? kAgg : kIncl) | (unsigned)total;
    int sum = 0;
    for (int p = t - 1; p >= 0; p -= 32) {
      const int i = p - lane;
      unsigned s = i >= 0 ? (unsigned)vs[i] : (unsigned)kIncl;
      while (__any_sync(0xffffffffu, (s & (kAgg | kIncl)) == 0))
        if ((s & (kAgg | kIncl)) == 0) s = vs[i];
      const unsigned incl = __ballot_sync(0xffffffffu, s & kIncl);
      const int stop = incl ? __ffs(incl) - 1 : 31;
      int v = lane <= stop ? (int)(s & kVal) : 0;
      for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      sum += v;
      if (incl) break;
    }
    if (lane == 0) {
      if (t) vs[t] = kIncl | (unsigned)(sum + total);
      before = sum;
    }
  }
  __syncthreads();
  const long long first = next_count + before;
  for (int r0 = 0, turn = 0;; ++turn) {
    rtt::stage_wait(st, turn);
    rtt::store_turn(st, qnext + (first + r0) * (long long)sw, rows, sw);
    r0 += rows;
    if (r0 >= total) break;
    __syncthreads();
    rows = min(per, total - r0);
    rtt::stage_issue(krows, kend, sw, t0, f, r0, rows, st);
  }
  if (threadIdx.x == 0 && t == (int)gridDim.x - 1)
    count_out[0] = (int)(first + total);
}
}  // namespace
extern "C" int enqueue_launch(const void* enq, int n, const void* krows,
                              int sw, void* qnext, const void* next_count,
                              void* tile_count, void* count_out,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = rtt::copy_tiles(n);
  cudaError_t e = cudaMemsetAsync(tile_count, 0, sizeof(int) * tiles, s);
  if (e == cudaSuccess) e = cudaMemsetAsync(count_out, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  enqueue_lookback_kernel<<<tiles, rtt::kCopyThreads, 0, s>>>(
      (const uint8_t*)enq, n, (const uint8_t*)krows, sw, (uint8_t*)qnext,
      (const int*)next_count, (unsigned*)tile_count, (int*)count_out);
  return (int)cudaGetLastError();
}
"""

_WORD_GATHER = r"""// The stage packed as the span is (row r of the turn at byte r * sw): a
// thread builds 16-byte lines of it from the two aligned 16-byte loads
// covering each in its source row (four where it straddles two rows),
// two lines' loads issued together; bytes where a load would leave the
// tensor.  No copy is left in flight, so the mbarrier goes unused.
__device__ __forceinline__ void stage_init(TileStage&) {}

__device__ __forceinline__ unsigned long long drop_low(unsigned long long x,
                                                       int k) {
  for (; k > 0 && x; --k) x &= x - 1;
  return x;
}

__device__ __forceinline__ unsigned long long below(int i) {
  return i ? ~0ull >> (64 - i) : 0ull;
}

__device__ __forceinline__ void load_line(const uint8_t* p,
                                          const uint8_t* lo,
                                          const uint8_t* hi, uint4* a,
                                          uint4* b) {
  const uint8_t* al = line_of(p, 0);
  if (al >= lo && al + 32 <= hi) {
    *a = *reinterpret_cast<const uint4*>(al);
    *b = *reinterpret_cast<const uint4*>(al + 16);
    return;
  }
  uint32_t w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint8_t* q = al + j;
    if (q >= lo && q < hi) w[j >> 2] |= (uint32_t)*q << (8 * (j & 3));
  }
  *a = make_uint4(w[0], w[1], w[2], w[3]);
  *b = make_uint4(w[4], w[5], w[6], w[7]);
}

__device__ __forceinline__ void stage_issue(const uint8_t* __restrict__ krows,
                                            const uint8_t* kend, int sw,
                                            int t0, unsigned long long f,
                                            int r0, int rows, TileStage& st) {
  unsigned long long turn = drop_low(f, r0);
  if (rows < __popcll(turn)) turn &= ~drop_low(turn, rows);
  const int i = threadIdx.x;
  int* lanes = st.row_off;  // the turn's lanes by row
  if (i < kCopyTile && ((turn >> i) & 1))
    lanes[__popcll(turn & below(i))] = t0 + i;
  __syncthreads();
  const int len = rows * sw;
  uint8_t* stage = st.bytes;
  if (sw < 16) {
    for (int k = threadIdx.x; k < len; k += kCopyThreads) {
      const int r = k / sw;
      stage[k] = krows[(size_t)lanes[r] * sw + (k - r * sw)];
    }
    return;
  }
  const int lines = (len + 15) >> 4;
  uint4* out = reinterpret_cast<uint4*>(stage);
  for (int c0 = threadIdx.x; c0 < lines; c0 += 2 * kCopyThreads) {
    uint4 a[2], b[2], c[2], d[2];
    int sh[2], sh2[2], m[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int line = c0 + u * kCopyThreads;
      m[u] = 16;
      if (line >= lines) continue;
      const int k = 16 * line;
      const int r = k / sw;
      const int in_row = k - r * sw;
      const uint8_t* p = krows + (size_t)lanes[r] * sw + in_row;
      sh[u] = (int)(reinterpret_cast<uintptr_t>(p) & 15);
      load_line(p, krows, kend, &a[u], &b[u]);
      if (sw - in_row < 16 && r + 1 < rows) {
        m[u] = sw - in_row;
        const uint8_t* q = krows + (size_t)lanes[r + 1] * sw - m[u];
        sh2[u] = (int)(reinterpret_cast<uintptr_t>(q) & 15);
        load_line(q, krows, kend, &c[u], &d[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int line = c0 + u * kCopyThreads;
      if (line >= lines) continue;
      uint4 v = extract16(a[u], b[u], sh[u]);
      if (m[u] < 16) v = blend16(v, extract16(c[u], d[u], sh2[u]), m[u]);
      out[line] = v;
    }
  }
}

__device__ __forceinline__ void stage_wait(TileStage&, int) {
  __syncthreads();
}

__device__ __forceinline__ void store_turn(const TileStage& st,
                                           uint8_t* __restrict__ dst,
                                           int rows, int sw) {
  const int t = threadIdx.x;
  const int len = rows * sw;
  const uint8_t* stage = st.bytes;
  const int head = min(len, (int)((16 - (reinterpret_cast<uintptr_t>(dst) &
                                         15)) & 15));
  if (t < head) dst[t] = stage[t];
  const int vecs = (len - head) >> 4;
  const uint4* s = reinterpret_cast<const uint4*>(stage);
  uint4* d = reinterpret_cast<uint4*>(dst + head);
  for (int i = t; i < vecs; i += kCopyThreads)
    d[i] = extract16(s[i], s[i + 1], head);
  const int done = head + 16 * vecs;
  if (t < len - done) dst[done + t] = stage[done + t];
}

"""

_STORE_TURN = ("    store_turn(st, qnext + (first + r0) * (long long)sw, rows, "
               "sw);\n")
ENQUEUE_VARIANTS = [
    ("as built", []),
    ("the first design: one launch, every block re-counting the flags "
     "before its tile, a warp a row", [("enqueue.cu", None,
                                        _FIRST_ENQUEUE)]),
    ("decoupled look-back: one launch after two memsets, tiles by ticket",
     [("enqueue.cu", None, _LOOKBACK_ENQUEUE)]),
    ("the copies after the wait", [
        ("enqueue.cuh", "  if (!kSplit) grid_dependency_wait();\n",
         "  grid_dependency_wait();\n"),
        ("enqueue.cuh", "  if (kSplit) grid_dependency_wait();\n", "")]),
    ("the tile launch no programmatic dependent", [
        ("enqueue.cu", "rtt::kCopyThreads, s, true,",
         "rtt::kCopyThreads, s, false,")]),
    ("the count launch no programmatic dependent", [
        ("enqueue.cu", "  rtt::grid_dependency_wait();\n  rtt::launch_dependents();\n",
         "  rtt::launch_dependents();\n"),
        ("enqueue.cu", "kCountThreads, s, true,", "kCountThreads, s, false,")]),
    ("(time only) no stores", [
        ("enqueue.cuh", _STORE_TURN, "")]),
    ("(time only) no copies, no stores", [
        ("enqueue.cuh", _STORE_TURN, ""),
        ("enqueue.cuh", "      bytes = (int)(c1 - c0);", "      bytes = 0;")]),
    ("(time only) the stores without the funnel shifts", [
        ("enqueue.cuh", ("    const int k = head + 16 * i;  // the line's first",
                         "    d[i] = v;"),
         "    uint4 v = reinterpret_cast<const uint4*>(st.bytes)[i];\n")]),
    ("(time only) the tile launch returns at once", [
        ("enqueue.cuh", "  if (threadIdx.x == 0) stage_init(st);\n",
         "  if (kSplit) return;\n  if (threadIdx.x == 0) stage_init(st);\n")]),
    ("128 threads a tile block", [
        ("enqueue.cuh", "constexpr int kCopyThreads = 256;",
         "constexpr int kCopyThreads = 128;")]),
    ("16-byte loads through registers into a packed stage", [
        ("enqueue.cuh", "  return (kStageBytes - 64) / (sw + 32);",
         "  return (kStageBytes - 16) / sw;"),
        ("enqueue.cuh", ("// The tile block's mbarrier",
                         "// The tile's flags as a mask"), _WORD_GATHER)]),
]


def enqueue_variants(torch, device):
    """``python3 chip_smoke.py --enqueue-variants``: the split tail's
    enqueue built from each of ENQUEUE_VARIANTS, each held exactly against
    its plain version (whole queue and count) on the real L8 batch, the
    trap masks of phase_enqueue and all K lanes at the queue's end, and
    timed queued back to back on the real batch and on the full mask, with
    its launches' device microseconds under the profiler.  A variant
    named "(time only)" leaves a step out to attribute time: it is timed
    though it is not exact (each writes inside the queue or not at all).
    The built design runs first and last.  Not part of the smoke run."""
    import ctypes
    from raft_tla_tpu_torch.ops import enqueue_cuda
    krows, real = capture_enqueue_batch(torch)
    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    sw = krows.shape[1]
    rand_rows = torch.randint(0, 256, (K, sw), generator=gen, device=device,
                              dtype=torch.uint8)
    full = torch.ones(K, dtype=torch.bool, device=device)
    qa = torch.randint(0, 256, (QUEUE + K, sw), generator=gen, device=device,
                       dtype=torch.uint8)
    qb = qa.clone()
    enqueue_cuda.geometry()
    real_lib = enqueue_cuda._lib
    argtypes = real_lib().enqueue_launch.argtypes
    tmp = tempfile.mkdtemp(prefix="chip_smoke_enqueue_")
    try:
        procs = [(name, src, so, proc)
                 for v, (name, subs) in enumerate(ENQUEUE_VARIANTS)
                 for src, so, proc in build_variant(tmp, v, subs,
                                                    ("enqueue",))]
        built = {}
        for name, src, so, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                print(f"enqueue variant {name}: nvcc {src}.cu failed: "
                      f"{log[-1500:]}")
            else:
                built[name] = so
                print(f"enqueue variant {name}: {ptxas_summary(log)}")
        for name, _subs in ENQUEUE_VARIANTS + ENQUEUE_VARIANTS[:1]:
            if name not in built:
                continue
            lib = ctypes.CDLL(built[name])
            lib.enqueue_launch.restype = ctypes.c_int
            lib.enqueue_launch.argtypes = argtypes
            enqueue_cuda._lib = lambda lib=lib: lib
            try:
                err = held_enqueue(torch, f"{name}: real L8 batch", qa, qb,
                                   NEXT_COUNT, krows, real)
                for case, rows, enq in enqueue_traps(torch, gen, device,
                                                     rand_rows):
                    err = max(err, held_enqueue(
                        torch, f"{name}: {case}", qa, qb, NEXT_COUNT, rows,
                        enq))
                err = max(err, held_enqueue(
                    torch, f"{name}: all lanes at the queue's end", qa, qb,
                    QUEUE, rand_rows, full))
            except PhaseFailed as e:
                print(f"enqueue variant {name}: {e}")
                qb.copy_(qa)
                if not name.startswith("(time only)"):
                    continue
            times = {}
            for what, rows, enq in (("real L8 batch", krows, real),
                                    ("full mask", rand_rows, full)):
                nc = device_count(torch, NEXT_COUNT, device)

                def call(rows=rows, enq=enq, nc=nc):
                    enqueue_cuda.enqueue(qa, nc, rows, enq, NEXT_COUNT)
                times[what] = (queued_ms(torch, call),
                               [us for _n, us in device_ops(torch, call)])
            qb.copy_(qa)
            print(f"enqueue variant {name}: queued back to back, real L8 "
                  f"batch {times['real L8 batch'][0]} ms, full mask "
                  f"{times['full mask'][0]} ms; device microseconds of the "
                  f"call's operations: real batch "
                  f"{times['real L8 batch'][1] or 'not measured'}, full "
                  f"mask {times['full mask'][1] or 'not measured'}; "
                  f"max_abs_err {err}")
    finally:
        enqueue_cuda._lib = real_lib
        shutil.rmtree(tmp, ignore_errors=True)


#: ``--front-variants``: (name, [(text in csrc/chunk_front.cu, its
#: replacement)]).  The last two only attribute time: they skip a phase.
FRONT_VARIANTS = [
    ("as built", []),
    ("lanes without a minimum of blocks an SM", [(
        "__launch_bounds__(kThreads, 4)\nlanes_kernel(",
        "__launch_bounds__(kThreads)\nlanes_kernel(")]),
    ("lanes in their own order", [(
        "    const int l = t < nl ? order[t] : -1;",
        "    const int l = t < nl ? t : -1;")]),
    ("no successors (timing only)", [(
        "for (int r = t_lo + warp; r < t_hi; r += kWarps) {",
        "for (int r = t_lo + warp; r < 0; r += kWarps) {")]),
    ("no predicates (timing only)", [
        ("const bool cons = rtt::bounded_space_warp(st, bounds, lane);",
         "const bool cons = true;"),
        ("rtt::first_failing_warp<kSuite, kReconfig>(st, inv_list, n_inv, "
         "lane);", "-1;")]),
    ("no row stores (timing only)", [(
        "for (int c = c_lo + lane; c < c_hi; c += 32)",
        "for (int c = c_lo + lane; c < 0; c += 32)")]),
    ("no scalars (timing only)", [(
        "      lane_edits<kReconfig>(d, k, St{d, pv}, lg[l],",
        "      if (false) lane_edits<kReconfig>(d, k, St{d, pv}, lg[l],")]),
]


def front_variants(torch, device):
    """``python3 chip_smoke.py --front-variants``: the front's launches'
    device microseconds (profiler, five samples each) and its queued time
    on the progress-limited main-path window, for variants of
    ``csrc/chunk_front.cu`` built with the substitutions of
    FRONT_VARIANTS.  Not part of the smoke run."""
    import ctypes
    from raft_tla_tpu_torch.ops import chunk_front_cuda
    from raft_tla_tpu_torch.utils import build
    _setup, _v2, kw, windows = front_rig(torch, device)
    rows, valid = [w for w in windows if bool(w[1].all())][-1]
    front = chunk_front_cuda.Front(**kw)
    want = front.plain(rows, valid)
    src = (build.CSRC / "chunk_front.cu").read_text()
    argtypes = chunk_front_cuda._lib().chunk_front_launch.argtypes
    tmp = tempfile.mkdtemp(prefix="chip_smoke_front_")
    real_lib = chunk_front_cuda._lib
    try:
        procs = []
        for n, (name, subs) in enumerate(FRONT_VARIANTS):
            text = src
            for old, new in subs:
                need(old in text, f"csrc/chunk_front.cu lost {old!r}")
                text = text.replace(old, new)
            cu = os.path.join(tmp, f"front{n}.cu")
            with open(cu, "w") as f:
                f.write(text)
            so = os.path.join(tmp, f"libfront{n}.so")
            procs.append((name, so, subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                 "-o", so, cu])))
        for name, so, proc in procs:
            need(proc.wait() == 0, f"nvcc failed on the {name} variant")
        for name, so, _proc in procs + procs[:1]:
            lib = ctypes.CDLL(so)
            lib.chunk_front_launch.restype = ctypes.c_int
            lib.chunk_front_launch.argtypes = argtypes
            chunk_front_cuda._lib = lambda lib=lib: lib
            err = front_err(torch, front(rows, valid), want)
            us = [device_ops(torch, lambda: front(rows, valid))
                  for _ in range(5)]
            by = {k: sorted(dict(u)[k] for u in us) for k in dict(us[0])}
            info = lib.chunk_front_kernel_info
            out = (ctypes.c_int * len(build.INFO_KEYS))()
            info.restype = ctypes.c_int
            info.argtypes = [ctypes.c_int] * 8 + [
                ctypes.POINTER(ctypes.c_int)]
            d = kw["dims"]
            build.check(info(2, d.n_servers, d.n_values, d.max_log,
                             d.n_msg_slots, 0, B, K, out), "kernel_info")
            print(f"front variant {name}: lanes launch "
                  f"{dict(zip(build.INFO_KEYS, out))}")
            print(f"front variant {name}: max_abs_err {err}, queued "
                  f"{queued_ms(torch, lambda: front(rows, valid))} ms, "
                  f"device microseconds {by}")
    finally:
        chunk_front_cuda._lib = real_lib
        shutil.rmtree(tmp, ignore_errors=True)


#: ``--tail-variants``: the insert designs measured against the built one,
#: as (name, [(file in csrc/, text in it, its replacement)]), applied in order
#: to a copy of the sources.  (b) folds ``own`` into the claim: a lane that
#: meets an empty slot reserves its owner word (CAS NO_OWNER -> lane) and
#: only then, after a fence, publishes its key; a lane that finds its key
#: where the owner word is set takes atomicMin there; a lane that loses
#: the reservation of an empty slot waits for the winner's key (safe under
#: independent thread scheduling: the winner is resident and needs only
#: its fence and one store).  (c) runs (b)'s two passes as one cooperative
#: launch sized to the resident grid, a grid barrier between them.
_PAIRED_PROBES = """  for (uint32_t r = 0; r < kProbeRounds; r += 2) {
    const uint32_t i0 = (h1 + r * h2) & cmask;
    const uint32_t i1 = (h1 + (r + 1) * h2) & cmask;
    const unsigned long long c0 = ld_relaxed(&table[i0]);
    const unsigned long long c1 = ld_relaxed(&table[i1]);
    if (probe_slot(i0, c0, key, l, table, owner, &slot)) break;
    if (probe_slot(i1, c1, key, l, table, owner, &slot)) break;
  }"""
_ONE_PROBE = """  for (uint32_t r = 0; r < kProbeRounds; ++r) {
    const uint32_t i = (h1 + r * h2) & cmask;
    if (probe_slot(i, ld_relaxed(&table[i]), key, l, table, owner, &slot))
      break;
  }"""
_CAS_CLAIM = """  if (cur == kEmpty) {
    cur = atomicCAS(&table[idx], kEmpty, key);
    if (cur == kEmpty) {
      owner[idx] = l;
      *slot = (int)idx;
      return true;
    }
  }
  if (cur == key) *slot = (int)idx;
  return cur == key;"""
_RESERVE_CLAIM = """  if (cur == kEmpty) {
    if (atomicCAS(&owner[idx], kNoOwner, l) == kNoOwner) {
      asm volatile("fence.acq_rel.gpu;" ::: "memory");
      asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
                   :: "l"(&table[idx]), "l"(key) : "memory");
      *slot = (int)idx;
      return true;
    }
    while ((cur = ld_relaxed(&table[idx])) == kEmpty) __nanosleep(32);
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    if (cur != key) return false;
    *slot = (int)idx;
    atomicMin(&owner[idx], l);
    return true;
  }
  if (cur != key) return false;
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
  *slot = (int)idx;
  int o;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
               : "=r"(o) : "l"(&owner[idx]) : "memory");
  if (o != kNoOwner) atomicMin(&owner[idx], l);
  return true;"""
_OWN_LAUNCH = """  e = launch(own_kernel, blocks, kInsertThreads, stream, true,
             (const int*)sp, n, op);
  if (e != cudaSuccess) return e;
"""
_CLAIM_LAUNCH = """  cudaError_t e = launch(probe_claim_kernel, blocks, kInsertThreads, stream,
                         false, qp, vp, n, tp, cmask, op, sp, fp);
  if (e != cudaSuccess) return e;
"""
_COOP_LAUNCH = """  void* args[] = {&qp, &vp, &n, &tp, (void*)&cmask, &op, &sp, &np, &zp,
                  &fp, &ep, &cp};
  cudaError_t e = cudaLaunchCooperativeKernel(
      tile_count ? (const void*)insert_coop_kernel<true>
                 : (const void*)insert_coop_kernel<false>,
      coop_blocks(n), kInsertThreads, args, 0, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
"""
_COOP_KERNEL = """template <bool kTiles>
__global__ void __launch_bounds__(kInsertThreads)
insert_coop_kernel(const unsigned long long* __restrict__ q,
                   const uint8_t* __restrict__ valid, int n,
                   unsigned long long* table, uint32_t cmask, int* owner,
                   int* slot, uint8_t* __restrict__ is_new,
                   unsigned long long* size, uint8_t* fail,
                   const uint8_t* __restrict__ enq_ok,
                   int* __restrict__ tile_count) {
  __shared__ int smem[kInsertThreads / 32];
  if (blockIdx.x == 0 && threadIdx.x == 0) *fail = 0;
  const int stride = gridDim.x * kInsertThreads;
  for (int l0 = blockIdx.x * kInsertThreads; l0 < n; l0 += stride)
    claim_lane(l0 + threadIdx.x, n, q, valid, table, cmask, owner, slot);
  cooperative_groups::this_grid().sync();
  launch_dependents();
  for (int l0 = blockIdx.x * kInsertThreads; l0 < n; l0 += stride)
    resolve_block<kTiles>(l0, n, slot, owner, is_new, size, fail, enq_ok,
                          tile_count, smem);
}

inline int coop_blocks(int n) {
  static int resident = 0;
  if (!resident) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, insert_coop_kernel<true>, kInsertThreads, 0);
    resident = sms * per_sm;
  }
  const int need = (n + kInsertThreads - 1) / kInsertThreads;
  return need < 1 ? 1 : (need < resident ? need : resident);
}

"""
_RESERVE = [("fpset.cuh", _CAS_CLAIM, _RESERVE_CLAIM),
            ("fpset.cuh", _OWN_LAUNCH, "")]
TAIL_VARIANTS = [
    ("as built", []),
    ("no programmatic dependent launch", [
        ("fpset.cuh", "stream, true,", "stream, false,"),
        ("fused_tail.cu", "s, true,", "s, false,")]),
    ("one probe at a time", [("fpset.cuh", _PAIRED_PROBES, _ONE_PROBE)]),
    ("(b) own folded into the claim (reserve, then publish)", _RESERVE),
    ("(c) one cooperative launch", _RESERVE + [
        ("fpset.cuh", '#include "common.cuh"',
         '#include <cooperative_groups.h>\n\n#include "common.cuh"'),
        ("fpset.cuh", "// Blocks of one insert pass:",
         _COOP_KERNEL + "// Blocks of one insert pass:"),
        ("fpset.cuh", _CLAIM_LAUNCH, _COOP_LAUNCH)]),
]


def substitute(text, name, old, new):
    """``text`` of csrc/``name`` with ``old`` replaced by ``new``: all of
    it where ``old`` is None, the text from ``old[0]`` up to ``old[1]``
    where it is a pair, else each occurrence of ``old``."""
    if old is None:
        return new
    if isinstance(old, tuple):
        start, end = old
        need(start in text and end in text[text.index(start):],
             f"csrc/{name} lost {start[:60]!r} .. {end[:60]!r}")
        a = text.index(start)
        return text[:a] + new + text[text.index(end, a):]
    need(old in text, f"csrc/{name} lost {old[:60]!r}")
    return text.replace(old, new)


def ptxas_summary(log):
    """``[(kernel, "Used N registers, ...")]`` out of ``nvcc -Xptxas -v``
    output."""
    names = [m.group(1) if m else "?" for m in (
        re.search(r"\d+([A-Za-z_]+_kernel)", f) for f in re.findall(
            r"Compiling entry function '([^']+)'", log))]
    return list(zip(names, re.findall(r"Used \d+ registers[^\n]*", log)))


def build_variant(tmp, v, subs, names):
    """Start nvcc on each csrc/<name>.cu of ``names`` with ``subs``
    applied to a copy of the sources under ``tmp``: ``[(source, so,
    process)]``."""
    from raft_tla_tpu_torch.utils import build
    src = os.path.join(tmp, f"csrc{v}")
    shutil.copytree(build.CSRC, src)
    for name, old, new in subs:
        path = os.path.join(src, name)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(substitute(text, name, old, new))
    procs = []
    for name in names:
        so = os.path.join(tmp, f"lib{name}{v}.so")
        procs.append((name, so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", src,
             "-o", so, os.path.join(src, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def tail_variants(torch, device):
    """``python3 chip_smoke.py --tail-variants``: the insert and the fused
    tail built from each of TAIL_VARIANTS, each held exactly against its
    plain version and timed (queued back to back, and per launch under
    the profiler) at loads 0.015 and 0.4 of the 2^25-slot table, on
    batches of the kernel phases' kind.  Not part of the smoke run."""
    import ctypes
    from raft_tla_tpu_torch.ops import fpset_cuda, fused_tail_cuda
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    tables = {load: prefilled_table(torch, gen, device, load)
              for load in (0.015, 0.4)}
    sw = 473
    krows = torch.randint(0, 256, (K, sw), generator=gen, device=device,
                          dtype=torch.uint8)
    qa = torch.randint(0, 256, ((1 << 16) + K, sw), generator=gen,
                       device=device, dtype=torch.uint8)
    qb = qa.clone()
    enq_ok = torch.rand(K, generator=gen, device=device) < 0.7
    real = (fpset_cuda._lib, fused_tail_cuda._lib)
    argtypes = (fpset_cuda._lib().fpset_insert_launch.argtypes,
                fused_tail_cuda._lib().fused_tail_launch.argtypes)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tail_")
    try:
        procs = [(name, src, so, proc)
                 for v, (name, subs) in enumerate(TAIL_VARIANTS)
                 for src, so, proc in build_variant(
                     tmp, v, subs, ("fpset", "fused_tail"))]
        built = collections.defaultdict(dict)
        for name, src, so, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                print(f"tail variant {name}: nvcc {src}.cu failed: "
                      f"{log[-800:]}")
            else:
                built[name][src] = so
        for name, _subs in TAIL_VARIANTS + TAIL_VARIANTS[:1]:
            if len(built[name]) < 2:
                continue
            libs = []
            for src, fn, types in (("fpset", "fpset_insert_launch",
                                    argtypes[0]),
                                   ("fused_tail", "fused_tail_launch",
                                    argtypes[1])):
                lib = ctypes.CDLL(built[name][src])
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = types
                libs.append(lib)
            fpset_cuda._lib = lambda lib=libs[0]: lib
            fused_tail_cuda._lib = lambda lib=libs[1]: lib
            for load, (base, present) in tables.items():
                q, valid = dup_heavy_queries(torch, gen, device, present)
                err = held_insert(torch, f"{name}, load {load}", base, q,
                                  valid)
                err = max(err, held_tail(
                    torch, f"{name}, load {load}", base, q, valid, krows,
                    enq_ok, qa, qb, 12345)[0])
                work = copy_table(torch, base)

                def restore():
                    work.keys.copy_(base.keys)
                    work.size.copy_(base.size)

                ops_i = device_ops(torch, lambda: fpset_cuda.insert(
                    work, q, valid), setup=restore)
                nc = device_count(torch, 12345, device)
                ops_t = device_ops(torch, lambda: fused_tail_cuda
                                   .insert_enqueue(work, q, valid, krows,
                                                   enq_ok, qa, nc, 12345),
                                   setup=restore)
                restore()
                batches = iter(fresh_batches(torch, gen, device, present))
                qi = queued_ms(torch, lambda: fpset_cuda.insert(
                    work, *next(batches)), QUEUED_REPS, QUEUED_SAMPLES)
                restore()
                batches = iter(fresh_batches(torch, gen, device, present))
                qt = queued_ms(torch, lambda: fused_tail_cuda.insert_enqueue(
                    work, *next(batches), krows, enq_ok, qa, nc, 12345),
                    QUEUED_REPS, QUEUED_SAMPLES)
                qb.copy_(qa)
                print(f"tail variant {name} at load {load}: insert queued "
                      f"{qi} ms, device microseconds {ops_i}; fused tail "
                      f"queued {qt} ms, device microseconds {ops_t}; "
                      f"max_abs_err {err}")
                del work
    finally:
        fpset_cuda._lib, fused_tail_cuda._lib = real
        shutil.rmtree(tmp, ignore_errors=True)


def phase_resume(torch, pipeline):
    """Checkpoint and resume on the card: a split-tail check to L9 writes
    its level-9 snapshot (under the system's temporary directory, removed
    again), a second engine rebuilds the seen set from the
    snapshot's keys through the insert kernel (timed) and resumes to L11
    with the pinned counts.  Also timed: the rebuild of as many random
    keys as L11 holds, the size a later resume or growth would meet."""
    import numpy as np
    from raft_tla_tpu_torch.engine import checkpoint as ckpt
    from raft_tla_tpu_torch.engine.check import initial_states, make_engine
    from raft_tla_tpu_torch.ops import fpset
    from raft_tla_tpu_torch.utils.cfg import load_config
    setup = load_config(os.path.join(HERE, "configs/MCraft_bounded.cfg"))
    d9, d11 = len(MCRAFT_L9_LEVELS) - 1, len(MCRAFT_L11_LEVELS) - 1
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        first = make_engine(setup, bounded_config(
            pipeline, d9, enqueue_method="kernel", checkpoint_dir=ckdir,
            checkpoint_every=d9), device="cuda")
        res9 = first.run(initial_states(setup))
        path = ckpt.latest(ckdir)
        need(path is not None and path.endswith(f"level_{d9:05d}.npz"),
             f"no level-{d9} snapshot in {sorted(os.listdir(ckdir))}")
        size = os.path.getsize(path)
        t = time.time()
        ck = ckpt.load(path)
        load_s = time.time() - t
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    need(res9.distinct == MCRAFT_L9_DISTINCT
         and ck.seen_hi.shape[0] == MCRAFT_L9_DISTINCT
         and ck.frontier.shape[0] == MCRAFT_L9_LEVELS[-1]
         and ck.levels == tuple(MCRAFT_L9_LEVELS),
         "the level-9 snapshot differs from the pinned oracle")
    engine = make_engine(setup, bounded_config(pipeline, d11,
                                               enqueue_method="kernel"),
                         device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    t = time.time()
    point = engine.resume_point(ck)
    torch.cuda.synchronize()
    rebuild_s = time.time() - t
    rebuild_launches = read_counts()["fpset_insert"]
    res = engine.run(resume=point)
    counts = read_counts()
    print(f"checkpoint L9 {pipeline}: {size} bytes, written with the level-0 "
          f"snapshot in {res9.phases['checkpoint']} s, loaded in {load_s} s; "
          f"seen set of {ck.seen_hi.shape[0]} keys rebuilt into "
          f"{point.seen.capacity} slots through the insert kernel in "
          f"{rebuild_s} s ({rebuild_launches} launches, host to device copy "
          "included)")
    print(f"resume L9 -> L11 {pipeline}: distinct={res.distinct} "
          f"generated={res.generated} levels={res.levels} "
          f"batches={res.batches} check {res.wall_seconds} s (the first "
          f"run's {ck.wall_seconds} s included), launches {counts}")
    need(rebuild_launches >= 1, "the rebuild bypassed the insert kernel")
    need(res.levels == MCRAFT_L11_LEVELS
         and res.distinct == MCRAFT_L11_DISTINCT
         and res.generated == MCRAFT_L11_GENERATED,
         f"the resumed run ({pipeline}) differs from the pinned oracle")
    check_launches(pipeline, counts, res.steps, "resume L9 -> L11",
                   "kernel", inserts=rebuild_launches)
    del point, res, first
    torch.cuda.empty_cache()
    rng = np.random.RandomState(11)
    keys = np.unique(rng.randint(0, 1 << 63, MCRAFT_L11_DISTINCT,
                                 dtype=np.int64).astype(np.uint64))
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    torch.cuda.synchronize()
    t = time.time()
    big = fpset.from_host_keys(hi, lo, SEEN, engine.device)
    torch.cuda.synchronize()
    print(f"seen-set rebuild of {keys.shape[0]} random keys into 2^25 slots "
          f"through the insert kernel: {time.time() - t} s (host to device "
          f"copy included), size {int(big.size[0])}")
    need(int(big.size[0]) == keys.shape[0], "the large rebuild lost keys")


def phase_por(torch):
    """A forged POR table (every DuplicateMessage instance certified,
    priority = g; not a sound certificate, it drives the masking) through
    ``--por-table`` to L8 at the main path's sizes: the two plans agree on
    every count and on the pruned lanes per family, and reduce the run."""
    from raft_tla_tpu_torch import cli
    from raft_tla_tpu_torch.analysis.por import PorTable
    from raft_tla_tpu_torch.engine.check import run_check
    from raft_tla_tpu_torch.utils.cfg import load_config
    import numpy as np
    cfg_path = os.path.join(HERE, "configs/MCraft_bounded.cfg")
    dims = load_config(cfg_path).dims
    G = dims.n_instances
    mask = np.zeros(G, bool)
    off = dims.family_offsets[dims.family_names.index("DuplicateMessage")]
    mask[off:off + dims.n_msg_slots] = True
    tmp = tempfile.mkdtemp(prefix="chip_smoke_por_")
    try:
        path = os.path.join(tmp, "por.json")
        PorTable(model=repr(dims), n_instances=G, ample_mask=mask,
                 priority=np.arange(G, dtype=np.int32),
                 predicates=("TypeOK", "CONSTRAINT")).save(path)
        out = {}
        for pipeline in ("v3", "v4"):
            reset_counts()
            res = run_check(cfg_path, bounded_config(pipeline, 8,
                                                     por_table=path),
                            device="cuda")
            counts = read_counts()
            out[pipeline] = (res.distinct, res.generated, res.levels,
                             res.action_counts, res.action_pruned)
            print(f"POR L8 {pipeline}: {res.por_instances} certified "
                  f"instances, distinct={res.distinct} "
                  f"generated={res.generated} levels={res.levels} "
                  f"pruned={sum(res.action_pruned.values())} by family "
                  f"{res.action_pruned} launches {counts}")
            need(res.por_instances == dims.n_msg_slots,
                 f"the table certified {res.por_instances} instances")
            check_launches(pipeline, counts, res.steps, "POR L8")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["check", cfg_path, "--por-table", path,
                           "--pipeline", "v4", "--max-diameter",
                           str(bounded_config("v4", 8).max_diameter),
                           "--no-trace", "--enqueue-method", "kernel"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    need(out["v3"] == out["v4"], "v3 and v4 differ under the POR table")
    distinct, _gen, _lv, _ac, pruned = out["v4"]
    need(sum(pruned.values()) > 0 and pruned["DuplicateMessage"] == 0
         and distinct < MCRAFT_L8_DISTINCT,
         "the POR table did not reduce the run")
    need(rc == 0 and f"distinct states    {distinct}\n" in buf.getvalue()
         and f"{sum(pruned.values())} enabled lanes pruned" in buf.getvalue(),
         "check --por-table printed other counts: " + buf.getvalue()[:400])
    print(f"POR through the command line (v4, split tail): distinct "
          f"{distinct}, as the engine runs")


def phase_counterexample(torch, pipeline):
    """configs/MCraft_noleader.cfg at its own engine sizes: the violation
    and its replay to the first leader at depth 9."""
    from raft_tla_tpu_torch.engine.check import (engine_config_from_backend,
                                                 initial_states, make_engine)
    from raft_tla_tpu_torch.models.dims import LEADER
    from raft_tla_tpu_torch.utils.cfg import load_config
    setup = load_config(os.path.join(HERE, "configs/MCraft_noleader.cfg"))
    cfg = dataclasses.replace(engine_config_from_backend(setup),
                              pipeline=pipeline)
    reset_counts()
    t = time.time()
    engine = make_engine(setup, cfg, device="cuda")
    res = engine.run(initial_states(setup))
    steps = engine.replay(res.violation.fingerprint) \
        if res.violation is not None else []
    counts = read_counts()
    print(f"MCraft_noleader {pipeline}: stop={res.stop_reason} "
          f"distinct={res.distinct} depth={len(steps) - 1} in "
          f"{time.time() - t} s, launches {counts}")
    need(res.violation is not None
         and res.violation.invariant == "NoLeaderElected",
         "MCraft_noleader did not stop on NoLeaderElected")
    need(len(steps) - 1 == 9, f"counterexample depth {len(steps) - 1} != 9")
    need(steps[-1][1] == res.violation.state
         and LEADER in steps[-1][1].role
         and all(LEADER not in st.role for _g, st in steps[:-1]),
         "replay does not end at the first leader")
    check_launches(pipeline, counts, res.steps, "MCraft_noleader",
                   trace=True)


# -- what check prints and writes (engine/explain.py, obs/) -------------------

#: sha256 of configs/MCraft_noleader.cfg's counterexample.txt
#: (tests/test_torch_explain.py pins the same digest on the CPU).
NOLEADER_TXT_SHA256 = (
    "98db3fbba10678ad7587b788b726986898941c397c5753de0ec772d496061c31")

#: A one-server model whose leader appears within a few steps: a reached
#: graph under the export cap.
ONE_SERVER_CFG = """CONSTANTS
    Server = {r1}
    Value = {v1}
    Follower = Follower
    Candidate = Candidate
    Leader = Leader
    Nil = Nil
    RequestVoteRequest = RequestVoteRequest
    RequestVoteResponse = RequestVoteResponse
    AppendEntriesRequest = AppendEntriesRequest
    AppendEntriesResponse = AppendEntriesResponse
    MaxTerm = 2
    MaxLogLen = 1
    MaxMsgCount = 1
SPECIFICATION Spec
INVARIANT NoLeaderElected
CONSTRAINT BoundedSpace
CHECK_DEADLOCK FALSE
"""


def port_cli(args):
    """``python3 -m raft_tla_tpu_torch <args>`` from the checkout, started
    (not waited for)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE
    return subprocess.Popen([sys.executable, "-m", "raft_tla_tpu_torch"]
                            + args, cwd=HERE, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def deadlocking():
    """A context in which the engine's v2 masks carry one more guard: no
    action is enabled in a state where a term reached 3.  Raft's Restart
    is always enabled, so no model of the spec deadlocks; this one does,
    at the first such state, through the real chunk on the card."""
    from raft_tla_tpu_torch.engine import bfs as tbfs
    build = tbfs.build_v2

    def build_v2(dims, device):
        v2 = build(dims, device)

        def guarded(st, masks=v2.masks):
            en, ovf = masks(st)
            live = (st.term.max(1).values < 3)[:, None]
            return en & live, ovf & live

        return v2._replace(masks=guarded)

    @contextlib.contextmanager
    def patched():
        tbfs.build_v2 = build_v2
        try:
            yield
        finally:
            tbfs.build_v2 = build
    return patched()


def phase_check_outputs(torch):
    """What ``check`` prints and writes, through the CLI on the card
    (subprocesses, started together): MCraft_noleader on v3 and on v4 with
    ``--counterexample-dir``, ``--events-out`` and ``--metrics-out`` (exit
    1, the pinned counterexample.txt on both plans, its text in the
    printout, depth 9 in the JSON, the events file valid, its statespace
    levels the run's levels); ``--no-trace`` (the violating state
    printed); ``explain`` as JSON and as HTML to a file; the graph of a
    one-server model as DOT.  Then, in process, a deadlocking model
    prints its deadlocked state.  Returns the seconds it took."""
    import hashlib
    from raft_tla_tpu_torch import cli
    from raft_tla_tpu_torch.engine.check import (initial_states,
                                                 make_engine)
    from raft_tla_tpu_torch.models.pystate import format_state
    from raft_tla_tpu_torch.obs.events import validate_run_events
    from raft_tla_tpu_torch.utils.cfg import load_config
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_outputs_")
    try:
        noleader = os.path.join(HERE, "configs/MCraft_noleader.cfg")
        one = os.path.join(tmp, "MCraft_one.cfg")
        with open(one, "w") as f:
            f.write(ONE_SERVER_CFG)
        runs = {}
        for p in ("v3", "v4"):
            d = os.path.join(tmp, p)
            runs[p] = port_cli(
                ["check", noleader, "--pipeline", p, "--counterexample-dir",
                 d, "--events-out", os.path.join(d, "ev.jsonl"),
                 "--metrics-out", os.path.join(d, "m.json")])
        runs["no-trace"] = port_cli(["check", noleader, "--no-trace",
                                     "--pipeline", "v4"])
        for fmt in ("json", "html"):
            runs[fmt] = port_cli(["explain", noleader, "--format", fmt,
                                  "--pipeline", "v4", "--out",
                                  os.path.join(tmp, f"ce.{fmt}")])
        runs["graph"] = port_cli(["explain", one, "--graph",
                                  os.path.join(tmp, "one.dot")])
        out = {}
        for name, proc in runs.items():
            stdout, stderr = proc.communicate(timeout=600)
            out[name] = (proc.returncode, stdout, stderr)
            need(proc.returncode == 1, f"CLI run {name} exited "
                 f"{proc.returncode}: {stderr[-2000:]}")
        levels = None
        for p in ("v3", "v4"):
            _rc, stdout, _err = out[p]
            d = os.path.join(tmp, p)
            with open(os.path.join(d, "counterexample.txt"), "rb") as f:
                txt = f.read()
            digest = hashlib.sha256(txt).hexdigest()
            with open(os.path.join(d, "counterexample.json")) as f:
                doc = json.load(f)
            events = validate_run_events(os.path.join(d, "ev.jsonl"))
            end = events[-1]
            space, = [e["report"] for e in events
                      if e["event"] == "statespace"]
            with open(os.path.join(d, "m.json")) as f:
                snap = json.load(f)
            print(f"check MCraft_noleader {p} (CLI): counterexample.txt "
                  f"sha256 {digest}, depth {doc['depth']}, {len(events)} "
                  f"events {sorted({e['event'] for e in events})}, levels "
                  f"{end['levels']}, check {end['wall_seconds']} s, "
                  f"{len(snap['counters'])} counters, "
                  f"{len(snap['gauges'])} gauges")
            need(digest == NOLEADER_TXT_SHA256,
                 f"{p}: counterexample.txt differs from the pinned one")
            need(doc["depth"] == 9 and doc["invariant"] == "NoLeaderElected",
                 f"{p}: counterexample.json {doc.get('depth')}")
            need("\n\n" + txt.decode() + "\ncounterexample written: "
                 in stdout, f"{p}: the printout lacks the file's text")
            need([r["frontier"] for r in space["levels"]] == end["levels"]
                 and end["counterexample_path"].endswith(
                     "counterexample.txt"),
                 f"{p}: statespace levels {space['levels']} vs "
                 f"{end['levels']}")
            need(levels is None or end["levels"] == levels,
                 "the two plans' levels differ")
            levels = end["levels"]
        stdout = out["no-trace"][1]
        need("\nviolating state (trace recording disabled):\n  r1: "
             in stdout and "counterexample written" not in stdout,
             "--no-trace did not print the violating state")
        with open(os.path.join(tmp, "ce.json")) as f:
            need(json.load(f)["depth"] == 9, "explain --format json")
        with open(os.path.join(tmp, "ce.html")) as f:
            html = f.read()
        need(html.startswith("<!doctype html>") and "State 10: " in html,
             "explain --format html")
        with open(os.path.join(tmp, "one.dot")) as f:
            dot = f.read()
        need(dot.startswith("digraph statespace {") and " -> " in dot,
             "explain --graph")
        print(f"explain (CLI): json and html of the depth-9 trace, "
              f"{len(html)} bytes of html; one-server graph "
              f"{dot.count(' -> ')} edges; {out['graph'][1].strip()}")
        # The deadlock printout, through the chunk on the card.
        cfg = os.path.join(tmp, "dead.cfg")
        with open(os.path.join(HERE, "configs/MCraft_bounded.cfg")) as f:
            text = f.read().replace("CHECK_DEADLOCK FALSE", "")
        with open(cfg, "w") as f:
            f.write(text + "\nCHECK_DEADLOCK TRUE\n")
        buf = io.StringIO()
        with deadlocking(), contextlib.redirect_stdout(buf):
            rc = cli.main(["check", cfg, "--progress-interval", "0"])
            setup = load_config(cfg)
            res = make_engine(setup).run(initial_states(setup))
        printed = buf.getvalue().split("\ndeadlock state:\n")
        need(rc == 1 and len(printed) == 2
             and "DEADLOCK reached" in printed[0]
             and printed[1] == format_state(res.deadlock, setup.dims) + "\n"
             and max(res.deadlock.current_term) == 3,
             "the deadlock printout differs: " + buf.getvalue()[-800:])
        print(f"deadlock (CLI, in process, on the card): stop "
              f"{res.stop_reason} at diameter {res.diameter}, the state "
              f"printed")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return time.time() - t0


def phase_observation_cost(torch):
    """MCraft_bounded L11 on v4 with the statespace report and the run
    events off, then on, in turns (off, on, on, off): distinct, generated,
    levels and family counts identical in all four, each wall printed.
    Then the sync check with events on."""
    from raft_tla_tpu_torch.engine.check import run_check
    from raft_tla_tpu_torch.obs.events import validate_run_events
    tmp = tempfile.mkdtemp(prefix="chip_smoke_events_")
    try:
        runs = []
        for i, on in enumerate((False, True, True, False)):
            ev = os.path.join(tmp, f"ev{i}.jsonl") if on else None
            res = run_check(os.path.join(HERE, "configs/MCraft_bounded.cfg"),
                            bounded_config("v4", 11, statespace_report=on,
                                           events_out=ev), device="cuda")
            if on:
                events = validate_run_events(ev)
                need(sum(e["event"] == "level_complete" for e in events)
                     == len(res.levels) and res.report
                     and res.coverage["Timeout"]["distinct"] > 0,
                     "the L11 run's events or report are incomplete")
            runs.append((on, res))
        for on, res in runs:
            need((res.distinct, res.generated, res.levels,
                  res.action_counts)
                 == (runs[0][1].distinct, runs[0][1].generated,
                     runs[0][1].levels, runs[0][1].action_counts)
                 and res.levels == MCRAFT_L11_LEVELS,
                 "the report or events changed a count")
        print("MCraft_bounded L11 v4, report and events off/on in turns "
              "(on, check seconds, chunks, host seconds): " + ", ".join(
                  f"({'on' if on else 'off'}, {r.wall_seconds}, {r.chunks}, "
                  f"{r.phases['host']})" for on, r in runs))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_dispatch_sync_free(torch, "v4", events=True)


def tpuraft_config(depth, **kw):
    """configs/TPUraft.cfg's directives on v4, to ``depth``."""
    from raft_tla_tpu_torch.engine.check import engine_config_from_backend
    from raft_tla_tpu_torch.utils.cfg import load_config
    setup = load_config(os.path.join(HERE, "configs/TPUraft.cfg"))
    return dataclasses.replace(engine_config_from_backend(setup),
                               pipeline="v4", max_diameter=depth, **kw)


def tpuraft_check(torch, cfg_name, depth, what, invariants=None, **kw):
    """``configs/<cfg_name>`` with its own directives, overridden by
    ``kw`` (and its invariant list by ``invariants``), checked to
    ``depth`` on the card: the oracle's TPUraft levels and counts held, the
    launches checked.  Returns (engine, result, peak device bytes
    allocated)."""
    from raft_tla_tpu_torch.engine.check import (engine_config_from_backend,
                                                 initial_states, make_engine)
    from raft_tla_tpu_torch.utils.cfg import load_config
    setup = load_config(os.path.join(HERE, "configs", cfg_name))
    if invariants is not None:
        setup = dataclasses.replace(setup, invariants=list(invariants))
    cfg = dataclasses.replace(engine_config_from_backend(setup),
                              max_diameter=depth, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.time()
    engine = make_engine(setup, cfg, device="cuda")
    res = engine.run(initial_states(setup))
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"{what}: distinct={res.distinct} generated={res.generated} "
          f"levels={res.levels} stop={res.stop_reason} "
          f"batches={res.batches} steps={res.steps} chunks={res.chunks} "
          f"spills={res.spills} growths={res.growth_stalls} "
          f"degraded={res.degraded}")
    print(f"{what}: check {res.wall_seconds} s, call {wall} s, "
          f"{res.states_per_second} distinct/s, "
          f"{res.generated / res.wall_seconds} generated/s, phases "
          f"{res.phases}, batch {engine.config.batch} K={engine._K} "
          f"Q={engine._Q} seen={engine._seen_cap} sync_every "
          f"{engine.config.sync_every}, peak device memory allocated "
          f"{peak} bytes, launches {counts}")
    need(res.violation is None and res.deadlock is None,
         f"{what} reported a violation or deadlock")
    need(res.levels == TPURAFT_LEVELS[:depth + 1]
         and res.distinct == TPURAFT_DISTINCT[depth]
         and res.generated == TPURAFT_GENERATED[depth],
         f"{what} differs from the oracle")
    check_launches(engine.config.pipeline, counts, res.steps, what,
                   engine.config.enqueue_method,
                   trace=engine.config.record_trace)
    return engine, res, peak


def phase_tpuraft_kernels(torch, device, gen):
    """The front (B4), the fused tail (B2) and the trace append (B5) at
    the north-star model's shapes (configs/TPUraft.cfg: batch 8192, K
    131,072, G 224, 951-byte rows) on a real window: the last full parent
    window of a check to L7 (its steps dispatched eagerly, so a hook sees
    each).  Each held exactly against its plain version, its launches'
    device microseconds under the profiler beside its bound, the front's
    shared memory and blocks an SM."""
    from raft_tla_tpu_torch.engine import chunk as chunk_mod
    from raft_tla_tpu_torch.engine.check import initial_states, make_engine
    from raft_tla_tpu_torch.ops import chunk_front_cuda, enqueue_cuda
    from raft_tla_tpu_torch.ops import enqueue as enq_mod
    from raft_tla_tpu_torch.ops import fused_tail_cuda
    from raft_tla_tpu_torch.ops.fpset import pack
    from raft_tla_tpu_torch.utils.cfg import load_config
    setup = load_config(os.path.join(HERE, "configs/TPUraft.cfg"))
    dims = setup.dims
    engine = make_engine(setup, tpuraft_config(7, record_trace=False),
                         device="cuda")
    dispatch_eagerly(engine)
    body, last = engine._step.body, []

    def capture(rows, valid, *args):
        if bool(valid.all()):
            last[:] = [rows.clone(), valid.clone()]
        return body(rows, valid, *args)

    engine._step.body = capture
    engine.run(initial_states(setup))
    need(last, "the TPUraft L7 run dispatched no full window")
    rows, valid = last
    b, k, sw = engine._B, engine._K, engine._sw
    front = chunk_front_cuda.Front(
        dims=dims, v2=engine._v2, inv_fns=engine._inv_fns,
        constraint=engine._constraint, B=b, K=k, device=device)
    out = front(rows, valid)
    err = front_err(torch, out, front.plain(rows, valid))
    total = int(out.total)
    need(err == 0.0, "chunk_front differs from front_plain at TPUraft")
    us = [t for _n, t in device_ops(torch, lambda: front(rows, valid))]
    queued = queued_ms(torch, lambda: front(rows, valid))
    nbytes = front_bytes(dims, b, k, total)
    print(f"TPUraft chunk_front [{b},{sw}] -> K={k}: P={int(out.P)} "
          f"total={total} max_abs_err={err}; queued back to back {queued} "
          f"ms, launches' device microseconds {us}; bound "
          f"{nbytes / HBM_BYTES_PER_S * 1e3} ms ({nbytes} bytes); "
          f"launches {front.launch_info()}; blocks an SM "
          f"{front.occupancy()}")
    # The tail on this window's lanes, into a table at L7's load.
    base, _present = prefilled_table(torch, gen, device,
                                     TPURAFT_DISTINCT[7] / SEEN)
    keys = pack(out.kh, out.kl)
    qa = torch.randint(0, 256, ((1 << 20) + k, sw), generator=gen,
                       device=device, dtype=torch.uint8)
    qb = qa.clone()
    e, n_enq = held_tail(torch, "TPUraft L7 window", base, keys,
                         out.kvalid, out.krows, out.cons_ok, qa, qb,
                         NEXT_COUNT)
    err = max(err, e)
    work = copy_table(torch, base)

    def restore():
        work.keys.copy_(base.keys)
        work.size.copy_(base.size)

    nc = device_count(torch, NEXT_COUNT, device)
    restore()
    new, _f, _c = fused_tail_cuda.insert_enqueue(
        work, keys, out.kvalid, out.krows, out.cons_ok, qa, nc, NEXT_COUNT)
    n_new = int(new.sum())
    def tail():
        fused_tail_cuda.insert_enqueue(work, keys, out.kvalid, out.krows,
                                       out.cons_ok, qa, nc, NEXT_COUNT)

    us = [t for _n, t in device_ops(torch, tail, setup=restore)]
    ms = cuda_ms(torch, tail, 10, setup=restore)
    nbytes = (insert_bytes(k, distinct_valid(torch, keys, out.kvalid), n_new)
              + k + 4 + 2 * n_enq * sw)
    print(f"TPUraft fused_tail K={k}: {n_new} new, {n_enq} enqueued; one "
          f"call between two events {ms} ms, launches' device "
          f"microseconds {us or 'not measured'}; bound "
          f"{nbytes / HBM_BYTES_PER_S * 1e3} ms ({nbytes} bytes)")
    # The trace append of the same lanes: 20-byte records of the new ones.
    trows = torch.stack([out.kh, out.kl, out.parent_hi, out.parent_lo,
                         out.lane_id.to(torch.int64) % dims.n_instances], 1)
    trows = trows.to(torch.int32).view(torch.uint8)
    tq = torch.zeros((4 * k, chunk_mod.TRACE_ROW), dtype=torch.uint8,
                     device=device)
    tq2 = tq.clone()
    tc = device_count(torch, 777, device)
    cnt = enqueue_cuda.enqueue(tq, tc, trows, new, 3 * k)
    want = enq_mod.enqueue_plain(tq2, 777, trows, new)
    torch.cuda.synchronize()
    e = max_abs(torch, [(cnt, want)])
    need(e == 0.0 and bool(torch.equal(tq, tq2)),
         "the trace append differs from its plain version at TPUraft")
    err = max(err, e)
    def append():
        enqueue_cuda.enqueue(tq, tc, trows, new, 3 * k)

    us = [t for _n, t in device_ops(torch, append)]
    queued = queued_ms(torch, append)
    nbytes = k + 2 * n_new * chunk_mod.TRACE_ROW + 4
    print(f"TPUraft trace append K={k}: {n_new} records of 20 B; queued "
          f"back to back {queued} ms, launches' device microseconds "
          f"{us or 'not measured'}; bound "
          f"{nbytes / HBM_BYTES_PER_S * 1e3} ms ({nbytes} bytes)")
    del qa, qb, base, work, tq, tq2, engine
    torch.cuda.empty_cache()
    return err


def phase_north_star(torch):
    """configs/TPUraft.cfg as written (batch 8192, queue 4,194,304 rows,
    seen 2^25 slots) on v4 with the fused tail, trace on and sync_every 32,
    to L9: the oracle's 24,753,442 distinct, 84,522,610 generated and ten
    levels; the L9 frontier spills to the host.  Then a random L9 state is
    replayed from the trace: a path of nine steps, each a successor of the
    one before, ending on that state."""
    import numpy as np
    from raft_tla_tpu_torch.models.schema import encode_state, stack_states
    engine, res, peak = tpuraft_check(
        torch, "TPUraft.cfg", 9, "TPUraft L9 v4 fused tail, trace on",
        pipeline="v4", enqueue_method="fused", record_trace=True,
        sync_every=32)
    need(res.spills >= 1, "the L9 frontier did not spill")
    fps, _p, _a = engine.trace.export()
    need(len(fps) == res.distinct, f"{len(fps)} trace records for "
         f"{res.distinct} states")
    i = np.random.RandomState(9).randint(TPURAFT_DISTINCT[8], len(fps))
    fp = int(fps[i])
    t = time.time()
    path = engine.replay(fp)
    replay_s = time.time() - t
    hi, lo = engine._fingerprint(stack_states(
        [encode_state(path[-1][1], engine.dims)], engine.device))
    from raft_tla_tpu_torch.obs.report import render_report
    print(render_report(res.report))
    need([r["frontier"] for r in res.report["levels"]] == TPURAFT_LEVELS
         and res.report["distinct"] == TPURAFT_DISTINCT[9],
         "the TPUraft L9 report's level table differs from the pinned one")
    print(f"TPUraft L9 replay of trace record {i} (fp {fp:#018x}): "
          f"{len(path) - 1} steps in {replay_s} s, actions "
          f"{[engine.dims.describe_instance(g) for g, _s in path[1:]]}")
    need(len(path) - 1 == 9 and path[0][0] == -1
         and (int(hi[0]) << 32 | int(lo[0])) == fp,
         f"the replay of an L9 state gave {len(path) - 1} steps")
    del engine
    return res, peak


def phase_tpuraft_more(torch):
    """The north-star model on the other paths: the split tail to L8, a
    1,048,576-row queue spilling to files to L8, v3 to L6; and
    configs/raft5_bounded.cfg (32 message slots: the same state space)
    with its capacities from the card's memory to L8."""
    from raft_tla_tpu_torch.engine.bfs import auto_capacities, device_memory
    from raft_tla_tpu_torch.models.schema import state_width
    from raft_tla_tpu_torch.utils.cfg import load_config
    tpuraft_check(torch, "TPUraft.cfg", 8, "TPUraft L8 v4 split tail",
                  pipeline="v4", enqueue_method="kernel", record_trace=False)
    spill = tempfile.mkdtemp(prefix="chip_smoke_spill_")
    try:
        _e, res, _p = tpuraft_check(
            torch, "TPUraft.cfg", 8, "TPUraft L8 v4, queue 2^20 spilling to "
            "files", pipeline="v4", record_trace=False,
            queue_capacity=1 << 20, spill_dir=spill)
        left = os.listdir(spill)
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    print(f"disk spill: {res.spills} spills, spill seconds "
          f"{res.phases['spill']}, files left {left}")
    need(res.spills >= 2 and not left, "the disk spill did not spill twice "
         "or left files")
    tpuraft_check(torch, "TPUraft.cfg", 6, "TPUraft L6 v3", pipeline="v3",
                  record_trace=False)
    dims = load_config(os.path.join(HERE, "configs/raft5_bounded.cfg")).dims
    limit = device_memory("cuda")
    q, s = auto_capacities(state_width(dims), 8192, False, limit)
    engine, res, peak = tpuraft_check(
        torch, "raft5_bounded.cfg", 8, "raft5_bounded L8 v4, capacities "
        "from the card", pipeline="v4", batch=8192, record_trace=False,
        queue_capacity=None, seen_capacity=None)
    print(f"auto capacities from {limit} bytes: queue {q} rows, seen {s} "
          f"slots; the engine took Q={engine._Q} seen={engine._seen_cap}")
    need(engine._Q == -(-q // 8192) * 8192 and engine._seen_cap == s,
         "the engine did not take the capacities from the card")


def phase_sync_turns(torch):
    """MCraft_bounded L9 and L11 on v4 with the fused tail at sync_every 1
    and 32, in turns (1, 32, 32, 1): wall and host seconds a batch."""
    from raft_tla_tpu_torch.engine.check import run_check
    pins = {9: (MCRAFT_L9_DISTINCT, MCRAFT_L9_GENERATED),
            11: (MCRAFT_L11_DISTINCT, MCRAFT_L11_GENERATED)}
    for depth in (9, 11):
        out = []
        for se in (1, 32, 32, 1):
            res = run_check(os.path.join(HERE, "configs/MCraft_bounded.cfg"),
                            bounded_config("v4", depth, sync_every=se),
                            device="cuda")
            need((res.distinct, res.generated) == pins[depth],
                 f"MCraft_bounded L{depth} at sync_every {se} differs from "
                 "the pinned oracle")
            ph, n = res.phases, res.batches
            out.append(f"(sync_every {se}: check {res.wall_seconds} s, "
                       f"{n} batches, {res.chunks} chunks, {res.steps} "
                       f"steps; a batch: dispatch {ph['dispatch'] / n} s, "
                       f"sync {ph['sync'] / n} s, host {ph['host'] / n} s, "
                       f"capture {ph['capture']} s)")
        print(f"MCraft_bounded L{depth} v4 fused, sync_every in turns: "
              + ", ".join(out))


def phase_oom(torch):
    """OOM degradation on the card: TPUraft (queue 2^20 rows) at batch
    4096 to L8 sets the memory that batch needs, batch 8192 to L5 the
    memory it needs; the process's memory is capped between the two
    (``torch.cuda.set_per_process_memory_fraction``) and batch 8192 run to
    L8 with snapshots: it must degrade to 4096 and give the L8 counts.
    (Batch 8192 to L5 sets its need: the batch's temporaries and the
    graph's pool are all taken at the first chunks.)"""
    import gc
    total = torch.cuda.get_device_properties(0).total_memory
    kw = dict(pipeline="v4", record_trace=False, queue_capacity=1 << 20)
    peaks = {}
    for batch, depth in ((4096, 8), (8192, 5)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _e, _r, _p = tpuraft_check(torch, "TPUraft.cfg", depth,
                                   f"TPUraft L{depth} batch {batch}",
                                   batch=batch, **kw)
        peaks[batch] = torch.cuda.max_memory_reserved()
        del _e, _r
    print(f"OOM: peak device memory reserved at batch 4096 {peaks[4096]}, "
          f"at 8192 {peaks[8192]} bytes")
    if peaks[8192] <= peaks[4096]:
        print("OOM degradation on the card: not measured (batch 8192 "
              "reserved no more than 4096; no cap separates them)")
        return None
    cap = (peaks[4096] + peaks[8192]) // 2
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_oom_")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        _e, res, _p = tpuraft_check(
            torch, "TPUraft.cfg", 8, f"TPUraft L8 batch 8192 under a cap of "
            f"{cap} bytes", batch=8192, checkpoint_dir=ckdir,
            checkpoint_every=3, checkpoint_interval_seconds=0.0, **kw)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        shutil.rmtree(ckdir, ignore_errors=True)
    need(res.degraded and res.degraded[-1][1] == 4096,
         f"the capped run did not degrade to batch 4096: {res.degraded}")
    return res.degraded


# -- the safety suite (models/safety.py) and the SmokeInit roots -------------

SAFETY_SUITE = ("MessagesInv", "LeaderVotesQuorum", "CandidateTermNotInLog",
                "ElectionSafety", "LogMatching", "VotesGrantedInv",
                "QuorumLogInv", "MoreUpToDateCorrect", "LeaderCompleteness")
# The SmokeInit check of tests/test_torch_safety_engine.py: MCraft_safety's
# dims with Init <- SmokeInit (k = 2), the seed, the suite's invariants that
# hold on all 512 roots, the engine's sizes, and the JAX engine's result:
# (invariant, depth, distinct, generated, levels, violating fingerprint)
# and the replayed path as (action, state fingerprint).
SMOKE_SEED = 24
SMOKE_INVARIANTS = ("TypeOK", "LeaderVotesQuorum", "CandidateTermNotInLog",
                    "ElectionSafety", "LogMatching", "LeaderCompleteness")
SMOKE_CONFIG = dict(batch=128, queue_capacity=1 << 14,
                    seen_capacity=1 << 16, record_trace=True,
                    check_deadlock=False, max_diameter=8)
SMOKE_PIN = ("CandidateTermNotInLog", 1, 2432, 2040, [256],
             0x737AF3816ACBA33D)
SMOKE_PATH = [(-1, 0xD0333C6874937F7D), (4, 0x737AF3816ACBA33D)]


def crafted_violations(dims):
    """``[(name, state)]``: for each predicate of the suite a state that
    violates it and, in MCraft_safety.cfg's order, no predicate before it.
    The violations are those of the JAX package's safety tests (a leader
    without an entry of its term that another log holds; one index and
    term with two values; a leader without votes; an electable candidate
    whose term is in a log; a vote granted by a server whose committed
    entry the grantee lacks; a committed entry in no other log; a more
    up-to-date log without another's committed entry; a leader without a
    committed entry; a vote request with a wrong last index), widened to
    ``dims.n_servers`` (3 or more) by servers as Init has them, or as
    given, so that the earlier predicates of the list hold."""
    from raft_tla_tpu_torch.models.dims import CANDIDATE, LEADER, RVQ
    from raft_tla_tpu_torch.models.pystate import init_state
    n = dims.n_servers
    init = init_state(dims)

    def state(pad=None, **fields):
        out = {}
        for f, v in fields.items():
            if f == "messages":
                out[f] = v
                continue
            fill = (pad or {}).get(f, getattr(init, f)[-1])
            out[f] = tuple(v) + (fill,) * (n - len(v))
        return dataclasses.replace(init, **out)

    e1, e2 = ((1, 1),), ((2, 1),)
    return [
        ("MessagesInv", state(
            role=(CANDIDATE,), current_term=(2,),
            messages=frozenset({((RVQ, 0, 1, 2, 0, 5), 1)}))),
        ("LeaderVotesQuorum", state(role=(LEADER,), current_term=(2,))),
        ("CandidateTermNotInLog", state(
            {"current_term": 2}, role=(CANDIDATE,), current_term=(2,),
            log=((), e2))),
        ("ElectionSafety", state(
            {"current_term": 2, "voted_for": 1}, role=(LEADER,),
            current_term=(2,), voted_for=(1,), log=((), e2))),
        ("LogMatching", state(log=(e1, ((1, 2),)))),
        ("VotesGrantedInv", state(votes_granted=(0b10,), log=((), e1),
                                  commit_index=(0, 1))),
        ("QuorumLogInv", state(log=(e1, ()), commit_index=(1,))),
        ("MoreUpToDateCorrect", state(
            {"log": e1}, log=(e2, e1), commit_index=(0, 1, 0))),
        ("LeaderCompleteness", state(
            {"current_term": 2, "voted_for": 1, "log": e1}, role=(LEADER,),
            current_term=(2,), voted_for=(1,), log=((), e1),
            commit_index=(0, 1, 0))),
    ]


def state_window(torch, dims, states, b, device):
    """A b-row window of ``states`` (valid), the rows after them invalid."""
    from raft_tla_tpu_torch.models.schema import (encode_state,
                                                  flatten_state, stack_states)
    rows = flatten_state(stack_states([encode_state(s, dims)
                                       for s in states], device), dims)
    w = torch.zeros((b, rows.shape[1]), dtype=torch.uint8, device=device)
    w[:rows.shape[0]] = rows
    valid = torch.arange(b, device=device) < rows.shape[0]
    return w, valid


def lanes_us(torch, front, rows, valid):
    """Device microseconds of the front's lanes launch, under the
    profiler (None when it sees no device time)."""
    ops = device_ops(torch, lambda: front(rows, valid))
    us = [t for n, t in ops if n == "lanes_kernel"]
    return us[0] if us else None


def phase_safety_front(torch, device, shape):
    """The front kernel with the safety suite against ``front_plain``,
    exactly, at one of two shapes: "MCraft" (MCraft_safety.cfg: 3 servers,
    473-byte rows, batch 2048, K 32,768) or "TPUraft" (configs/TPUraft.cfg:
    5 servers, 48 slots, 951-byte rows, batch 8192, K 131,072).  Three
    kinds of parent windows: a real one (a full window of a check, where
    every predicate holds on every successor), random states over the
    smoke domains (models/smoke.py) and the nine crafted violating states.
    Eleven lists: MCraft_safety.cfg's ten in its order and each of the
    nine alone; each of the nine must be the first failing id on some lane
    of the crafted window in both.  Then the lanes launch with the suite
    and with TypeOK alone on the real window: its device microseconds, its
    registers and spill bytes, and blocks an SM."""
    from raft_tla_tpu_torch.engine.check import (initial_states,
                                                 make_engine,
                                                 resolve_constraint,
                                                 resolve_invariants)
    from raft_tla_tpu_torch.models import smoke
    from raft_tla_tpu_torch.models.actions2 import build_v2
    from raft_tla_tpu_torch.ops import chunk_front_cuda
    from raft_tla_tpu_torch.utils.cfg import load_config
    if shape == "MCraft":
        setup = load_config(os.path.join(HERE, "configs/MCraft_safety.cfg"))
        _s, _v2, _kw, windows = front_rig(torch, device)
        real = [w for w in windows if bool(w[1].all())][-1]
        b, k = B, K
        del windows
    else:
        setup = load_config(os.path.join(HERE, "configs/TPUraft.cfg"))
        engine = make_engine(setup, tpuraft_config(6, record_trace=False),
                             device="cuda")
        dispatch_eagerly(engine)
        body, last = engine._step.body, []

        def capture(rows, valid, *args):
            if bool(valid.all()):
                last[:] = [rows.clone(), valid.clone()]
            return body(rows, valid, *args)

        engine._step.body = capture
        engine.run(initial_states(setup))
        need(last, "the TPUraft L6 run dispatched no full window")
        real, b, k = tuple(last), engine._B, engine._K
        del engine
    dims = setup.dims
    suite = dataclasses.replace(setup, invariants=["TypeOK",
                                                   *SAFETY_SUITE])
    invs = resolve_invariants(suite)
    lists = [("cfg order", list(invs))] + [(n, [n]) for n in SAFETY_SUITE]
    v2 = build_v2(dims, device)
    cons = resolve_constraint(setup)

    def front(names):
        return chunk_front_cuda.Front(
            dims=dims, v2=v2, inv_fns=[invs[n] for n in names],
            constraint=cons, B=b, K=k, device=device)

    t = time.time()
    kinds = {"real": real,
             "random": state_window(torch, dims, smoke.random_states(
                 dims, b, seed=7), b, device),
             "crafted": state_window(torch, dims, [
                 s for _n, s in crafted_violations(dims)], b, device)}
    print(f"safety front {shape}: windows built in {time.time() - t} s")
    err, first = 0.0, {}
    for lname, names in lists:
        fr = front(names)
        need(fr.suite, f"the front for {lname} is not the suite's build")
        for kind, (rows, valid) in kinds.items():
            got = fr(rows, valid)
            e = front_err(torch, got, fr.plain(rows, valid))
            total = int(got.total)
            ids = torch.bincount(got.inv[:total] + 1,
                                 minlength=len(names) + 1).tolist()
            print(f"safety front {shape} [{b},{fr.sw}] {lname}, {kind} "
                  f"window: P={int(got.P)} total={total} lanes by first "
                  f"failing id (none, then the list's) {ids} "
                  f"max_abs_err={e}")
            need(e == 0.0, f"chunk_front with the suite ({lname}) differs "
                 f"from front_plain on the {shape} {kind} window")
            if kind == "real":
                need(ids[0] == total, f"a reachable successor fails "
                     f"{lname} at {shape}")
            if kind == "crafted":
                first[lname] = {names[i - 1] for i, c in enumerate(ids)
                                if i and c}
            err = max(err, e)
    for name in SAFETY_SUITE:
        need(name in first["cfg order"] and name in first[name],
             f"no crafted lane at {shape} has {name} as its first failing "
             f"predicate ({first['cfg order']}, alone: {first[name]})")
    rows, valid = real
    plain, full = front(["TypeOK"]), front(list(invs))
    need(not plain.suite, "the TypeOK front runs the suite's build")
    for what, fr in (("TypeOK", plain), ("the suite", full),
                     ("the suite", full), ("TypeOK", plain)):
        print(f"safety front {shape} real window, {what}: lanes launch "
              f"{lanes_us(torch, fr, rows, valid)} us under the profiler, "
              f"queued front {queued_ms(torch, lambda: fr(rows, valid))} "
              f"ms a call")
    for what, fr in (("TypeOK", plain), ("the suite", full)):
        print(f"safety front {shape}, {what}: lanes launch "
              f"{fr.launch_info()['lanes_kernel']}, blocks an SM "
              f"{fr.occupancy()}")
    del kinds, real
    torch.cuda.empty_cache()
    return err


def phase_safety_cfg(torch, turns):
    """configs/MCraft_safety.cfg as written (TypeOK and the nine),
    cut only in depth: L11 on v4 with the fused and the split tail and L9
    on v3, each with MCraft_bounded's pinned counts and levels (the suite
    holds on every reachable state) and its launches checked; the wall
    time beside MCraft_bounded's L11 of the same tail in ``turns``."""
    from raft_tla_tpu_torch.engine.check import run_check
    bounded = {m: [r.wall_seconds for mm, r in turns if mm == m]
               for m in ("fused", "kernel")}
    for pipeline, method, depth in (("v4", "fused", 11),
                                    ("v4", "kernel", 11),
                                    ("v3", "fused", 9)):
        reset_counts()
        res = run_check(os.path.join(HERE, "configs/MCraft_safety.cfg"),
                        bounded_config(pipeline, depth,
                                       enqueue_method=method),
                        device="cuda")
        counts = read_counts()
        what = f"MCraft_safety L{depth} {pipeline} {method} tail"
        print(f"{what}: invariants {res.engine.inv_names} "
              f"distinct={res.distinct} generated={res.generated} "
              f"levels={res.levels} batches={res.batches} check "
              f"{res.wall_seconds} s (MCraft_bounded, TypeOK alone, L11 "
              f"in this run: {bounded.get(method) if depth == 11 else '-'}"
              f" s), phases {res.phases}, launches {counts}")
        need(len(res.engine.inv_names) == 10, f"{what}: the cfg resolved "
             f"to {res.engine.inv_names}")
        need(res.violation is None and res.deadlock is None,
             f"{what} reported a violation or deadlock")
        pins = ((MCRAFT_L11_DISTINCT, MCRAFT_L11_GENERATED,
                 MCRAFT_L11_LEVELS) if depth == 11 else
                (MCRAFT_L9_DISTINCT, MCRAFT_L9_GENERATED, MCRAFT_L9_LEVELS))
        need((res.distinct, res.generated, res.levels) == pins,
             f"{what} differs from the pinned counts")
        check_launches(pipeline, counts, res.steps, what, method,
                       inserts=1)


def phase_safety_tpuraft(torch):
    """configs/TPUraft.cfg with its TypeOK replaced by TypeOK and the
    nine, at the cfg's sizes on v4 with the fused tail, to L8: no
    violation and the oracle's counts (the suite holds).  In turns with
    TypeOK alone (TypeOK, the suite, the suite, TypeOK): the wall times
    of the two lists within one call."""
    walls = []
    for label, invs in (("TypeOK", ["TypeOK"]),
                        ("the suite", ["TypeOK", *SAFETY_SUITE]),
                        ("the suite", ["TypeOK", *SAFETY_SUITE]),
                        ("TypeOK", ["TypeOK"])):
        engine, res, _peak = tpuraft_check(
            torch, "TPUraft.cfg", 8, f"TPUraft L8 v4 fused tail, {label}",
            invariants=invs, pipeline="v4", enqueue_method="fused",
            record_trace=False)
        need(engine.inv_names == invs, f"the list resolved to "
             f"{engine.inv_names}")
        walls.append(f"({label}, {res.wall_seconds} s)")
        del engine
    print("TPUraft L8 v4 fused, TypeOK and the suite in turns, as (list, "
          "check seconds): " + ", ".join(walls))


def phase_smoke_init(torch):
    """The SmokeInit check of tests/test_torch_safety_engine.py on v4 with
    the fused tail: 512 roots of seed SMOKE_SEED, the SMOKE_INVARIANTS;
    the verdict, the invariant, the depth, the counts and the replayed
    trace equal the JAX engine's (SMOKE_PIN, SMOKE_PATH).  The violation
    lies at depth 1, so the front kernel finds it."""
    from raft_tla_tpu_torch.engine.bfs import EngineConfig
    from raft_tla_tpu_torch.engine.check import initial_states, make_engine
    from raft_tla_tpu_torch.models.schema import encode_state, stack_states
    from raft_tla_tpu_torch.utils.cfg import load_config
    setup = dataclasses.replace(
        load_config(os.path.join(HERE, "configs/MCraft_safety.cfg")),
        smoke=True, smoke_k=2, invariants=list(SMOKE_INVARIANTS))
    roots = initial_states(setup, seed=SMOKE_SEED)
    engine = make_engine(setup, EngineConfig(**SMOKE_CONFIG, pipeline="v4"),
                         device="cuda")
    reset_counts()
    res = engine.run(roots)
    counts = read_counts()
    need(res.violation is not None, "the SmokeInit check found no "
         "violation")
    path = engine.replay(res.violation.fingerprint)
    fps = []
    for g, st in path:
        hi, lo = engine._fingerprint(stack_states(
            [encode_state(st, setup.dims)], engine.device))
        fps.append((g, int(hi[0]) << 32 | int(lo[0])))
    got = (res.violation.invariant, len(path) - 1, res.distinct,
           res.generated, res.levels, res.violation.fingerprint)
    print(f"SmokeInit check (seed {SMOKE_SEED}, {len(roots)} roots, "
          f"{list(SMOKE_INVARIANTS)}) v4: {got[0]} at depth {got[1]}, "
          f"distinct={got[2]} generated={got[3]} levels={got[4]} fp "
          f"{got[5]:#018x}, path {[(g, hex(f)) for g, f in fps]}, "
          f"launches {counts}")
    need(got == SMOKE_PIN and fps == SMOKE_PATH,
         f"the SmokeInit check differs from its JAX pin {SMOKE_PIN} "
         f"{SMOKE_PATH}")
    check_launches("v4", counts, res.steps, "SmokeInit check", trace=True)


# -- the reconfiguration variant (models/reconfig.py, configs/reconfig3.cfg) --

# The JAX package's pins of configs/reconfig3.cfg (BASELINE.md §b,
# artifacts/reconfig3_L1{1,2}_engine.txt): enqueued states a level, and
# cumulative distinct / generated; the L12 generated counts a family.
RECONFIG_LEVELS = [1, 3, 18, 79, 318, 1218, 4433, 15510, 52467, 172129,
                   548904, 1703691, 5151718]
RECONFIG_DISTINCT = {11: 6005270, 12: 19780533}
RECONFIG_GENERATED = {11: 17354943, 12: 57713052}
RECONFIG_L12_FAMILIES = {
    "Restart": 7496313, "Timeout": 7495146, "RequestVote": 13861020,
    "BecomeLeader": 2883, "ClientRequest": 1167, "AdvanceCommitIndex": 1167,
    "AppendEntries": 2334, "Receive": 9617343, "DuplicateMessage": 9617343,
    "DropMessage": 9617343, "InitiateReconfig": 993, "FinalizeReconfig": 0}
# The three leader roots (leader_roots below) of reconfig3's dims, checked
# to depth D with no deadlock check and TypeOK off, by the JAX BFSEngine
# on the CPU: levels, distinct, generated and the families named.
LEADER_LEVELS = [3, 21, 114, 507, 1981, 7059, 23339, 72611, 214306, 604216,
                 1637190]
LEADER_PINS = {
    8: (710057, 1938892, {"InitiateReconfig": 31577,
                          "FinalizeReconfig": 22, "BecomeLeader": 0}),
    10: (6702113, 18921667, {
        "Restart": 2772471, "Timeout": 2388597, "RequestVote": 3509091,
        "BecomeLeader": 204, "ClientRequest": 383874,
        "AdvanceCommitIndex": 383874, "AppendEntries": 767748,
        "Receive": 2835330, "DuplicateMessage": 2835970,
        "DropMessage": 2835970, "InitiateReconfig": 207836,
        "FinalizeReconfig": 702})}
# reconfig3.cfg sets no engine sizes: the main path's batch, and tables
# that hold its L12 (5,151,718 rows in the last level, 19.8M keys).
RECONFIG_SIZES = dict(batch=B, queue_capacity=1 << 23, seen_capacity=1 << 26)


def leader_roots(dims):
    """scripts/leader_bench.py ``leader_states(dims, bounds, 0)``, built
    directly: for each server, the state its canonical election leaves
    (term 1 -> 2 by Timeout, every other server's vote granted and home,
    the bag emptied, BecomeLeader)."""
    from raft_tla_tpu_torch.models.dims import FOLLOWER, LEADER
    from raft_tla_tpu_torch.models.pystate import init_state
    n = dims.n_servers
    full = (1 << n) - 1
    s0 = init_state(dims)
    out = []
    for lead in range(n):
        out.append(dataclasses.replace(
            s0, current_term=(2,) * n,
            role=tuple(LEADER if j == lead else FOLLOWER for j in range(n)),
            voted_for=tuple(0 if j == lead else lead + 1 for j in range(n)),
            votes_responded=tuple(full & ~(1 << lead) if j == lead else 0
                                  for j in range(n)),
            votes_granted=tuple(full & ~(1 << lead) if j == lead else 0
                                for j in range(n)),
            next_index=((1,) * n,) * n, match_index=((0,) * n,) * n))
    return out


def reconfig_config(pipeline, depth, **kw):
    from raft_tla_tpu_torch.engine.bfs import EngineConfig
    base = dict(RECONFIG_SIZES, record_trace=False, max_diameter=depth,
                pipeline=pipeline)
    base.update(kw)
    return EngineConfig(**base)


def family_lanes(dims, out):
    """``{family: live lanes}`` of one front call's output."""
    total = int(out.total)
    fam = [dims.family_names[dims.instance_info(g)[0]]
           for g in range(dims.n_instances)]
    acts = (out.lane_id[:total].long() % dims.n_instances).cpu().tolist()
    return dict(collections.Counter(fam[a] for a in acts))


def captured_windows(torch, setup, roots, depth, last_full=False):
    """The parent windows a v4 check of ``setup`` from ``roots`` to
    ``depth`` dispatched (steps dispatched eagerly so a hook sees each):
    every window with a valid row, or only the last full one.  Returns
    (windows, result)."""
    from raft_tla_tpu_torch.engine.check import make_engine
    engine = make_engine(setup, reconfig_config("v4", depth),
                         device="cuda")
    dispatch_eagerly(engine)
    body, windows = engine._step.body, []

    def capture(rows, valid, *args):
        if bool(valid.all() if last_full else valid.any()):
            if last_full:
                windows.clear()
            windows.append((rows.clone(), valid.clone()))
        return body(rows, valid, *args)

    engine._step.body = capture
    res = engine.run(roots)
    del engine
    return windows, res


def phase_reconfig_front(torch, device):
    """B4's reconfig build (the masks and lanes launches' kReconfig
    builds) held exactly against ``front_plain`` at reconfig3's shapes
    (474-byte rows, G 114, batch 2048, K 32,768) on three windows: a full
    window of the L11 frontier (the last a check to L12 dispatched); a
    window of the leader roots' depth-6..8 states holding the parents of
    every FinalizeReconfig lane to D8, InitiateReconfig parents and
    states with config entries; and those states with every config value
    replaced by one whose low byte is client value 1 (joint_value(7, 1),
    final_value(1): with TargetConfigs {3, 7} no reachable one has it),
    the alias a row without the high planes would read.  Then the build
    timed on the L11 window (one call, queued, plain, bound in bytes) and
    its launches' registers, spills, shared memory and blocks an SM, with
    the spec's builds' beside them."""
    from raft_tla_tpu_torch.engine.check import (initial_states,
                                                 resolve_constraint,
                                                 resolve_invariants)
    from raft_tla_tpu_torch.models.actions2 import build_v2
    from raft_tla_tpu_torch.models.reconfig import (CFG_BASE, final_value,
                                                    joint_value)
    from raft_tla_tpu_torch.models.schema import (flatten_state,
                                                  state_width,
                                                  unflatten_state)
    from raft_tla_tpu_torch.ops import chunk_front_cuda
    from raft_tla_tpu_torch.utils.cfg import load_config
    setup = load_config(os.path.join(HERE, "configs/reconfig3.cfg"))
    dims = setup.dims
    t = time.time()
    wins, res = captured_windows(torch, setup, initial_states(setup), 12,
                                 last_full=True)
    need(res.distinct == RECONFIG_DISTINCT[12] and wins,
         f"the capture run to L12 gave {res.distinct} distinct")
    l11 = wins[-1]
    del wins
    fin_g = dims.family_offsets[11]
    ini_g = dims.family_offsets[10]
    v2 = build_v2(dims, device)
    pool, _res = captured_windows(torch, setup, leader_roots(dims), 8)
    rows = torch.cat([r[v] for r, v in pool])
    en = torch.cat([v2.masks(unflatten_state(rows[i:i + B], dims))[0]
                    for i in range(0, rows.shape[0], B)])
    fin = en[:, fin_g:].any(1)
    ini = en[:, ini_g:fin_g].any(1)
    st = unflatten_state(rows, dims)
    has_cfg = ((st.log_val >= CFG_BASE).flatten(1).any(1)
               | (st.msg >= CFG_BASE).flatten(1).any(1))
    pick = torch.cat([fin.nonzero()[:, 0], ini.nonzero()[:, 0][:B // 4],
                      has_cfg.nonzero()[:, 0]])
    pick = pick[:B]
    need(int(fin.sum()) > 0 and pick.shape[0] == B, "the leader pool has "
         f"{int(fin.sum())} FinalizeReconfig parents, {pick.shape[0]} picks")
    leader = (rows[pick].contiguous(),
              torch.ones(B, dtype=torch.bool, device=device))
    # The wrap trap: config values with a client value's low byte.
    alias = {joint_value(7, 3): joint_value(7, 1),
             joint_value(3, 7): joint_value(1, 7),
             final_value(3): final_value(1), final_value(7): joint_value(3, 1)}
    lst = unflatten_state(leader[0], dims)
    lv, msg = lst.log_val.clone(), lst.msg.clone()
    for a, b in alias.items():
        lv[lv == a] = b
        msg[msg == a] = b
    trap = (flatten_state(lst._replace(log_val=lv, msg=msg), dims),
            leader[1])
    need(bool(((lv & 0xFF) == 1).logical_and(lv >= CFG_BASE).any()),
         "the trap window holds no aliasing config value")
    print(f"reconfig front: windows built in {time.time() - t} s "
          f"(pool {rows.shape[0]} rows, {int(fin.sum())} FinalizeReconfig "
          f"and {int(ini.sum())} InitiateReconfig parents)")
    front = chunk_front_cuda.Front(
        dims=dims, v2=v2, inv_fns=list(resolve_invariants(setup).values()),
        constraint=resolve_constraint(setup), B=B, K=K, device=device)
    need(front.reconfig and not front.suite, "the front for reconfig3 is "
         "not the variant's build")
    err = 0.0
    for name, (r, v) in (("L11 frontier", l11), ("leader roots D6-8",
                                                 leader),
                         ("low-byte alias", trap)):
        got = front(r, v)
        want = front.plain(r, v)
        e = front_err(torch, got, want)
        total = int(got.total)
        fams = family_lanes(dims, got)
        print(f"reconfig front {name} window [{B},{front.sw}]: P="
              f"{int(got.P)} total={total} lanes by family {fams} "
              f"TypeOK fails={int((got.inv[:total] >= 0).sum())} "
              f"constraint fails={int((~got.cons_ok[:total]).sum())} "
              f"max_abs_err={e}")
        need(e == 0.0, f"the reconfig front differs from front_plain on the "
             f"{name} window")
        if name == "leader roots D6-8":
            need(fams.get("FinalizeReconfig", 0) > 0
                 and fams.get("InitiateReconfig", 0) > 0,
                 "the leader window has no lanes of the extra families")
        err = max(err, e)
    rows, valid = l11
    out = front(rows, valid)
    total = int(out.total)
    nbytes = front_bytes(dims, B, K, total)
    row = dict(
        launches=None, max_abs_err=err,
        ms=cuda_ms(torch, lambda: front(rows, valid), 50),
        queued_ms=queued_ms(torch, lambda: front(rows, valid)),
        plain_ms=cuda_ms(torch, lambda: front.plain(rows, valid), 5),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None)
    print(f"reconfig front [{B},{state_width(dims)}] -> K={K} (total "
          f"{total}), L11 window: one call {row['ms']} ms, queued "
          f"{row['queued_ms']} ms, plain {row['plain_ms']} ms, bound "
          f"{row['bound_ms']} ms ({nbytes} bytes); device microseconds "
          f"{device_ops(torch, lambda: front(rows, valid))}")
    print(f"reconfig front launches: {front.launch_info()}; blocks an SM "
          f"{front.occupancy()}")
    base = load_config(os.path.join(HERE, "configs/MCraft_safety.cfg"))
    binv = resolve_invariants(base)
    for what, names in (("TypeOK", ["TypeOK"]), ("the suite", list(binv))):
        fr = chunk_front_cuda.Front(
            dims=base.dims, v2=build_v2(base.dims, device),
            inv_fns=[binv[n] for n in names],
            constraint=resolve_constraint(base), B=B, K=K, device=device)
        print(f"spec front, {what}: launches {fr.launch_info()}; blocks an "
              f"SM {fr.occupancy()}")
    del l11, pool, rows, en, st, leader, trap
    torch.cuda.empty_cache()
    return row


def reconfig_check(torch, roots_of, depth, what, pipeline, method="fused",
                   **kw):
    """reconfig3.cfg as written (its invariants, constraint, dims) on the
    card from ``roots_of(setup)`` to ``depth`` through ``make_engine``:
    result, launches, wall and peak device memory printed."""
    from raft_tla_tpu_torch.engine.check import make_engine
    from raft_tla_tpu_torch.utils.cfg import load_config
    setup = load_config(os.path.join(HERE, "configs/reconfig3.cfg"))
    if kw.pop("leader", False):
        setup = dataclasses.replace(setup, invariants=[],
                                    check_deadlock=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.time()
    engine = make_engine(setup, reconfig_config(
        pipeline, depth, enqueue_method=method, **kw), device="cuda")
    res = engine.run(roots_of(setup))
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"{what}: distinct={res.distinct} generated={res.generated} "
          f"levels={res.levels} stop={res.stop_reason} batches="
          f"{res.batches} steps={res.steps} growths={res.growth_stalls} "
          f"families {res.action_counts}")
    print(f"{what}: check {res.wall_seconds} s, call {wall} s, "
          f"{res.states_per_second} distinct/s, phases {res.phases}, peak "
          f"device memory allocated {peak} bytes, launches {counts}")
    need(res.violation is None and res.deadlock is None,
         f"{what} reported a violation or deadlock")
    check_launches(pipeline, counts, res.steps, what, method,
                   trace=engine.config.record_trace)
    return engine, res, counts


def phase_reconfig_cfg(torch):
    """configs/reconfig3.cfg (TypeOK, BoundedSpace, 12 families) at
    RECONFIG_SIZES: to L12 on v4 with the fused tail against the JAX
    pins (distinct, generated, the 13 levels, every family's count), to
    L11 on v3 and on v4 with the split tail (6,005,270 / 17,354,943), and
    a level-10 snapshot resumed to L12 with the L12 pins.  Then the v4
    L10 profile (device time a batch).  Returns the launches of the L12
    run."""
    from raft_tla_tpu_torch.engine import checkpoint as ckpt
    from raft_tla_tpu_torch.engine.check import initial_states, make_engine
    from raft_tla_tpu_torch.utils.cfg import load_config
    _e, res, counts = reconfig_check(torch, initial_states, 12,
                                     "reconfig3 L12 v4 fused tail", "v4")
    need((res.distinct, res.generated, res.levels, res.action_counts)
         == (RECONFIG_DISTINCT[12], RECONFIG_GENERATED[12], RECONFIG_LEVELS,
             RECONFIG_L12_FAMILIES), "reconfig3 L12 differs from its pins")
    for pipeline, method in (("v3", "fused"), ("v4", "kernel")):
        _e, r11, _c = reconfig_check(
            torch, initial_states, 11,
            f"reconfig3 L11 {pipeline} {method} tail", pipeline, method)
        need((r11.distinct, r11.generated, r11.levels)
             == (RECONFIG_DISTINCT[11], RECONFIG_GENERATED[11],
                 RECONFIG_LEVELS[:12]), "reconfig3 L11 differs from its pins")
    setup = load_config(os.path.join(HERE, "configs/reconfig3.cfg"))
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_reconfig_")
    try:
        make_engine(setup, reconfig_config(
            "v4", 10, checkpoint_dir=ckdir, checkpoint_every=10),
            device="cuda").run(initial_states(setup))
        path = ckpt.latest(ckdir)
        need(path is not None and path.endswith("level_00010.npz"),
             f"no level-10 snapshot in {sorted(os.listdir(ckdir))}")
        ck = ckpt.load(path)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    need(type(ck.dims).__name__ == "ReconfigDims"
         and ck.frontier.shape == (RECONFIG_LEVELS[10], 474),
         f"the level-10 snapshot holds {ck.dims} {ck.frontier.shape}")
    reset_counts()
    rr = make_engine(setup, reconfig_config("v4", 12), device="cuda").run(
        resume=ck)
    print(f"reconfig3 resume L10 -> L12 v4: distinct={rr.distinct} "
          f"generated={rr.generated} levels={rr.levels} check "
          f"{rr.wall_seconds} s, launches {read_counts()}")
    need((rr.distinct, rr.generated, rr.levels, rr.action_counts)
         == (RECONFIG_DISTINCT[12], RECONFIG_GENERATED[12], RECONFIG_LEVELS,
             RECONFIG_L12_FAMILIES), "the resumed reconfig3 run differs "
         "from the L12 pins")
    phase_profile(torch, "v4", cfg_name="reconfig3.cfg",
                  config=reconfig_config("v4", 10))
    return counts


def phase_reconfig_leader(torch):
    """The three leader roots (``leader_roots``) of reconfig3's dims, with
    BoundedSpace and neither TypeOK nor the deadlock check, to D10 on v4
    (trace on) and D8 on v3 against LEADER_PINS (FinalizeReconfig 702 and
    22); a state a FinalizeReconfig lane made at D10 replayed from the
    trace to its root."""
    from raft_tla_tpu_torch.models.reconfig import CFG_BASE
    for pipeline, depth in (("v4", 10), ("v3", 8)):
        engine, res, _c = reconfig_check(
            torch, lambda setup: leader_roots(setup.dims), depth,
            f"reconfig3 leader roots D{depth} {pipeline}", pipeline,
            leader=True, record_trace=depth == 10)
        distinct, generated, fams = LEADER_PINS[depth]
        need(res.distinct == distinct and res.generated == generated
             and res.levels == LEADER_LEVELS[:depth + 1]
             and all(res.action_counts[f] == c for f, c in fams.items()),
             f"the leader roots to D{depth} ({pipeline}) differ from the "
             "JAX engine's pins")
        if depth == 10:
            dims = engine.dims
            fin = dims.family_offsets[dims.family_names.index(
                "FinalizeReconfig")]
            tf, _tp, ta = engine.trace.export()
            at = [i for i, a in enumerate(ta.tolist()) if a >= fin]
            need(at, "the D10 trace holds no FinalizeReconfig record")
            path = engine.replay(int(tf[at[-1]]))
            g, last = path[-1]
            print(f"reconfig3 D10 replay of a FinalizeReconfig successor: "
                  f"{len(path) - 1} steps, last {dims.describe_instance(g)}"
                  f", logs {last.log}")
            need(g >= fin and len(path) - 1 <= depth
                 and any(v >= CFG_BASE for log in last.log
                         for _t, v in log), "the replayed FinalizeReconfig "
                 "path is wrong")


# -- the swarm and simulate tier (engine/swarm.py, engine/simulate.py) ----

SWARM_DIMS = dict(n_servers=3, n_values=2, max_log=4, n_msg_slots=32)
SWARM_BOUNDS = dict(max_term=2, max_log_len=1, max_msg_count=1)


def near_election_root(dims):
    """A candidate one vote short of quorum: NoLeaderElected falls two
    steps away (the JAX package's swarm and simulate tests use it)."""
    from raft_tla_tpu_torch.models.pystate import init_state
    return dataclasses.replace(
        init_state(dims), role=(1, 0, 0), current_term=(2, 2, 2),
        voted_for=(1, 1, 1), votes_responded=(0b001, 0, 0),
        votes_granted=(0b001, 0, 0),
        messages=frozenset({((1, 1, 0, 2, 1, ()), 1)}))


def check_walk_trace(torch, dims, trace, what, fp=None, reencode=False):
    """A replayed trace, step by step on the card: each recorded action is
    enabled on the threaded (never re-encoded) successor of the one
    before, and that successor's fingerprint is the next state's (the
    fingerprint does not depend on message-slot order); the last one is
    ``fp`` where given.  With ``reencode`` each state is encoded afresh
    before its action is applied, as the exhaustive engine's ``replay``
    numbers its actions."""
    from raft_tla_tpu_torch.models.actions2 import build_v2
    from raft_tla_tpu_torch.models.schema import encode_state, stack_states
    from raft_tla_tpu_torch.ops.fingerprint import build_fingerprint
    dev = torch.device("cuda")
    v2, fpf = build_v2(dims, dev), build_fingerprint(dims, dev)
    st = stack_states([encode_state(trace[0][1], dims)], dev)
    need(trace[0][0] == -1, f"{what}: the trace does not start at a root")
    for depth, (g, state) in enumerate(trace[1:], 1):
        if reencode:
            st = stack_states([encode_state(trace[depth - 1][1], dims)], dev)
        en, _ovf = v2.masks(st)
        need(0 <= g < en.shape[1] and bool(en[0, g]),
             f"{what}: action {g} at depth {depth} is not enabled")
        hi, lo, st = v2.lane_out(st, v2.parent_hash(st),
                                 torch.tensor([g], device=dev))
        whi, wlo = fpf(stack_states([encode_state(state, dims)], dev))
        need(int(hi[0]) == int(whi[0]) and int(lo[0]) == int(wlo[0]),
             f"{what}: the state at depth {depth} is not action {g}'s "
             "successor")
    if fp is not None:
        need((int(hi[0]) << 32 | int(lo[0])) == fp,
             f"{what}: the trace does not end on the latched fingerprint")
    print(f"{what}: trace of depth {len(trace) - 1} checked step by step "
          "(each action enabled, each successor's fingerprint the next)")


def swarm_eager(engine):
    """Run ``engine``'s chunks eagerly on the card (no graph)."""
    def runner(s, outs, res):
        ys = engine._ys(len(s.walk_ids))
        engine._chunk(s.carry, s.walk_ids, engine._roots, engine._ctl,
                      outs[s.index], ys)
        return ys
    engine._runner = runner
    return engine


def swarm_of(cfg_name, device="cuda", **kw):
    """A swarm of ``configs/<cfg_name>`` with its roots."""
    from raft_tla_tpu_torch.engine.check import initial_states, make_swarm
    from raft_tla_tpu_torch.utils.cfg import load_config
    setup = load_config(os.path.join(HERE, "configs", cfg_name))
    return make_swarm(setup, device=device, **kw), initial_states(setup)


def phase_swarm_parity(torch):
    """The swarm on the card against its pins: the canary (graph), a
    seeded violation equal to the CPU run, and the visited-fingerprint
    multiset of one MCraft_bounded run across batch and chunk sizes,
    graph and eager, card and CPU."""
    import numpy as np
    from raft_tla_tpu_torch.engine.check import (engine_config_from_backend,
                                                 initial_states, make_engine)
    from raft_tla_tpu_torch.engine.swarm import SwarmEngine
    from raft_tla_tpu_torch.models.dims import LEADER, RaftDims
    from raft_tla_tpu_torch.models.invariants import (Bounds,
                                                      build_constraint,
                                                      build_type_ok)
    from raft_tla_tpu_torch.utils.cfg import load_config
    t_phase = time.time()
    c = dict(CANARY)
    eng, roots = swarm_of(os.path.basename(c.pop("cfg")),
                          walks=c["walks"], max_depth=c["max_depth"],
                          chunk=c["chunk"], ring=c["ring"])
    # A warm run first (another seed), as the CI canary times its swarm:
    # the timed run then loads no kernel for the first time.
    need(eng.run(roots, seed=2, max_seconds=120).violation is not None,
         "swarm canary: the warm run found no violation")
    res = eng.run(roots, seed=c["seed"], max_seconds=120)
    got = (res.violation.invariant if res.violation else None,
           res.violation.fingerprint if res.violation else None,
           [g for g, _ in res.violation_trace or []], res.steps,
           res.visited, res.traces, res.diameter)
    print(f"swarm canary on the card (graph): {got}, violation at "
          f"{res.violation_at_seconds} s, wall {res.wall_seconds} s, "
          f"phases {res.phases}")
    need(got == CANARY_PIN, f"swarm canary {got} != the pin {CANARY_PIN}")
    check_walk_trace(torch, eng.dims, res.violation_trace, "swarm canary",
                     res.violation.fingerprint)
    canary_at = res.violation_at_seconds
    # The exhaustive check of the same cfg on the card, for the time to
    # the violation beside the swarm's (reported, not gated).
    setup = load_config(os.path.join(HERE, CANARY["cfg"]))
    for pipeline in ("v3", "v4"):
        bfs = make_engine(setup, dataclasses.replace(
            engine_config_from_backend(setup), pipeline=pipeline),
            device="cuda").run(initial_states(setup))
        need(bfs.violation is not None, "MCraft_noleader: no violation")
        print(f"time to NoLeaderElected on the card: swarm {canary_at} s "
              f"(256 walks, seed 3) beside the exhaustive check's "
              f"{bfs.wall_seconds} s ({bfs.distinct} distinct, {pipeline}, "
              "the cfg's sizes)")

    dims = RaftDims(**SWARM_DIMS)
    root = near_election_root(dims)

    def seeded(device):
        e = SwarmEngine(
            dims, invariants={"TypeOK": build_type_ok(dims),
                              "NoLeader": lambda st: (st.role != LEADER)
                              .all(1)},
            constraint=build_constraint(dims, Bounds(**SWARM_BOUNDS)),
            walks=32, max_depth=8, chunk=8, ring=8, device=device)
        r = e.run([root], seed=1, num_steps=64)
        return r, (r.violation.invariant if r.violation else None,
                   r.violation.fingerprint if r.violation else None,
                   r.violation_step, r.violation_walk, r.steps, r.visited,
                   r.traces, r.diameter, r.violation_trace)

    r_card, card = seeded("cuda")
    _r, cpu = seeded("cpu")
    print(f"swarm seeded violation: card {card[:8]}, trace "
          f"{[g for g, _ in card[8]]}")
    need(card[0] == "NoLeader", "the seeded swarm run did not latch")
    need(card == cpu, f"the seeded swarm run differs on the card "
         f"{card[:8]} and the CPU {cpu[:8]}")
    check_walk_trace(torch, dims, r_card.violation_trace,
                     "swarm seeded violation", r_card.violation.fingerprint)

    def multiset(device="cuda", eager=False, walks=4096, steps=128, **kw):
        e, rts = swarm_of("MCraft_bounded.cfg", device=device, walks=walks,
                          max_depth=64, collect_fingerprints=True, **kw)
        if eager:
            swarm_eager(e)
        r = e.run(rts, seed=7, num_steps=steps)
        f = r.visited_fingerprints
        return r, f[np.lexsort((f[:, 1], f[:, 0]))]

    base, want = multiset(batch=4096, chunk=32)
    print(f"swarm multiset MCraft_bounded 4096 walks x 128 steps: visited "
          f"{base.visited} traces {base.traces} deepest {base.diameter}")
    for what, kw in (("batch 1024", dict(batch=1024, chunk=32)),
                     ("batch 1000 (a 96-walk remainder slice)",
                      dict(batch=1000, chunk=32)),
                     ("chunk 8", dict(batch=4096, chunk=8)),
                     ("eager on the card", dict(batch=4096, chunk=32,
                                                eager=True))):
        r, f = multiset(**kw)
        need(np.array_equal(f, want) and r.visited == base.visited
             and r.traces == base.traces, f"swarm multiset at {what} "
             "differs from batch 4096 chunk 32 (graph)")
        print(f"swarm multiset at {what}: identical ({f.shape[0]} visits)")
    # The card, sliced with a remainder, against the CPU in one dispatch,
    # on a run the CPU finishes in seconds (4,096 x 128 would take 8x).
    rc, fc = multiset(walks=1024, steps=64, batch=1000, chunk=32)
    t_cpu = time.time()
    rp, fp_ = multiset(device="cpu", walks=1024, steps=64, batch=1024,
                       chunk=32)
    t_cpu = time.time() - t_cpu
    need(np.array_equal(fc, fp_) and rc.traces == rp.traces,
         "swarm multiset differs on the card and the CPU")
    print(f"swarm multiset 1024 walks x 64 steps: the card at batch 1000 "
          f"(a 24-walk remainder slice) and the CPU at 1024 identical "
          f"({fc.shape[0]} visits; the CPU run {t_cpu} s); phase "
          f"{time.time() - t_phase} s")


#: The throughput runs: (cfg, walks, lanes a dispatch, profiled), None for
#: the CLI's own default (the BATCH directive, else the walks up to
#: 65,536; so one dispatch at MCraft_bounded and two of 8,192 at TPUraft),
#: and 1,024 a dispatch, the JAX CLI's default (16 dispatches, whose
#: profile would hold ~700k launches: their device ops are 16 times the
#: 1,024-walk run's).
SWARM_RUNS = (("MCraft_bounded.cfg", 1024, None, True),
              ("MCraft_bounded.cfg", 16384, None, True),
              ("MCraft_bounded.cfg", 65536, None, True),
              ("TPUraft.cfg", 16384, None, True),
              ("TPUraft.cfg", 16384, 16384, True),
              ("MCraft_bounded.cfg", 16384, 1024, False))


def timed_swarm(torch, eng):
    """Time each slice's chunk on the device: CUDA events around every
    dispatch (staging and graph replay; the graph captured before the
    first event); returns the list of each chunk's device milliseconds,
    read after the run."""
    pairs = []
    run_slice = eng._runner

    def runner(s, outs, res):
        if s.index == 0:
            pairs.append([])
        eng._graph(len(s.walk_ids), res)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        ys = run_slice(s, outs, res)
        b.record()
        pairs[-1].append((a, b))
        return ys
    eng._runner = runner

    def chunk_ms():
        torch.cuda.synchronize()
        return [sum(a.elapsed_time(b) for a, b in p) for p in pairs]
    return chunk_ms


def swarm_throughput(torch, cfg_name, walks, batch, profile=True,
                     steps=128, turn=""):
    """One throughput run (``batch`` lanes a dispatch, the CLI's default
    where None): steps/s, visited/s, traces, host seconds a chunk, each
    chunk's device milliseconds between CUDA events, peak device memory,
    then (``profile``) device ops and device time a step of one more
    chunk under the profiler."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kw = {} if batch is None else dict(batch=batch)
    eng, roots = swarm_of(cfg_name, walks=walks, max_depth=128, ring=16,
                          chunk=32, **kw)
    chunk_ms = timed_swarm(torch, eng)
    res = eng.run(roots, seed=11, num_steps=steps)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = chunk_ms()
    what = (f"swarm {cfg_name[:-4]} {walks} walks, {eng.batch} a dispatch"
            f"{' (the CLI default)' if batch is None else ''}{turn}")
    need(res.stop_reason == "steps" and res.steps == walks * steps,
         f"{what}: stop {res.stop_reason} after {res.steps} steps")
    print(f"{what}: {res.steps} steps in {res.wall_seconds} s = "
          f"{res.steps_per_second} steps/s, {res.states_per_second} "
          f"visited/s, visited {res.visited}, traces {res.traces}, deepest "
          f"{res.diameter}, host seconds a chunk "
          f"{res.wall_seconds / res.chunks} (phases {res.phases}, "
          f"{res.chunks} chunks), device ms a step between events "
          f"{sum(ms) / steps} (each chunk's ms {ms}; events over wall "
          f"{sum(ms) / 1e3 / res.wall_seconds}), peak device memory "
          f"allocated {peak} B")
    if not profile:
        return
    ops = device_ops(torch, lambda: eng.run(roots, seed=12,
                                            num_steps=eng.chunk))
    if not ops:
        print(f"{what}: the profiler saw no device time (not measured)")
        return
    print(f"{what}: {len(ops) / eng.chunk} device ops a step, device time "
          f"a step {sum(us for _n, us in ops) / eng.chunk} us (profiler, "
          f"one chunk of {eng.chunk} steps)")


def phase_swarm_throughput(torch, turns=False):
    """The throughput runs, each profiled after its timed run; with
    ``turns`` all of them timed once before any profile of this phase and
    once more after the last."""
    t = time.time()
    if turns:
        for run in SWARM_RUNS:
            swarm_throughput(torch, *run[:3], profile=False,
                             turn=", before the profiles")
    for run in SWARM_RUNS:
        swarm_throughput(torch, *run)
    if turns:
        for run in SWARM_RUNS:
            swarm_throughput(torch, *run[:3], profile=False,
                             turn=", after the profiles")
    print(f"swarm throughput phase: {time.time() - t} s")


def phase_simulate(torch, num_steps=1 << 21):
    """The BASELINE simulate workload through the CLI's code (cut to
    ``num_steps``), a seeded violation replayed and checked, two replays
    of the graph from one state drawing differently, and a seed repeating
    its run."""
    from raft_tla_tpu_torch import cli
    from raft_tla_tpu_torch.engine.simulate import Simulator
    from raft_tla_tpu_torch.models.dims import LEADER, RaftDims
    from raft_tla_tpu_torch.models.invariants import Bounds, build_constraint
    t_phase = time.time()
    buf = io.StringIO()
    t = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["simulate", os.path.join(HERE,
                                                "configs/MCraft_bounded.cfg"),
                       "--batch", "1024", "--depth", "100", "--num-steps",
                       str(num_steps)])
    out = buf.getvalue()
    print(f"simulate MCraft_bounded --batch 1024 --depth 100 --num-steps "
          f"{num_steps} (the CLI, call {time.time() - t} s): "
          + " | ".join(out.splitlines()[:4]))
    need(rc == 0 and "VIOLATION" not in out,
         "simulate MCraft_bounded: TypeOK failed or the run failed")
    need(out.startswith(f"steps visited      "
                        f"{-(-num_steps // (1024 * 128)) * 1024 * 128}\n"),
         "simulate MCraft_bounded: steps differ from the budget")

    dims = RaftDims(**dict(SWARM_DIMS, n_msg_slots=24))
    root = near_election_root(dims)

    def near_election():
        return Simulator(
            dims, invariants={"NoLeader": lambda st: (st.role != LEADER)
                              .all(1)},
            constraint=build_constraint(
                dims, Bounds(max_term=3, max_log_len=1, max_msg_count=1)),
            batch=32, depth=16, chunk=64, device="cuda")

    sim = near_election()
    runs = [sim.run([root], num_steps=32 * 64 * 8, seed=0)
            for _ in range(2)]
    runs.append(near_election().run([root], num_steps=32 * 64 * 8, seed=0))
    r = runs[0]
    need(r.violation_invariant == "NoLeader" and
         LEADER in r.violation_state.role,
         "simulate: the seeded run found no leader")
    check_walk_trace(torch, dims, r.violation_trace,
                     "simulate seeded violation")
    keys = [(x.steps, x.traces, x.violation_trace) for x in runs]
    need(keys[0] == keys[1] == keys[2],
         "simulate: a seed does not repeat its run")
    print(f"simulate seeded violation: steps {r.steps} traces {r.traces} "
          f"trace {[g for g, _ in r.violation_trace]}, repeated by the "
          "same simulator and a fresh one")
    # Two replays of the graph from the same walker state must draw anew.
    g, _n = sim._graph
    start = {k: v.clone() for k, v in sim._w.items()}
    ends = []
    for _ in range(2):
        for k, v in start.items():
            sim._w[k].copy_(v)
        sim._acc.copy_(sim._acc0)
        g.replay()
        ends.append(sim._w["abuf"].clone())
    need(not torch.equal(ends[0], ends[1]),
         "simulate: two graph replays from one state drew the same actions")
    print(f"simulate: two graph replays from one state drew differently; "
          f"phase {time.time() - t_phase} s")


# -- the mesh (parallel/mesh.py, parallel/simulate.py) -----------------------

#: __graft_entry__.py's dryrun model and what the JAX mesh gives for it
#: (tests/test_mesh.py test_dryrun_ground_truth_pinned): distinct, diameter.
DRYRUN_DIMS = dict(n_servers=2, n_values=1, max_log=2, n_msg_slots=8)
DRYRUN_BOUNDS = dict(max_term=2, max_log_len=1, max_msg_count=1,
                     max_in_flight=2)
DRYRUN_PIN = (46553, 31)


def check_mesh_launches(counts, steps, n, what, trace=False, inserts=None):
    """A mesh step launches the compaction, the insert (on each owner) and
    the enqueue once on each of the n shards, and with trace recording
    the enqueue once more on each (the trace append); never the fused tail
    nor the front.  ``inserts``, where given, is the exact number of
    insert launches outside the steps (root ingest, growth, a resume's
    rebuild)."""
    ok = counts["compact"] == n * steps > 0
    ok = ok and counts["fused_tail"] == 0 and counts["chunk_front"] == 0
    ok = ok and counts["enqueue"] == n * steps * (2 if trace else 1)
    outside = counts["fpset_insert"] - n * steps
    ok = ok and (outside >= 0 if inserts is None else outside == inserts)
    need(ok, f"{what}: mesh launches {counts} over {steps} steps of {n} "
         "shards")


def mesh_run(torch, cfg_name, n, config, devices=None, resume=None):
    """``(result, engine, launches, call seconds)`` of a mesh check of
    ``configs/<cfg_name>`` over n logical shards on the card (or
    ``devices``)."""
    from raft_tla_tpu_torch.engine.check import run_check
    torch.cuda.synchronize()
    reset_counts()
    t = time.time()
    res = run_check(os.path.join(HERE, "configs", cfg_name), config,
                    device="cuda", engine_cls="mesh", resume=resume,
                    devices=devices or ["cuda"] * n)
    torch.cuda.synchronize()
    return res, res.engine, read_counts(), time.time() - t


def mesh_tables(torch, n, device, load, present):
    """n owner tables of SEEN / n slots, each holding ``load`` of its
    slots in random keys it owns, and the ``present`` keys on their
    owners."""
    from raft_tla_tpu_torch.ops import fpset
    from raft_tla_tpu_torch.ops.fpset_cuda import insert
    gen = torch.Generator(device=device)
    gen.manual_seed(20261017 + n)
    tables = []
    for d in range(n):
        s = fpset.empty(SEEN // n, device)
        m = int(load * s.capacity)
        hi = torch.randint(0, (1 << 32) // n, (m,), generator=gen,
                           device=device) * n + d
        lo = torch.randint(0, 1 << 32, (m,), generator=gen, device=device)
        keys = torch.unique(fpset.pack(hi, lo))
        mine = present[((present >> 32) & 0xFFFFFFFF) % n == d]
        for q in (keys, mine):
            for base in range(0, q.shape[0], 1 << 20):
                part = q[base:base + (1 << 20)]
                _new, fail = insert(s, part, torch.ones_like(part,
                                                             dtype=torch.bool))
                need(not bool(fail), "mesh table prefill probe failure")
        tables.append(s)
    return tables


def phase_mesh_insert(torch, device, keys, kvalid):
    """The routed insert (``parallel/mesh.py route_insert``) at the main
    path's shapes: n = 2 and 8 logical shards of K = 32,768 lanes each,
    made from a real L8 batch (rolled per shard, so every key arrives
    from every shard; a block of lanes copied within each shard; a third
    of each shard's lanes given its own high bits, so owners differ),
    into owner tables of 2^25 / n slots at load 0.4 that already hold a
    quarter of the batch's keys.  The kernel (the insert once on each
    owner over n·K arrivals) must equal the same routing on host copies
    through ``insert_plain``: ``is_new`` of every lane, each shard's key
    set and size, no key off its owner.  Timed: one routed call between
    two CUDA events, on fresh copies of the tables."""
    from raft_tla_tpu_torch.ops import fpset_cuda
    from raft_tla_tpu_torch.ops.fpset import EMPTY
    from raft_tla_tpu_torch.parallel.mesh import route_insert
    out = {}
    present = keys[kvalid][::4]
    for n in (2, 8):
        shard_keys, shard_valid = [], []
        for s in range(n):
            q = keys.roll(s * 4099).clone()
            v = kvalid.roll(s * 4099).clone()
            q[:1024] = q[2048:3072]                  # duplicates within
            v[:1024] = v[2048:3072]
            third = slice(K // 3 * (s % 3), K // 3 * (s % 3 + 1))
            q[third] ^= (s + 1) << 40                # owners of their own
            shard_keys.append(q)
            shard_valid.append(v)
        base = mesh_tables(torch, n, device, 0.4, present)
        tables = [copy_table(torch, t) for t in base]
        host = [t._replace(keys=t.keys.cpu(), size=t.size.cpu(), owner=None)
                for t in base]
        reset_counts()
        new, fail = route_insert(tables, shard_keys, shard_valid)
        torch.cuda.synchronize()
        launches = read_counts()["fpset_insert"]
        want_new, want_fail = route_insert(
            host, [q.cpu() for q in shard_keys],
            [v.cpu() for v in shard_valid])
        err = max_abs(torch, [(a, b) for a, b in zip(new, want_new)]
                      + [(a.to(torch.int64), b.to(torch.int64))
                         for a, b in zip(fail, want_fail)])
        for d in range(n):
            got = tables[d].keys[tables[d].keys != EMPTY]
            ref = host[d].keys[host[d].keys != EMPTY]
            err = max(err, max_abs(torch, [
                (got.sort().values, ref.sort().values.to(device)),
                (tables[d].size, host[d].size)]))
            need(bool((((got >> 32) & 0xFFFFFFFF) % n == d).all()),
                 f"routed insert n={n}: a key off its owner {d}")
        n_new = sum(int(x.sum()) for x in new)
        need(err == 0 and launches == n and not any(bool(f) for f in fail),
             f"routed insert n={n}: differs from the plain routing (max "
             f"abs err {err}) or launched the insert {launches} times")

        def call():
            route_insert(tables, shard_keys, shard_valid)

        def fresh():
            for t, b in zip(tables, base):
                t.keys.copy_(b.keys)
                t.size.copy_(b.size)

        ms = cuda_ms(torch, call, 5, setup=fresh)
        ops = device_ops(torch, call, setup=fresh)
        ins = [us for name, us in ops if name in fpset_cuda.KERNELS]
        out[n] = {"ms": ms, "new": n_new,
                  "valid": sum(int(v.sum()) for v in shard_valid),
                  "device_us": sum(us for _n, us in ops),
                  "insert_us": sum(ins), "ops": len(ops)}
        print(f"routed insert n={n} x K={K} at load 0.4: exact against the "
              f"plain routing (is_new, {n} key sets, sizes, owners), "
              f"{n_new} new of {out[n]['valid']} valid lanes, one call "
              f"{ms} ms between events ({n} insert calls on {n * K} "
              f"arrivals each); under the profiler {len(ops)} device ops, "
              f"{out[n]['device_us']} us of device time, of it the insert "
              f"kernel's {len(ins)} launches {sum(ins)} us")
        del tables, base, host
        torch.cuda.empty_cache()
    return out


def phase_mesh_compact(torch, device, windows):
    """The shared-P compaction: the compaction kernel on real masks (the
    last parent windows of a check to L8), its output cut by
    ``ops/compact.py cap_prefix`` to P = its own, half of it and 1,
    against ``compact_plain`` with that cap.  Exact."""
    from raft_tla_tpu_torch.models.actions2 import build_v2
    from raft_tla_tpu_torch.models.schema import unflatten_state
    from raft_tla_tpu_torch.ops.compact import cap_prefix, kspread
    from raft_tla_tpu_torch.ops.compact_cuda import compact, compact_plain
    from raft_tla_tpu_torch.utils.cfg import load_config
    dims = load_config(os.path.join(HERE, "configs/MCraft_bounded.cfg")).dims
    v2 = build_v2(dims, device)
    kspr = kspread(B, G, K, device)
    err, cases = 0.0, 0
    for rows, valid in windows:
        en, _ovf = v2.masks(unflatten_state(rows, dims))
        en = (en & valid[:, None]).contiguous()
        pt, lane, kvalid = compact(en, K, kspr)
        for cap in sorted({int(pt[0]), max(1, int(pt[0]) // 2), 1}):
            P = torch.tensor([cap], dtype=torch.int64, device=device)
            total, lane_c, kvalid_c = cap_prefix(P, G, lane, kvalid, kspr)
            want = compact_plain(en.cpu(), K, kspr.cpu(), p_cap=cap)
            err = max(err, max_abs(torch, [
                (torch.cat([P, total]), want[0]), (lane_c, want[1]),
                (kvalid_c, want[2])]))
            cases += 1
    need(err == 0, f"shared-P compaction differs from compact_plain with "
         f"the cap: max abs err {err}")
    print(f"shared-P compaction: the kernel cut by cap_prefix exact against "
          f"compact_plain with the cap on {cases} cases (real L8 masks)")
    return err


def phase_mesh(torch, device, profile_shards=()):
    """The mesh's phases on the card (``--mesh``, and in the full smoke):
    see the module doc; L8 profiled at each of ``profile_shards``.
    Returns the kernels line's ``mesh`` entries."""
    from raft_tla_tpu_torch.engine import checkpoint as ckpt
    from raft_tla_tpu_torch.engine.bfs import EngineConfig
    from raft_tla_tpu_torch.engine.check import run_check
    t_all = t_part = time.time()
    cards = torch.cuda.device_count()
    print(f"mesh: torch.cuda.device_count() = {cards}")

    def took(what):
        nonlocal t_part
        print(f"mesh: {what}: {time.time() - t_part} s")
        t_part = time.time()

    real = capture_l8(torch)
    routed = phase_mesh_insert(torch, device, real["keys"], real["kvalid"])
    cap_err = phase_mesh_compact(torch, device, real["windows"])
    torch.cuda.empty_cache()
    took("routed insert and shared-P compaction")

    # The dryrun model at n = 8, against the single engine in this call.
    from raft_tla_tpu_torch.engine.bfs import BFSEngine
    from raft_tla_tpu_torch.models.dims import RaftDims
    from raft_tla_tpu_torch.models.invariants import Bounds, build_constraint
    from raft_tla_tpu_torch.models.pystate import init_state
    from raft_tla_tpu_torch.parallel.mesh import MeshBFSEngine
    dims = RaftDims(**DRYRUN_DIMS)
    dcfg = EngineConfig(batch=64, queue_capacity=1 << 12,
                        seen_capacity=1 << 16, check_deadlock=False,
                        record_trace=False, sync_every=8)
    cons = build_constraint(dims, Bounds(**DRYRUN_BOUNDS))
    t = time.time()
    single = BFSEngine(dims, constraint=cons, config=dcfg,
                       device="cuda").run([init_state(dims)])
    t_single = time.time() - t
    reset_counts()
    t = time.time()
    eng = MeshBFSEngine(dims, constraint=cons, config=dcfg,
                        devices=["cuda"] * 8)
    res = eng.run([init_state(dims)])
    counts = read_counts()
    print(f"dryrun model n=8 (batch 64, queue 2^12, seen 2^16, sync_every "
          f"8): distinct={res.distinct} diameter={res.diameter} "
          f"generated={res.generated} (single {single.generated}) "
          f"growths={res.growth_stalls} spills={res.spills} steps="
          f"{res.steps} check {res.wall_seconds} s, call {time.time() - t} "
          f"s (single: check {single.wall_seconds} s, call {t_single} s), "
          f"launches {counts}")
    need((res.distinct, res.diameter) == DRYRUN_PIN
         and res.stop_reason == "exhausted"
         and res.generated == single.generated
         and res.levels == single.levels and res.growth_stalls,
         "the dryrun model on the mesh differs from its pin or the single "
         "engine, or its shards did not grow")
    check_mesh_launches(counts, res.steps, 8, "dryrun n=8")
    took("dryrun model")

    # MCraft_bounded at batch 2048 a shard: n = 1, 2, 4 to L9 (v4 asked:
    # the mesh resolves it to v3's arrangement), the single v3 engine in
    # turns; n = 4 writes its level-9 snapshot (the wall printed is the
    # check's less the snapshot's seconds).
    walls = {}
    mesh_launches = {}
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_mesh_ck_")
    for what in ("single", 1, 2, 4, "single"):
        if what == "single":
            reset_counts()
            t = time.time()
            r = run_check(os.path.join(HERE, "configs/MCraft_bounded.cfg"),
                          bounded_config("v3", 9), device="cuda")
            walls.setdefault("single v3", []).append(r.wall_seconds)
            continue
        snap = (dict(checkpoint_dir=ckdir, checkpoint_every=9)
                if what == 4 else {})
        r, e, c, call = mesh_run(torch, "MCraft_bounded.cfg", what,
                                 bounded_config("v4", 9, **snap))
        walls.setdefault(f"mesh n={what}", []).append(
            r.wall_seconds - r.phases["checkpoint"])
        print(f"MCraft_bounded L9 mesh n={what}: distinct={r.distinct} "
              f"generated={r.generated} levels={r.levels} steps={r.steps} "
              f"chunks={r.chunks} check {r.wall_seconds} s, call {call} s, "
              f"phases {r.phases}, launches {c}, plan {r.fused_stages}")
        need(r.distinct == MCRAFT_L9_DISTINCT
             and r.generated == MCRAFT_L9_GENERATED
             and r.levels == MCRAFT_L9_LEVELS and not r.growth_stalls,
             f"MCraft_bounded L9 on the mesh at n={what} differs from the "
             "pinned oracle")
        need(r.pipeline == "v4" and "front" in r.fused_reasons
             and r.fused_stages["enqueue"] == "cuda"
             and r.fused_stages["insert"] == "cuda-routed",
             f"the mesh's v4 plan did not resolve to v3's: {r.fused_stages}")
        check_mesh_launches(c, r.steps, what, f"MCraft_bounded L9 n={what}",
                            inserts=what)
        mesh_launches[what] = c
    print(f"MCraft_bounded L9 walls in turns (check seconds): {walls}")
    took("MCraft_bounded L9 in turns")
    # n = 2 to L11.
    r, e, c, call = mesh_run(torch, "MCraft_bounded.cfg", 2,
                             bounded_config("v3", 11))
    print(f"MCraft_bounded L11 mesh n=2: distinct={r.distinct} generated="
          f"{r.generated} levels={r.levels} steps={r.steps} spills="
          f"{r.spills} check {r.wall_seconds} s, phases {r.phases}")
    need(r.distinct == MCRAFT_L11_DISTINCT
         and r.generated == MCRAFT_L11_GENERATED
         and r.levels == MCRAFT_L11_LEVELS,
         "MCraft_bounded L11 on the mesh at n=2 differs from the pinned "
         "oracle")
    check_mesh_launches(c, r.steps, 2, "MCraft_bounded L11 n=2", inserts=2)
    if cards > 1:
        r, e, c, call = mesh_run(torch, "MCraft_bounded.cfg", 2,
                                 bounded_config("v3", 9),
                                 devices=["cuda:0", "cuda:1"])
        print(f"MCraft_bounded L9 mesh across two cards: distinct="
              f"{r.distinct} generated={r.generated} check "
              f"{r.wall_seconds} s (eager steps)")
        need(r.distinct == MCRAFT_L9_DISTINCT
             and r.generated == MCRAFT_L9_GENERATED,
             "MCraft_bounded L9 across two cards differs from the oracle")

    took("MCraft_bounded L11")
    # MCraft_noleader through the CLI's --engine mesh, in a subprocess
    # started now and read after the sync check.
    ce = tempfile.mkdtemp(prefix="chip_smoke_mesh_ce_")
    cli_run = port_cli(["check", os.path.join(
        HERE, "configs/MCraft_noleader.cfg"), "--engine", "mesh",
        "--counterexample-dir", ce, "--progress-interval", "0"])
    from raft_tla_tpu_torch.engine.check import initial_states, make_engine
    from raft_tla_tpu_torch.utils.cfg import load_config
    try:
        # Tiny tables at n = 4: spill and growth inside chunks.
        r, e, c, call = mesh_run(
            torch, "MCraft_bounded.cfg", 4, bounded_config(
                "v3", 6, batch=32, queue_capacity=1024, seen_capacity=256,
                sync_every=8))
        print(f"MCraft_bounded L6 mesh n=4, tiny tables: distinct="
              f"{r.distinct} generated={r.generated} levels={r.levels} "
              f"spills={r.spills} growths={r.growth_stalls} steps="
              f"{r.steps} launches {c}")
        need(r.distinct == MCRAFT_L6_DISTINCT
             and r.generated == MCRAFT_L6_GENERATED
             and r.levels == MCRAFT_L9_LEVELS[:7]
             and r.spills >= 2 and r.growth_stalls,
             "the tiny-table mesh run differs from the oracle, or did not "
             "spill twice and grow")
        check_mesh_launches(c, r.steps, 4, "MCraft_bounded L6 n=4 tiny")

        # The sync check: every mesh chunk's dispatch under sync debug
        # mode "error".
        bsetup = load_config(os.path.join(HERE,
                                          "configs/MCraft_bounded.cfg"))
        eng = make_engine(bsetup, bounded_config("v3", 8), device="cuda",
                          engine_cls="mesh", devices=["cuda"] * 2)
        dispatch, checked = eng._dispatch, []

        def strict(*args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return dispatch(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                checked.append(args[1])

        eng._dispatch = strict
        try:
            r = eng.run(initial_states(bsetup))
        except RuntimeError as e:
            raise PhaseFailed(f"a mesh chunk dispatch waited for the "
                              f"device: {e}")
        print(f"mesh dispatch sync check L8 n=2: {len(checked)} dispatches "
              f"of {sum(checked)} steps under sync debug mode 'error', none "
              f"waited; distinct={r.distinct}")
        need(r.distinct == MCRAFT_L8_DISTINCT
             and len(checked) >= r.chunks > 0,
             "the mesh sync check run differs from the oracle")
    except BaseException:
        cli_run.kill()
        cli_run.wait()
        shutil.rmtree(ce, ignore_errors=True)
        raise
    took("tiny tables and the sync check")
    # MCraft_noleader through the CLI's --engine mesh, and at n = 4.
    import hashlib
    p = cli_run
    try:
        out, err = p.communicate(timeout=300)
        txt = open(os.path.join(ce, "counterexample.txt"), "rb").read()
        doc = json.load(open(os.path.join(ce, "counterexample.json")))
    finally:
        shutil.rmtree(ce, ignore_errors=True)
    digest = hashlib.sha256(txt).hexdigest()
    print(f"check MCraft_noleader --engine mesh (CLI, {cards} card(s)): exit "
          f"{p.returncode}, depth {doc['depth']}, counterexample.txt sha256 "
          f"{digest}; " + " | ".join(
              ln for ln in out.splitlines() if ln.startswith(("device",
                                                              "pipeline"))))
    need(p.returncode == 1 and digest == NOLEADER_TXT_SHA256
         and doc["depth"] == 9 and "mesh of" in out,
         f"check --engine mesh on MCraft_noleader: exit {p.returncode}, "
         f"sha256 {digest}, stderr {err[-400:]}")
    nsetup = load_config(os.path.join(HERE, "configs/MCraft_noleader.cfg"))
    reset_counts()
    neng = make_engine(nsetup, device="cuda", engine_cls="mesh",
                       devices=["cuda"] * 4)
    r = neng.run(initial_states(nsetup))
    c = read_counts()
    steps = neng.replay(r.violation.fingerprint)
    check_walk_trace(torch, nsetup.dims, steps, "MCraft_noleader mesh n=4",
                     fp=r.violation.fingerprint, reencode=True)
    need(len(steps) - 1 == 9 and steps[-1][1] == r.violation.state,
         f"MCraft_noleader mesh n=4: depth {len(steps) - 1} != 9")
    check_mesh_launches(c, r.steps, 4, "MCraft_noleader n=4", trace=True)
    took("MCraft_noleader")

    # Snapshots across engines: the n = 4 L9 run's, then the single's.
    try:
        path = ckpt.latest(ckdir)
        need(path is not None and path.endswith("level_00009.npz"),
             "the mesh n=4 L9 run wrote no level-9 snapshot")
        b = run_check(os.path.join(HERE, "configs/MCraft_bounded.cfg"),
                      bounded_config("v4", 11), device="cuda", resume=path)
        os.remove(path)
        run_check(os.path.join(HERE, "configs/MCraft_bounded.cfg"),
                  bounded_config("v4", 9, checkpoint_dir=ckdir,
                                 checkpoint_every=9), device="cuda")
        path = ckpt.latest(ckdir)
        m, _e, c, _t = mesh_run(torch, "MCraft_bounded.cfg", 2,
                                bounded_config("v3", 11), resume=path)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    print(f"snapshots: mesh n=4 L9 -> single v4 L11 distinct={b.distinct} "
          f"generated={b.generated}; single L9 -> mesh n=2 L11 distinct="
          f"{m.distinct} generated={m.generated} levels={m.levels} steps="
          f"{m.steps} check {m.wall_seconds} s (the single L9 run's "
          "seconds included)")
    for what, x in (("mesh -> single", b), ("single -> mesh", m)):
        need(x.distinct == MCRAFT_L11_DISTINCT
             and x.generated == MCRAFT_L11_GENERATED
             and x.levels == MCRAFT_L11_LEVELS,
             f"snapshot {what} differs from the pinned oracle")
    check_mesh_launches(c, m.steps, 2, "resume single L9 -> mesh L11",
                        inserts=2)
    took("snapshots")

    # TPUraft at n = 2, 4,096 rows a shard, to L8.
    r, e, c, call = mesh_run(torch, "TPUraft.cfg", 2, dataclasses.replace(
        tpuraft_config(8), batch=4096))
    print(f"TPUraft L8 mesh n=2 batch 4096 a shard: distinct={r.distinct} "
          f"generated={r.generated} levels={r.levels} steps={r.steps} "
          f"spills={r.spills} check {r.wall_seconds} s, call {call} s, "
          f"phases {r.phases}, peak {torch.cuda.max_memory_allocated()} B")
    need(r.distinct == TPURAFT_DISTINCT[8]
         and r.generated == TPURAFT_GENERATED[8]
         and r.levels == TPURAFT_LEVELS[:9],
         "TPUraft L8 on the mesh differs from the oracle")
    check_mesh_launches(c, r.steps, 2, "TPUraft L8 n=2",
                        trace=e.config.record_trace)
    took("TPUraft L8")

    # MeshSimulator at n = 4: the near-election roots, a seed repeating.
    from raft_tla_tpu_torch.models.dims import LEADER
    from raft_tla_tpu_torch.parallel.simulate import MeshSimulator
    sdims = RaftDims(**dict(SWARM_DIMS, n_msg_slots=24))
    root = near_election_root(sdims)

    sim = MeshSimulator(
        sdims, invariants={"NoLeader": lambda st: (st.role != LEADER)
                           .all(1)},
        constraint=build_constraint(
            sdims, Bounds(max_term=3, max_log_len=1, max_msg_count=1)),
        batch=32, depth=16, chunk=64, devices=["cuda"] * 4)
    t = time.time()
    runs = [sim.run([root], num_steps=4 * 32 * 64 * 8, seed=s)
            for s in (0, 0)]
    keys = [(x.steps, x.traces, x.violation_trace) for x in runs]
    need(keys[0] == keys[1] and runs[0].violation_invariant == "NoLeader",
         "MeshSimulator n=4: a seed does not repeat its run, or no leader")
    check_walk_trace(torch, sdims, runs[0].violation_trace,
                     "MeshSimulator n=4 seeded violation")
    print(f"MeshSimulator n=4: steps {runs[0].steps} traces "
          f"{runs[0].traces} trace {[g for g, _ in runs[0].violation_trace]}"
          f", repeated by a second run ({time.time() - t} s)")
    took("MeshSimulator")

    # Per-step device time and ops (profiler), last: graphs replay slower
    # once the profiler has run.
    for n in profile_shards:
        phase_profile(torch, "v3", "kernel", config=bounded_config("v3", 8),
                      devices=["cuda"] * n)
    took("profiles")
    print(f"mesh phases: {time.time() - t_all} s")
    return {"compact": {"launches": mesh_launches[2]["compact"],
                        "run": "MCraft_bounded L9, n = 2",
                        "max_abs_err": cap_err},
            "fpset_insert": {"launches": mesh_launches[2]["fpset_insert"],
                             "run": "MCraft_bounded L9, n = 2",
                             "routed_ms": {str(k): v["ms"]
                                           for k, v in routed.items()}},
            "enqueue": {"launches": mesh_launches[2]["enqueue"],
                        "run": "MCraft_bounded L9, n = 2"}}


# ---------------------------------------------------------------------------
# The multi-controller mesh (parallel/multihost.py): two processes on the
# card, one shard each (and two each for the routed insert at n = 4).

MH_TIMEOUT = 420                # seconds the worker pair may take
MH_GROUP_TIMEOUT = 180          # seconds a worker's collective may take
MH_NOLEADER_QUEUE = 1 << 20     # rows: no spill before the violation
MH_SIM = dict(batch=32, depth=16, chunk=64)


def mh_shard_inputs(torch, keys, kvalid, n, shards):
    """``phase_mesh_insert``'s shards of the routed insert at global n,
    for the global indices ``shards``: a real L8 batch rolled per shard
    (every key arrives from every shard, so across processes too), a
    block copied within each shard, a third given owners of its own."""
    out_q, out_v = [], []
    for s in shards:
        q = keys.roll(s * 4099).clone()
        v = kvalid.roll(s * 4099).clone()
        q[:1024] = q[2048:3072]
        v[:1024] = v[2048:3072]
        third = slice(K // 3 * (s % 3), K // 3 * (s % 3 + 1))
        q[third] ^= (s + 1) << 40
        out_q.append(q)
        out_v.append(v)
    return out_q, out_v


def walk_key(res, dims):
    """A simulator run as comparable plain values."""
    from raft_tla_tpu_torch.models.schema import (encode_state, flatten_state,
                                                  stack_states)
    trace = [[g, bytes(flatten_state(stack_states(
        [encode_state(s, dims)], "cpu"), dims)[0].numpy()).hex()]
        for g, s in res.violation_trace or []]
    return {"steps": res.steps, "traces": res.traces, "chunks": res.chunks,
            "violation": res.violation_invariant, "trace": trace}


def mh_sim(torch, devices):
    from raft_tla_tpu_torch.models.dims import LEADER, RaftDims
    from raft_tla_tpu_torch.models.invariants import Bounds, build_constraint
    from raft_tla_tpu_torch.parallel.simulate import MeshSimulator
    sdims = RaftDims(**dict(SWARM_DIMS, n_msg_slots=24))
    sim = MeshSimulator(
        sdims, invariants={"NoLeader": lambda st: (st.role != LEADER)
                           .all(1)},
        constraint=build_constraint(
            sdims, Bounds(max_term=3, max_log_len=1, max_msg_count=1)),
        devices=devices, **MH_SIM)
    res = sim.run([near_election_root(sdims)],
                  num_steps=2 * MH_SIM["batch"] * MH_SIM["chunk"] * 8, seed=0)
    return walk_key(res, sdims), res, sdims


def mh_noleader_config(ce_dir, **kw):
    """MCraft_noleader's engine config at sizes that take no spill before
    the violation, so the placements equal the one-process mesh's."""
    from raft_tla_tpu_torch.engine.check import engine_config_from_backend
    from raft_tla_tpu_torch.utils.cfg import load_config
    setup = load_config(os.path.join(HERE, "configs/MCraft_noleader.cfg"))
    cfg = dataclasses.replace(
        engine_config_from_backend(setup), queue_capacity=MH_NOLEADER_QUEUE,
        counterexample_dir=ce_dir, **kw)
    return setup, cfg


def mh_l9_summary(r, wall, counts):
    return {"distinct": r.distinct, "generated": r.generated,
            "levels": r.levels, "steps": r.steps, "batches": r.batches,
            "chunks": r.chunks,
            "spills": r.spills, "check_s": r.wall_seconds, "call_s": wall,
            "phases": r.phases, "launches": counts,
            "host_s_per_step": r.wall_seconds / max(1, r.steps)}


def multihost_worker() -> int:
    """One controller of the pair (``--multihost-worker``; the launch
    contract's ``RAFT_*`` variables, the shared directory ``MH_DIR``):
    the routed insert across processes at n = 2 and 4, MCraft_bounded L9
    at n = 2 (twice, launch counts checked), MCraft_noleader with a trace
    directory, ``check --no-trace`` under the launch contract, a piece
    group at L7 resumed to L9, ``MeshSimulator`` at n = 2.  Writes
    ``result.p<i>.json`` (and the routed insert's arrays) to ``MH_DIR``.
    ``MH_PHASES=l9`` runs the L9 phase alone."""
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    from raft_tla_tpu_torch import cli
    from raft_tla_tpu_torch.engine import checkpoint as ckpt
    from raft_tla_tpu_torch.engine.check import (initial_states, make_engine,
                                                 run_check)
    from raft_tla_tpu_torch.ops.fpset import EMPTY
    from raft_tla_tpu_torch.parallel import multihost as mh
    from raft_tla_tpu_torch.parallel.mesh import route_insert
    transport = mh.initialize(timeout_seconds=MH_GROUP_TIMEOUT)
    pi, pc = mh.process_index(), mh.process_count()
    d = os.environ["MH_DIR"]
    only_l9 = os.environ.get("MH_PHASES") == "l9"
    device = torch.device("cuda")
    out = {"process": pi, "count": pc, "transport": transport,
           "cards": torch.cuda.device_count(),
           "card": torch.cuda.get_device_name(0)}
    bounded = os.path.join(HERE, "configs/MCraft_bounded.cfg")

    if not only_l9:
        # The routed insert across processes.
        real = torch.load(os.path.join(d, "l8.pt"))
        keys, kvalid = real["keys"].to(device), real["kvalid"].to(device)
        present = keys[kvalid][::4]
        out["routed"] = {}
        for n in (2, 4):
            L = n // pc
            mine = range(pi * L, pi * L + L)
            q, v = mh_shard_inputs(torch, keys, kvalid, n, mine)
            base = [t for i, t in enumerate(
                mesh_tables(torch, n, device, 0.4, present)) if i in mine]
            tables = [copy_table(torch, t) for t in base]
            ex = mh.GroupExchange([device] * L, n)
            reset_counts()
            new, fail = route_insert(tables, q, v, ex)
            torch.cuda.synchronize()
            launches = read_counts()["fpset_insert"]
            arrays = {}
            for j, s in enumerate(mine):
                arrays[f"new{s}"] = new[j].cpu().numpy()
                arrays[f"fail{s}"] = fail[j].cpu().numpy()
                got = tables[j].keys[tables[j].keys != EMPTY]
                arrays[f"keys{s}"] = got.sort().values.cpu().numpy()
                arrays[f"size{s}"] = tables[j].size.cpu().numpy()
            np.savez(os.path.join(d, f"routed_n{n}.p{pi}.npz"), **arrays)

            def call():
                route_insert(tables, q, v, ex)

            def fresh():
                for t, b in zip(tables, base):
                    t.keys.copy_(b.keys)
                    t.size.copy_(b.size)

            out["routed"][str(n)] = {"launches": launches,
                                     "ms": cuda_ms(torch, call, 5,
                                                   setup=fresh)}
            del tables, base
            torch.cuda.empty_cache()

    # MCraft_bounded L9 at n = 2 (one shard a process), twice.
    out["l9"] = []
    for _ in range(2):
        torch.cuda.synchronize()
        reset_counts()
        t = time.time()
        r = run_check(bounded, bounded_config("v4", 9), device="cuda",
                      engine_cls="mesh", devices=["cuda"])
        torch.cuda.synchronize()
        c = read_counts()
        check_mesh_launches(c, r.steps, 1, f"controller {pi} L9", inserts=1)
        out["l9"].append(mh_l9_summary(r, time.time() - t, c))
        out["device"] = r.device
    if only_l9:
        with open(os.path.join(d, f"result.p{pi}.json"), "w") as f:
            json.dump(out, f)
        return 0

    # MCraft_noleader through the engine with a trace directory, then the
    # CLI's check --no-trace under the launch contract.
    setup, cfg = mh_noleader_config(os.path.join(d, "ce"),
                                    trace_dir=os.path.join(d, "trace"))
    reset_counts()
    eng = make_engine(setup, cfg, device="cuda", engine_cls="mesh",
                      devices=["cuda"])
    r = eng.run(initial_states(setup))
    c = read_counts()
    check_mesh_launches(c, r.steps, 1, f"controller {pi} noleader",
                        trace=True)
    steps = eng.replay(r.violation.fingerprint)
    out["noleader"] = {"depth": len(steps) - 1, "fp": r.violation.fingerprint,
                       "spills": r.spills, "distinct": r.distinct,
                       "ce": r.counterexample.get("txt"),
                       "run_id": eng._trace_run_id, "launches": c}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["check", os.path.join(HERE,
                                             "configs/MCraft_noleader.cfg"),
                       "--no-trace", "--progress-interval", "0"])
    out["cli"] = {"rc": rc, "counts": [
        ln for ln in buf.getvalue().splitlines()
        if ln.startswith(("distinct", "states generated", "levels",
                          "VIOLATION"))]}

    # A piece group at L7, resumed by the pair to L9.
    ck = os.path.join(d, "ck")
    r = run_check(bounded, bounded_config("v3", 7, checkpoint_dir=ck,
                                          checkpoint_every=7),
                  device="cuda", engine_cls="mesh", devices=["cuda"])
    path = ckpt.latest(ck)
    r2 = run_check(bounded, bounded_config("v3", 9), device="cuda",
                   engine_cls="mesh", devices=["cuda"], resume=path)
    out["snap"] = {"written": r.diameter, "latest": os.path.basename(path),
                   "distinct": r2.distinct, "generated": r2.generated,
                   "levels": r2.levels}

    # MeshSimulator at n = 2.
    out["sim"], _r, _d = mh_sim(torch, ["cuda"])
    with open(os.path.join(d, f"result.p{pi}.json"), "w") as f:
        json.dump(out, f)
    return 0


def mh_pair(d, env=None, visible=None):
    """Start the worker pair on a free port and wait for both; a worker
    that fails, or a pair past ``MH_TIMEOUT``, ends both and fails the
    phase.  Returns both results."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    for i in range(2):
        e = dict(os.environ, RAFT_COORDINATOR=f"127.0.0.1:{port}",
                 RAFT_NUM_PROCESSES="2", RAFT_PROCESS_ID=str(i), MH_DIR=d,
                 PYTHONPATH=HERE, **(env or {}))
        if visible is not None:
            e["CUDA_VISIBLE_DEVICES"] = str(visible[i])
        logs.append(os.path.join(d, f"worker{i}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--multihost-worker"], cwd=HERE, env=e, text=True,
                stdout=log, stderr=subprocess.STDOUT))
    deadline = time.time() + MH_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad or time.time() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for i, p in enumerate(procs):
        with open(logs[i]) as f:
            tail = f.read()[-2500:]
        need(p.returncode == 0,
             f"multihost worker {i} exited {p.returncode}: {tail}")
    res = []
    for i in range(2):
        with open(os.path.join(d, f"result.p{i}.json")) as f:
            res.append(json.load(f))
    return res


def phase_multihost(torch, device):
    """The multi-controller mesh on the card (``--multihost``, and in the
    full smoke after the mesh's phases): two controllers over gloo on the
    one card, checked against the one-process mesh at the same n; see the
    module doc.  Returns the kernels line's ``multihost`` entries."""
    import numpy as np
    from raft_tla_tpu_torch.engine import checkpoint as ckpt
    from raft_tla_tpu_torch.engine.check import make_engine, run_check
    from raft_tla_tpu_torch.engine.check import initial_states
    from raft_tla_tpu_torch.ops.fpset import EMPTY
    from raft_tla_tpu_torch.parallel.mesh import route_insert
    t_all = time.time()
    cards = torch.cuda.device_count()
    d = tempfile.mkdtemp(prefix="chip_smoke_mh_")
    bounded = os.path.join(HERE, "configs/MCraft_bounded.cfg")
    try:
        # The one-process references, before the pair.
        real = capture_l8(torch)
        torch.save({k: real[k].cpu() for k in ("keys", "kvalid")},
                   os.path.join(d, "l8.pt"))
        present = real["keys"][real["kvalid"]][::4]
        plain = {}
        for n in (2, 4):
            q, v = mh_shard_inputs(torch, real["keys"], real["kvalid"], n,
                                   range(n))
            host = [t._replace(keys=t.keys.cpu(), size=t.size.cpu(),
                               owner=None)
                    for t in mesh_tables(torch, n, device, 0.4, present)]
            new, fail = route_insert(host, [x.cpu() for x in q],
                                     [x.cpu() for x in v])
            plain[n] = (new, fail, host)
        torch.cuda.empty_cache()
        walls = {"one-process n=2": [], "two processes n=2": []}
        reset_counts()
        one, _e, one_c, _t = mesh_run(torch, "MCraft_bounded.cfg", 2,
                                      bounded_config("v4", 9))
        walls["one-process n=2"].append(one.wall_seconds)
        ce1 = os.path.join(d, "ce1")
        setup, cfg = mh_noleader_config(ce1)
        eng = make_engine(setup, cfg, device="cuda", engine_cls="mesh",
                          devices=["cuda"] * 2)
        nl = eng.run(initial_states(setup))
        need(nl.spills == 0 and nl.counterexample,
             "the one-process noleader reference spilled or wrote no "
             "counterexample")
        one_txt = open(nl.counterexample["txt"], "rb").read()
        sim_one, sim_res, sdims = mh_sim(torch, ["cuda"] * 2)
        check_walk_trace(torch, sdims, sim_res.violation_trace,
                         "MeshSimulator n=2 (one process)")
        torch.cuda.empty_cache()
        took = time.time() - t_all
        print(f"multihost: torch.cuda.device_count() = {cards}; the "
              f"one-process references took {took} s")

        # The pair.
        t = time.time()
        a, b = mh_pair(d)
        pair_s = time.time() - t
        print(f"multihost: two controllers on one card, transport "
              f"{a['transport']} / {b['transport']} (layout: "
              f"{a['cards']} card(s) visible to each); the pair took "
              f"{pair_s} s")
        need(a["transport"] == b["transport"] == "gloo",
             f"two processes on one card chose {a['transport']}, not gloo")

        # The routed insert across processes against the plain routing.
        routed = {}
        for n in (2, 4):
            new, fail, host = plain[n]
            err = 0.0
            arrays = {}
            for i in range(2):
                with np.load(os.path.join(d, f"routed_n{n}.p{i}.npz")) as z:
                    arrays.update({k: z[k] for k in z.files})
            for s in range(n):
                ref = host[s].keys[host[s].keys != EMPTY].sort().values
                got = torch.from_numpy(arrays[f"keys{s}"])
                err = max(err, max_abs(torch, [
                    (torch.from_numpy(arrays[f"new{s}"]), new[s]),
                    (torch.from_numpy(arrays[f"fail{s}"]).to(torch.int64),
                     fail[s].to(torch.int64)),
                    (got, ref),
                    (torch.from_numpy(arrays[f"size{s}"]), host[s].size)]))
                need(bool((((got >> 32) & 0xFFFFFFFF) % n == s).all()),
                     f"routed insert across processes n={n}: a key off "
                     f"its owner {s}")
            launches = [x["routed"][str(n)]["launches"] for x in (a, b)]
            need(err == 0 and launches == [n // 2] * 2,
                 f"routed insert across processes n={n}: differs from the "
                 f"plain routing (max abs err {err}) or launched {launches}")
            routed[n] = [x["routed"][str(n)]["ms"] for x in (a, b)]
            print(f"routed insert across two processes n={n} x K={K}: "
                  f"exact against the plain routing (is_new, {n} key sets, "
                  f"sizes, owners); one call {routed[n]} ms between events "
                  f"on each controller, staging included")

        # MCraft_bounded L9 at n = 2.
        for x in (a, b):
            for r in x["l9"]:
                need(r["distinct"] == MCRAFT_L9_DISTINCT
                     and r["generated"] == MCRAFT_L9_GENERATED
                     and r["levels"] == MCRAFT_L9_LEVELS
                     and (r["batches"], r["chunks"]) == (one.batches,
                                                         one.chunks),
                     f"controller {x['process']} L9 at n=2: {r['distinct']}"
                     f" / {r['generated']}, {r['batches']} batches in "
                     f"{r['chunks']} chunks (one process: {one.batches} in "
                     f"{one.chunks})")
                walls["two processes n=2"].append(r["check_s"])
        need(a["l9"][0]["chunks"] == b["l9"][0]["chunks"],
             "the controllers' L9 runs took different chunk counts")
        reset_counts()
        again, _e, _c, _t = mesh_run(torch, "MCraft_bounded.cfg", 2,
                                     bounded_config("v4", 9))
        walls["one-process n=2"].append(again.wall_seconds)
        for x in (a, b):
            r = x["l9"][0]
            print(f"MCraft_bounded L9 n=2, controller {x['process']} "
                  f"({x['device']}): distinct={r['distinct']} generated="
                  f"{r['generated']} steps={r['steps']} chunks={r['chunks']}"
                  f" spills={r['spills']} check {r['check_s']} s, call "
                  f"{r['call_s']} s, host seconds a step "
                  f"{r['host_s_per_step']}, phases {r['phases']}, launches "
                  f"{r['launches']}")
        print(f"MCraft_bounded L9 at n=2 in turns (one process, pair x2, "
              f"one process), check seconds: {walls}; one-process steps "
              f"{one.steps}, launches {one_c}")

        # MCraft_noleader with a trace directory; the CLI.
        import hashlib
        txts = []
        for x in (a, b):
            nlx = x["noleader"]
            need(nlx["depth"] == 9 and nlx["spills"] == 0
                 and nlx["fp"] == nl.violation.fingerprint,
                 f"controller {x['process']} noleader: depth {nlx['depth']}"
                 f", spills {nlx['spills']}, fp {nlx['fp']:#x} (one "
                 f"process {nl.violation.fingerprint:#x})")
            need(nlx["ce"].endswith(f"counterexample.p{x['process']}of2.txt"),
                 f"controller {x['process']} wrote {nlx['ce']}")
            txts.append(open(nlx["ce"], "rb").read())
        pieces = sorted(os.listdir(os.path.join(d, "trace")))
        rid = a["noleader"]["run_id"]
        need(txts[0] == txts[1] == one_txt
             and b["noleader"]["run_id"] == rid
             and pieces == [f"trace_run_{rid:08x}.p{i}of2.npz"
                            for i in (0, 1)],
             f"noleader across processes: counterexamples equal "
             f"{txts[0] == txts[1]}, to the one-process file "
             f"{txts[0] == one_txt}; pieces {pieces}")
        print(f"MCraft_noleader n=2 over two controllers with trace_dir: "
              f"depth 9 on both, counterexample.p0of2.txt == p1of2 == the "
              f"one-process mesh's (sha256 "
              f"{hashlib.sha256(one_txt).hexdigest()}; the single engine's "
              f"{NOLEADER_TXT_SHA256}), pieces {pieces}, launches a "
              f"controller {a['noleader']['launches']}")
        need(a["cli"] == b["cli"] and a["cli"]["rc"] == 1
             and any("VIOLATION" in ln for ln in a["cli"]["counts"]),
             f"check --no-trace under the launch contract: {a['cli']} vs "
             f"{b['cli']}")
        print(f"check MCraft_noleader --no-trace under RAFT_COORDINATOR: "
              f"exit 1 on both, {a['cli']['counts']}")

        # Snapshots: the pair's L7 piece group, resumed by the pair (in
        # the workers) and by the single engine here.
        group = sorted(n for n in os.listdir(os.path.join(d, "ck"))
                       if n.startswith("level_00007."))
        path = ckpt.latest(os.path.join(d, "ck"))
        s = run_check(bounded, bounded_config("v4", 9), device="cuda",
                      resume=path)
        for what, x in (("controller 0", a["snap"]),
                        ("controller 1", b["snap"]),
                        ("single engine", {"distinct": s.distinct,
                                           "generated": s.generated,
                                           "levels": s.levels})):
            need(x["distinct"] == MCRAFT_L9_DISTINCT
                 and x["generated"] == MCRAFT_L9_GENERATED
                 and x["levels"] == MCRAFT_L9_LEVELS,
                 f"the L7 piece group resumed by the {what} to L9 differs "
                 "from the pinned oracle")
        need(group == ["level_00007.p0of2.npz", "level_00007.p1of2.npz"],
             f"the pair wrote {group} at L7")
        print(f"snapshots: the pair's L7 piece group {group} resumed to L9 "
              f"by both controllers and by the single engine: "
              f"{s.distinct} / {s.generated}")

        # MeshSimulator at n = 2.
        need(a["sim"] == b["sim"] == sim_one,
             f"MeshSimulator over two processes differs from one process: "
             f"{a['sim']['steps']}/{a['sim']['traces']} vs "
             f"{sim_one['steps']}/{sim_one['traces']}")
        acts = [g for g, _ in sim_one["trace"]]
        print(f"MeshSimulator n=2 over two processes == one process: steps "
              f"{sim_one['steps']} traces {sim_one['traces']} violation "
              f"{sim_one['violation']} trace {acts}")

        if cards > 1:
            # One card a process: the NCCL transport.
            for f in os.listdir(d):
                if f.startswith("result."):
                    os.remove(os.path.join(d, f))
            n0, n1 = mh_pair(d, env={"MH_PHASES": "l9"}, visible=(0, 1))
            need(n0["transport"] == n1["transport"] == "nccl"
                 and all(r["distinct"] == MCRAFT_L9_DISTINCT
                         and r["generated"] == MCRAFT_L9_GENERATED
                         for r in n0["l9"] + n1["l9"]),
                 f"MCraft_bounded L9 over NCCL differs: {n0['transport']}")
            print(f"MCraft_bounded L9 n=2 over NCCL, one card a process: "
                  f"check seconds {[r['check_s'] for r in n0['l9']]}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"multihost phases: {time.time() - t_all} s")
    launches = a["l9"][0]["launches"]
    run = "MCraft_bounded L9, n = 2 over two processes, per controller"
    return {"compact": {"launches": launches["compact"], "run": run},
            "fpset_insert": {"launches": launches["fpset_insert"], "run": run,
                             "routed_ms": {str(n): routed[n]
                                           for n in routed}},
            "enqueue": {"launches": launches["enqueue"], "run": run}}


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
    if sys.argv[1:] == ["--walks"]:
        t = time.time()
        phase_swarm_parity(torch)
        phase_swarm_throughput(torch, turns=True)
        phase_simulate(torch)
        print(f"walk tier phases: {time.time() - t} s")
        return 0
    from raft_tla_tpu_torch.utils import build
    t_smoke = t = time.time()
    took = build.build_all()
    print(f"build: {time.time() - t} s (per source {took})")
    device = torch.device("cuda")
    if sys.argv[1:] == ["--enqueue-variants"]:
        enqueue_variants(torch, device)
        return 0
    if sys.argv[1:] == ["--front-variants"]:
        front_variants(torch, device)
        return 0
    if sys.argv[1:] == ["--tail-variants"]:
        tail_variants(torch, device)
        return 0
    if sys.argv[1:] == ["--outputs"]:
        print(f"check outputs: {phase_check_outputs(torch)} s")
        phase_observation_cost(torch)
        return 0
    if sys.argv[1:] == ["--mesh"]:
        phase_mesh(torch, device, profile_shards=(2, 8))
        return 0
    if sys.argv[1:] == ["--multihost"]:
        phase_multihost(torch, device)
        return 0
    if sys.argv[1:] == ["--reconfig"]:
        t = time.time()
        print(f"reconfig front: {phase_reconfig_front(torch, device)}")
        phase_reconfig_cfg(torch)
        phase_reconfig_leader(torch)
        print(f"reconfig phases: {time.time() - t} s")
        return 0
    gen = torch.Generator(device=device)
    gen.manual_seed(20261016)
    t = time.time()
    rows = [phase_compact(torch, device, gen)]
    base, present = prefilled_table(torch, gen, device, 0.4)
    rows.append(phase_insert(torch, device, gen, base, present))
    rows.append(phase_fused_tail(torch, device, gen, base, present))
    del base, present
    torch.cuda.empty_cache()
    probe_loads(torch, device, gen)
    rows.append(phase_front(torch, device))
    rows.append(phase_enqueue(torch, device, gen))
    if sys.argv[1:] == ["--kernels"]:
        print(f"kernel phases: {time.time() - t} s")
        phase_profile(torch, "v4")
        print(json.dumps({"kernels": [{k: r.get(k) for k in ROW_KEYS}
                                      for r in rows]}))
        return 0
    phase_other_dims(torch, device)
    # Before any whole-run profile: device-only profiles of one call taken
    # after those have come back empty.
    phase_tpuraft_kernels(torch, device, gen)
    torch.cuda.empty_cache()
    front_row = next(r for r in rows if r["name"] == "chunk_front")
    for shape in ("MCraft", "TPUraft"):
        front_row["max_abs_err"] = max(
            front_row["max_abs_err"], phase_safety_front(torch, device, shape))
    front_row["reconfig"] = phase_reconfig_front(torch, device)
    front_row["max_abs_err"] = max(front_row["max_abs_err"],
                                   front_row["reconfig"]["max_abs_err"])
    print(f"kernel phases: {time.time() - t} s")
    # The two paths in turns (v3, v4, then v4, v3 at L11): host times
    # spread between calls, so they are compared within this one.
    counts = {"v3": phase_main_path(torch, "v3"),
              "v4": phase_main_path(torch, "v4")}
    for pipeline in ("v3", "v4"):
        phase_counterexample(torch, pipeline)
        phase_small_table(torch, pipeline)
        phase_small_table(torch, pipeline, sync_every=8)
        phase_dispatch_sync_free(torch, pipeline)
    for pipeline in ("v4", "v3"):
        phase_deep(torch, pipeline)
    for pipeline in ("v4", "v3"):
        phase_profile(torch, pipeline)
    # The split tail, after the fused one in the same call.
    counts["v3 split"] = phase_main_path(torch, "v3", "kernel")
    counts["v4 split"] = phase_main_path(torch, "v4", "kernel")
    # Host times spread between runs, so the two tails take turns.
    turns = [(m, phase_deep(torch, "v4", m))
             for m in ("fused", "kernel", "kernel", "fused")]
    print("L11 v4 in turns, as (tail, check seconds, dispatch seconds per "
          "batch): " + ", ".join(
              f"({m}, {r.wall_seconds}, {r.phases['dispatch'] / r.batches})"
              for m, r in turns))
    for pipeline, method in (("v3", "kernel"), ("v4", "kernel"),
                             ("v4", "scatter"), ("v4", "window")):
        phase_dispatch_sync_free(torch, pipeline, method)
    for pipeline in ("v4", "v3"):
        phase_profile(torch, pipeline, "kernel")
    phase_resume(torch, "v4")
    phase_por(torch)
    print(f"check outputs: {phase_check_outputs(torch)} s")
    phase_observation_cost(torch)
    phase_sync_turns(torch)
    phase_safety_cfg(torch, turns)
    phase_smoke_init(torch)
    t = time.time()
    front_row["reconfig"]["launches"] = \
        phase_reconfig_cfg(torch)["chunk_front"]
    phase_reconfig_leader(torch)
    print(f"reconfig phases: {time.time() - t} s")
    torch.cuda.empty_cache()
    mesh_rows = phase_mesh(torch, device)
    torch.cuda.empty_cache()
    mh_rows = phase_multihost(torch, device)
    torch.cuda.empty_cache()
    print(f"MCraft phases done: {time.time() - t_smoke} s")
    t = time.time()
    phase_swarm_parity(torch)
    phase_swarm_throughput(torch)
    phase_simulate(torch)
    torch.cuda.empty_cache()
    print(f"walk tier phases: {time.time() - t} s")
    phase_north_star(torch)
    phase_safety_tpuraft(torch)
    phase_profile(torch, "v4", cfg_name="TPUraft.cfg",
                  config=tpuraft_config(6, record_trace=True))
    phase_tpuraft_more(torch)
    phase_oom(torch)
    paths = {"compact": "v3", "fused_tail": "v4", "chunk_front": "v4",
             "fpset_insert": "v4 split", "enqueue": "v4 split"}
    for row in rows:
        row["launches"] = counts[paths[row["name"]]][row["name"]]
        if row["name"] in mesh_rows:
            row["mesh"] = mesh_rows[row["name"]]
            row["multihost"] = mh_rows[row["name"]]
    print(f"chip_smoke: {time.time() - t_smoke} s in all")
    print(json.dumps({"kernels": [
        {k: r[k] for k in ROW_KEYS + tuple(
            x for x in ("reconfig", "mesh", "multihost") if x in r)}
        for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--multihost-worker"]:
        sys.exit(multihost_worker())
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
