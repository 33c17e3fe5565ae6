"""Per-stage chunk profiler (``--profile-chunks``) and the device-profiler
capture (``--xla-profile``).

The JAX package's ``obs/profile.py``.  Every Nth chunk call the
``ChunkProfiler`` re-runs the batch that call expands first through the
chunk's stages one by one, fenced by ``torch.cuda.Event`` pairs on the
card (by the host clock on the CPU), and keeps per-stage histograms in
the registry (``chunk_stage/<stage>``), the ``chunk_profile`` event and a
stderr table at the run's end.  The stages are the JAX profiler's:

    v4     front (B4), insert_enqueue (B2; the split tail: B1, then B5 or
           a PyTorch enqueue)
    v3     masks, compact (B3), fingerprint, insert_enqueue
    swarm  expand, choose, latch, ring_probe

and ``total`` runs the same stages unfenced, the fused reference.  The
stages are the engine's own (``engine/chunk.py build_chunk_stages``, the
engine's predicates, constraint, POR arrays and tail), built for the
profiler with a front of its own, a scratch seen set and a scratch
queue (the JAX profiler's ``empty_seen``): a sample writes nothing the
engine reads, so counts are bit-identical with profiling on or off.  The
wrappers' launch counters are put back after a sample.  A sample is
taken between graph replays, never inside a capture, and reading its
events waits for the card: with ``sync_every`` > 1 each sample costs one
host sync (the table says so).  A sleep kernel leads each sample on the
card so that the stages run back to back while the host queues them:
the events then time the card, not the host's launches, as far as the
card's launch queue holds them (about a thousand launches; a PyTorch
stage of more ops, v3's masks and fingerprint, is timed at the host's
pace past that).  The v1 stages (``STAGES``) are not
ported (ROADMAP A7).

``ProfileCapture`` is the counterpart of the JAX ``XlaProfileCapture``:
a ``torch.profiler`` capture (CPU and CUDA activity) from the run's
start through its first N chunk calls, each call a ``chunk`` step,
written as a Chrome trace (``trace_<pid>.json``) into the directory; the
``xla_profile`` event carries its summary.  A profiler that cannot start
records why in that event instead of failing the run.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager
from typing import Dict, Optional

import torch

STAGES = ("expand", "fingerprint", "dedup_insert", "enqueue")
STAGES_V3 = ("masks", "compact", "fingerprint", "insert_enqueue")
STAGES_V4 = ("front", "insert_enqueue")
STAGES_SWARM = ("expand", "choose", "latch", "ring_probe")

STAGE_PREFIX = "chunk_stage/"

#: Cycles of the sleep kernel timed once to learn the card's sleep rate.
SLEEP_CALIBRATION = 10_000_000


def kernel_modules():
    """The kernel wrappers' modules, whose ``launches`` count launches."""
    from ..ops import (chunk_front_cuda, compact_cuda, enqueue_cuda,
                       fpset_cuda, fused_tail_cuda)
    return (compact_cuda, fpset_cuda, fused_tail_cuda, chunk_front_cuda,
            enqueue_cuda)


@contextmanager
def launches_put_back():
    """The wrappers' launch counters as they were before the block: what
    a profiler or a perf probe launches is not the run's."""
    mods = kernel_modules()
    before = [m.launches for m in mods]
    try:
        yield
    finally:
        for m, b in zip(mods, before):
            m.launches = b


def _stage_fns(dims, B: int, K: int, QP: int, device, stage_kw: dict,
               pipeline: str) -> dict:
    """The v3 / v4 stage functions on the engine's stages."""
    from ..engine.chunk import build_chunk_stages
    from ..ops.chunk_front_cuda import Front
    from ..ops.fpset import pack
    kw = dict(stage_kw)
    front = None
    if pipeline == "v4":
        front = Front(dims=dims, v2=kw["v2"], inv_fns=kw["inv_fns"],
                      constraint=kw["constraint"], B=B, K=K, device=device,
                      por_mask=kw.get("por_mask"),
                      por_priority=kw.get("por_priority"))
    st = build_chunk_stages(dims=dims, B=B, K=K, device=device, front=front,
                            Q=QP, **kw)

    def tail(seen, qnext, count, fo):
        count.zero_()
        return st.tail(seen, pack(fo.kh, fo.kl), fo.kvalid, fo.krows,
                       fo.cons_ok, qnext, count, QP)

    return {"stages": st, "tail": tail}


class ChunkProfiler:
    """Samples every ``every``-th chunk call of one engine's runs.

    ``pipeline`` is "v3", "v4" or "swarm"; ``stage_kw`` the engine's
    ``build_chunk_stages`` arguments (v2, inv_fns, constraint,
    record_trace, enqueue_method, POR arrays), ``ring`` the swarm's ring
    capacity.  ``sync_every`` is only named in the table."""

    def __init__(self, dims, *, batch: int, lanes: int,
                 seen_capacity: int, pipeline: str = "v4", every: int = 1,
                 metrics=None, device="cuda", stage_kw: Optional[dict] = None,
                 ring: int = 16, sync_every: int = 1,
                 enqueue_method: str = "fused"):
        if pipeline == "v1":
            raise NotImplementedError(
                "the v1 stage profile (STAGES) needs the v1 pipeline, "
                "which is not ported (ROADMAP A7)")
        if pipeline not in ("v3", "v4", "swarm"):
            raise ValueError(f"profiler pipeline must be v3/v4/swarm, got "
                             f"{pipeline!r}")
        self.dims = dims
        self.B, self.K = int(batch), int(lanes)
        self.seen_capacity = int(seen_capacity)
        self.pipeline = pipeline
        self.device = torch.device(device)
        self.stage_kw = dict(stage_kw or {})
        self.ring_capacity = int(ring)
        self.sync_every = int(sync_every)
        self.enqueue_method = enqueue_method
        self.stages = {"v3": STAGES_V3, "v4": STAGES_V4,
                       "swarm": STAGES_SWARM}[pipeline]
        self.every = max(1, int(every))
        self.metrics = metrics
        self._built = None
        self._swarm_k = 0
        self.reset()

    def reset(self) -> None:
        """Zero the accumulators for a new run; the built stages and the
        scratch tables stay."""
        self.samples = 0
        self._calls = 0
        self._stage_totals: Dict[str, float] = {s: 0.0 for s in self.stages}
        self._total_total = 0.0

    def want(self) -> bool:
        """Count a chunk call; True when it is to be sampled (the first
        always is)."""
        self._calls += 1
        return (self._calls - 1) % self.every == 0

    # -- building ----------------------------------------------------------
    def _build(self, rows, valid):
        """The stages and their scratch, and one untimed pass through
        both chains: a first call's one-time costs (a front's setup, the
        allocator's first blocks) stay out of the first sample."""
        b = self._build_stages()
        t = time.perf_counter()
        with launches_put_back():
            self._chain(b, rows, valid, lambda s: None, "staged")
            self._chain(b, rows, valid, lambda s: None, "fused")
        self._queue_s = time.perf_counter() - t
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            # The card's sleep rate, for the lead of each sample.
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
            torch.cuda._sleep(SLEEP_CALIBRATION)
            z.record()
            z.synchronize()
            self._sleep_per_s = SLEEP_CALIBRATION / (a.elapsed_time(z) / 1e3)
        self._built = b
        return b

    def _build_stages(self):
        dev = self.device
        if self.pipeline == "swarm":
            return self._build_swarm()
        from ..models.schema import state_width
        from ..ops import fpset
        K = self.K
        QP = K
        b = _stage_fns(self.dims, self.B, K, QP, dev, self.stage_kw,
                       self.pipeline)
        sw = state_width(self.dims)
        pad = max(self.B, K)

        def scratch():
            return {"seen": fpset.empty(self.seen_capacity, dev),
                    "qnext": torch.zeros((QP + pad, sw), dtype=torch.uint8,
                                         device=dev),
                    "count": torch.zeros(1, dtype=torch.int32, device=dev)}

        # Two scratch sets: the fenced stages and the unfenced total see
        # the same load.
        b["staged"], b["fused"] = scratch(), scratch()
        return b

    def _build_swarm(self):
        import numpy as np
        from ..models.actions2 import build_v2
        from ..models.schema import flatten_state, unflatten_state
        from ..ops.fingerprint import build_fingerprint
        from ..ops.walk_kernels import (CHOICE_STREAM, FAMILY_STREAM,
                                        family_subset, preferred_choice,
                                        ring_init, ring_probe, ring_push,
                                        ring_reset, walk_bits)
        dims, dev, B = self.dims, self.device, self.B
        v2 = build_v2(dims, dev)
        fingerprint = build_fingerprint(dims, dev)
        fam = torch.as_tensor(np.repeat(
            np.arange(len(dims.family_sizes)), dims.family_sizes),
            device=dev)
        walk_ids = torch.arange(B, dtype=torch.int64, device=dev)
        epoch = torch.zeros(B, dtype=torch.int64, device=dev)

        def expand(rows, valid):
            states = unflatten_state(rows, dims)
            en, ovf = v2.masks(states)
            return states, en & valid[:, None], ovf

        def choose(en, k):
            bits = walk_bits(0, walk_ids, k, CHOICE_STREAM)
            mbits = walk_bits(0, walk_ids, epoch, FAMILY_STREAM)
            return preferred_choice(bits, en, family_subset(mbits, fam))

        def latch(states, choice):
            _h, _l, nxt = v2.lane_out(states, None, choice, hashes=False)
            nrows = flatten_state(nxt, dims)
            fp_hi, fp_lo = fingerprint(nxt)
            return nrows, fp_hi, fp_lo

        def ring(rings, fp_hi, fp_lo, en, ovf):
            rh, rl, rp = rings
            seen = ring_probe(rh, rl, fp_hi, fp_lo)
            accept = en.any(1) & ~ovf.any(1) & ~seen
            rh, rl, rp = ring_push(rh, rl, rp, fp_hi, fp_lo, accept)
            return ring_reset(rh, rl, rp, ~accept)

        return {"expand": expand, "choose": choose, "latch": latch,
                "ring": ring,
                "staged": list(ring_init(B, self.ring_capacity, dev)),
                "fused": list(ring_init(B, self.ring_capacity, dev))}

    # -- sampling ----------------------------------------------------------
    def _chain(self, b, rows, valid, fence, which: str) -> None:
        """The stages in order on scratch ``which``, ``fence(stage)`` after
        each."""
        if self.pipeline == "swarm":
            k = self._swarm_k
            states, en, ovf = b["expand"](rows, valid)
            fence("expand")
            choice = b["choose"](en, k)
            fence("choose")
            _nrows, hi, lo = b["latch"](states, choice)
            fence("latch")
            b[which][:] = b["ring"](b[which], hi, lo, en, ovf)
            fence("ring_probe")
            return
        st, sc = b["stages"], b[which]
        if self.pipeline == "v4":
            fo = st.front(rows, valid)
            fence("front")
        else:
            states, en, _ovf, _pruned = st.masks(rows, valid)
            fence("masks")
            _pt, lane_id, kvalid = st.compact(en)
            fence("compact")
            kh, kl, krows, cons_ok, _inv, _ph, _pl = st.lanes(states,
                                                              lane_id)
            fence("fingerprint")
            fo = _Lanes(kh=kh, kl=kl, kvalid=kvalid, krows=krows,
                        cons_ok=cons_ok)
        b["tail"](sc["seen"], sc["qnext"], sc["count"], fo)
        fence("insert_enqueue")

    def sample(self, rows, valid) -> None:
        """Profile one batch: ``rows`` [B, sw] and ``valid`` [B] bool on
        the engine's device.  Waits for the card once, at its end.

        On the card a sleep kernel leads the sample, longer than the host
        took to queue the last sample's chains: the stages then run back
        to back on the card while the host is still queueing, so each
        pair of events holds the stage's device time, not the host's
        launch path."""
        rows = rows.contiguous()
        b = self._built or self._build(rows, valid)
        cuda = self.device.type == "cuda"
        marks = []
        if cuda:
            torch.cuda._sleep(int(2 * self._queue_s * self._sleep_per_s))
        t_queue = time.perf_counter()

        def fence(stage):
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((stage, ev))
            else:
                marks.append((stage, time.perf_counter()))

        with launches_put_back():
            fence(None)
            self._chain(b, rows, valid, fence, "staged")
            # "total": the same stages again, unfenced.
            self._chain(b, rows, valid, lambda s: None, "fused")
            fence("total")
            self._queue_s = time.perf_counter() - t_queue
            if cuda:
                marks[-1][1].synchronize()
            if self.pipeline == "swarm":
                self._swarm_k += 1
            else:
                self._recycle(b)
        timings = {}
        for (_s0, m0), (s1, m1) in zip(marks, marks[1:]):
            timings[s1] = (m0.elapsed_time(m1) / 1e3 if cuda else m1 - m0)
        self._record(timings)

    def _recycle(self, b) -> None:
        """A scratch seen set past half full starts empty again (its
        kernels' probe chains assume at most half)."""
        from ..ops import fpset
        for which in ("staged", "fused"):
            sc = b[which]
            if int(sc["seen"].size[0]) > sc["seen"].capacity // 2:
                sc["seen"] = fpset.empty(self.seen_capacity, self.device)

    def _record(self, timings: Dict[str, float]) -> None:
        mt = self.metrics
        self.samples += 1
        for s in self.stages:
            self._stage_totals[s] += timings[s]
            if mt is not None:
                mt.observe(STAGE_PREFIX + s, timings[s])
        self._total_total += timings["total"]
        if mt is not None:
            mt.observe(STAGE_PREFIX + "total", timings["total"])
        from .flight import RECORDER
        RECORDER.record(
            "chunk_stage", sample=self.samples, pipeline=self.pipeline,
            batch=self.B,
            stages={s: round(timings[s], 6) for s in self.stages},
            total=round(timings["total"], 6))

    # -- reporting ---------------------------------------------------------
    def stage_means(self) -> Dict[str, float]:
        """{stage: mean seconds a sampled batch} and ``total``."""
        if not self.samples:
            return {}
        out = {s: self._stage_totals[s] / self.samples for s in self.stages}
        out["total"] = self._total_total / self.samples
        return out

    def summary(self) -> dict:
        """The ``chunk_profile`` event's fields (the JAX keys; the port has
        no TPU budget, so ``budget_ms_b2048`` is null)."""
        means = self.stage_means()
        staged_sum = sum(means.get(s, 0.0) for s in self.stages)
        return {
            "samples": self.samples,
            "every": self.every,
            "batch": self.B,
            "lanes": self.K,
            "pipeline": self.pipeline,
            "stages": {s: {"mean_seconds": round(means[s], 6),
                           "total_seconds": round(self._stage_totals[s], 6),
                           "budget_ms_b2048": None}
                       for s in self.stages} if self.samples else {},
            "fused_total_mean_seconds": round(means.get("total", 0.0), 6),
            "staged_sum_mean_seconds": round(staged_sum, 6),
        }

    def floors(self) -> Dict[str, dict]:
        """The stages' byte floors (``obs/roofline.py``)."""
        from . import roofline
        return roofline.stage_traffic(self.dims, self.B, self.K,
                                      pipeline=self.pipeline,
                                      ring=self.ring_capacity,
                                      enqueue_method=self.enqueue_method)

    def render_table(self) -> str:
        """The run-end table: each stage's mean ms, share, bound ms (its
        floor bytes at the card's peak) and the share of the bound
        reached."""
        from . import roofline
        means = self.stage_means()
        if not means:
            return "chunk profile: no samples"
        peak = roofline.peak_bandwidth(self.device)
        rows = roofline.build_roofline(self.floors(), means, peak)
        if self.device.type != "cuda":
            sync = "timed by the host clock"
        elif self.sync_every > 1:
            sync = ("each sample waits for the card once: a host sync "
                    f"a sampled chunk of sync_every {self.sync_every}")
        else:
            sync = "each sample waits for the card once"
        lines = [f"chunk profile ({self.samples} sampled batches, "
                 f"B={self.B}, K={self.K}, every {self.every}th call, "
                 f"{self.pipeline} stages; {sync}):",
                 f"  {'stage':14s} {'mean ms':>10s} {'share':>7s} "
                 f"{'bound ms':>10s} {'of bound':>9s}"]
        staged_sum = sum(means[s] for s in self.stages)
        for s in self.stages:
            share = means[s] / staged_sum if staged_sum else 0.0
            r = rows[s]
            frac = r["bandwidth_fraction"]
            lines.append(
                f"  {s:14s} {means[s] * 1e3:10.4f} {share:6.1%} "
                f"{(r['floor_seconds'] or 0.0) * 1e3:10.4f} "
                + (f"{frac:9.1%}" if frac is not None else f"{'-':>9s}"))
        lines.append(f"  {'sum(stages)':14s} {staged_sum * 1e3:10.4f}")
        lines.append(f"  {'fused total':14s} {means['total'] * 1e3:10.4f}"
                     f"  (the stages unfenced; peak "
                     f"{peak['bytes_per_sec'] / 1e9:,.0f} GB/s, "
                     f"{peak['source']})")
        return "\n".join(lines)

    def finish(self, evlog, stream=None) -> None:
        """Run end: the ``chunk_profile`` event and the table (nothing
        when nothing was sampled)."""
        if not self.samples:
            return
        evlog.emit("chunk_profile", **self.summary())
        print(self.render_table(), file=stream or sys.stderr)


class _Lanes:
    """The v3 stages' outputs the tail reads, under ``FrontOut``'s
    names."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class ProfileCapture:
    """A ``torch.profiler`` capture from the run's start through its first
    ``chunks`` chunk calls (``--xla-profile N``), written as a Chrome trace
    into ``logdir``."""

    def __init__(self, logdir: str, chunks: int, device="cuda"):
        self.logdir = logdir
        self.chunks = max(1, int(chunks))
        self.steps = 0
        self.active = False
        self.done = False
        self.status: Optional[str] = None
        self.trace_file: Optional[str] = None
        self._cuda = torch.device(device).type == "cuda"
        self._prof = None

    def start(self) -> None:
        """Open the capture (at the run's start, so root ingest is in
        it)."""
        if self.active or self.done:
            return
        from torch.profiler import ProfilerActivity, profile
        try:
            os.makedirs(self.logdir, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if self._cuda:
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self.active = True
            self.status = "ok"
        except Exception as e:
            self.done = True
            self._prof = None
            self.status = f"start failed: {type(e).__name__}: {e}"

    @contextmanager
    def step(self):
        """One chunk call, as the profiler's step ``chunk``; the capture
        stops after ``chunks`` of them."""
        if not self.active:
            yield
            return
        from torch.profiler import record_function
        self.steps += 1
        try:
            with record_function("chunk"):
                yield
        finally:
            if self.steps >= self.chunks:
                self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        self.active = False
        self.done = True
        prof, self._prof = self._prof, None
        try:
            if self._cuda:
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            path = os.path.join(self.logdir, f"trace_{os.getpid()}.json")
            prof.export_chrome_trace(path)
            self.trace_file = path
        except Exception as e:
            self.status = f"stop failed: {type(e).__name__}: {e}"

    def summary(self) -> dict:
        """The ``xla_profile`` event's ``capture`` object."""
        return {"logdir": self.logdir, "chunks": self.chunks,
                "steps": self.steps,
                "status": self.status or "never started",
                "span_name": "chunk", "trace_file": self.trace_file}

    def finish(self, evlog) -> None:
        """Run end: close an open capture, emit ``xla_profile``."""
        self.stop()
        evlog.emit("xla_profile", capture=self.summary())
