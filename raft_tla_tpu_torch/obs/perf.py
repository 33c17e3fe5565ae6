"""Launch accounting and the run's performance block (``--perf``).

The JAX package's ``obs/perf.py``.  The JAX module counts launches by
walking the chunk program's jaxpr; the port counts what the card is
given:

- ``launches_per_batch``: the device operations of one chunk step, from
  one ``torch.profiler`` sample of a step that runs every operation and
  changes nothing (its cond false: the engines' warm-up step) — CUDA
  kernels, copies and fills on the card, top-level aten operations on
  the CPU; ``launches_fixed``: those of the cond a chunk adds after its
  steps;
- ``plan_launches``: the port's own kernels' launches a chunk call, read
  from the wrappers' ``launches`` counters (``ops/*_cuda.py``) over the
  run;
- ``launch_overhead_seconds``: one launch's cost measured on the run's
  device (one-element adds replayed as a CUDA graph between CUDA events,
  as the engines' steps run; on the CPU by the host clock),
  ``RAFT_LAUNCH_OVERHEAD_US`` overriding;
- the dynamic half: each chunk call's (steps, seconds), fed by the host
  loop from values it already has.

At run end the block joins the roofline (``obs/roofline.py``) with the
chunk profiler's stage means (``--perf`` samples every 16th chunk when no
cadence was chosen), asks the advisor for the top stage, and lands as
the ``perf`` event, ``EngineResult.perf``, ``perf/*`` gauges and a
stderr table.  Observational: the sample step changes nothing, the
counters are put back, and counts are bit-identical with ``--perf`` on
or off.  On the mesh ``timed_collective_probe`` times one crossing of
the exchange (an ``all_reduce`` across processes, a ``Tensor.to`` round
in one process) for the collectives' share.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional

import torch

_OVERHEAD: Dict[str, float] = {}


def launch_overhead_seconds(device="cpu") -> float:
    """Seconds one small launch costs on ``device``, measured once a
    process and device: on the card 1,000 one-element adds captured as
    one CUDA graph and replayed between two CUDA events (the engines'
    steps are graph replays, so this is a launch inside a step); on the
    CPU the same adds by the host clock.  ``RAFT_LAUNCH_OVERHEAD_US``
    (microseconds) overrides."""
    env = os.environ.get("RAFT_LAUNCH_OVERHEAD_US")
    if env is not None:
        try:
            return float(env) * 1e-6
        except ValueError:
            print(f"perf: ignoring malformed RAFT_LAUNCH_OVERHEAD_US="
                  f"{env!r} (want microseconds as a number)",
                  file=sys.stderr)
    dev = torch.device(device)
    key = str(dev)
    if key not in _OVERHEAD:
        x = torch.zeros(1, device=dev)
        n = 1000
        for _ in range(50):
            x.add_(1)
        if dev.type == "cuda":
            from ..utils.device import capture_graph

            def adds():
                for _ in range(n):
                    x.add_(1)

            g = capture_graph(adds, dev, torch.cuda.graph_pool_handle())
            g.replay()
            torch.cuda.synchronize(dev)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            g.replay()
            b.record()
            b.synchronize()
            _OVERHEAD[key] = a.elapsed_time(b) / 1e3 / n
        else:
            t = time.perf_counter()
            for _ in range(n):
                x.add_(1)
            _OVERHEAD[key] = (time.perf_counter() - t) / n
    return _OVERHEAD[key]


def count_device_ops(fn, device) -> int:
    """The device operations one call of ``fn`` issues, under
    ``torch.profiler``: CUDA kernels, copies and fills on the card, the
    top-level aten operations on the CPU."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # A marker launch first: the profiler drops device activity
            # it dates to before its own start.
            torch.cuda._sleep(1000)
            torch.cuda.synchronize(dev)
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize(dev)
        ev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        marks = [e.time_range.end for e in ev if "spin_kernel" in e.name]
        after = max(marks, default=None)
        return sum(1 for e in ev if "spin_kernel" not in e.name
                   and (after is None or e.time_range.start >= after))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(1 for e in prof.events()
               if e.cpu_parent is None and e.name.startswith("aten::"))


class PerfAccounting:
    """One engine's performance attribution: the launch model measured at
    the first chunk call, (steps, seconds) fed a chunk call, the block
    assembled at run end."""

    def __init__(self, *, pipeline: str,
                 stage_traffic: Optional[Dict[str, dict]],
                 device="cpu", peak: Optional[dict] = None,
                 metrics=None, collectives_per_batch: int = 0):
        from . import roofline as roofline_mod
        self.pipeline = pipeline
        self.traffic = stage_traffic
        self.device = torch.device(device)
        self.peak = peak or roofline_mod.peak_bandwidth(self.device)
        self.metrics = metrics
        self.launch_model: Optional[dict] = None
        self.collectives_per_batch = collectives_per_batch
        self.overhead_s = launch_overhead_seconds(self.device)
        self.reset()

    def reset(self) -> None:
        """Per-run accumulators (the launch model is kept)."""
        self.chunk_calls = 0
        self.batches = 0
        self.chunk_seconds = 0.0
        self._level_batches = 0
        self.level_launches: List[dict] = []
        self.collective_probe_seconds: Optional[float] = None
        self.plan_launches: Dict[str, float] = {}
        from .profile import kernel_modules
        self._launch_base = {m.__name__.rsplit(".", 1)[-1]: m.launches
                             for m in kernel_modules()}

    def wants_model(self, capture=None) -> bool:
        """Whether to measure the launch model now: not yet measured, and
        no ``torch.profiler`` capture open (``capture``: the run's
        ``ProfileCapture``; profiler sessions do not nest)."""
        return self.launch_model is None and not (
            capture is not None and capture.active)

    def measure(self, step, fixed=None) -> None:
        """The launch model: device operations of one call of ``step`` (a
        step that changes nothing) and of ``fixed`` (what a chunk adds
        once).  The wrappers' counters are put back."""
        if self.launch_model is not None:
            return
        from .profile import launches_put_back
        with launches_put_back():
            per_step = count_device_ops(step, self.device)
            per_chunk = count_device_ops(fixed, self.device) if fixed else 0
        self.launch_model = {
            "launches_per_batch": per_step,
            "launches_fixed": per_chunk,
            "collectives_per_batch": self.collectives_per_batch,
            "model": ("device ops of one chunk step under torch.profiler "
                      f"({'CUDA kernels, copies and fills' if self.device.type == 'cuda' else 'top-level aten ops'}); "
                      "a step dispatched with its cond false runs them "
                      "all")}

    # -- dynamic feed ------------------------------------------------------
    def add_chunk(self, batches: int, seconds: float) -> None:
        """One chunk call's (steps dispatched, wall seconds)."""
        self.chunk_calls += 1
        self.batches += int(batches)
        self._level_batches += int(batches)
        self.chunk_seconds += float(seconds)

    def end_level(self, level: int) -> None:
        lm = self.launch_model
        if lm is not None:
            self.level_launches.append({
                "level": int(level), "batches": self._level_batches,
                "launches": self._level_batches
                * lm["launches_per_batch"]})
        self._level_batches = 0

    def note_collective_probe(self, seconds: float) -> None:
        """The mesh: one timed crossing of the exchange."""
        self.collective_probe_seconds = float(seconds)

    def note_kernel_launches(self) -> None:
        """The port's kernels' launches a chunk call over the run, from the
        wrappers' counters."""
        from .profile import kernel_modules
        calls = max(1, self.chunk_calls)
        self.plan_launches = {
            name: round((m.launches - self._launch_base.get(name, 0))
                        / calls, 3)
            for m in kernel_modules()
            for name in [m.__name__.rsplit(".", 1)[-1]]}

    # -- assembly ----------------------------------------------------------
    def launches_per_chunk(self) -> Optional[float]:
        lm = self.launch_model
        if lm is None or not self.chunk_calls:
            return None
        return (lm["launches_per_batch"] * self.batches / self.chunk_calls
                + lm["launches_fixed"])

    def summary(self, chunk_stages: Optional[Dict[str, float]] = None
                ) -> dict:
        """The ``perf`` block, under the JAX block's keys."""
        from . import roofline as roofline_mod
        lm = self.launch_model
        lpc = self.launches_per_chunk()
        launch: Dict[str, object] = {
            "model": (lm or {}).get("model"),
            "launches_per_batch": (lm or {}).get("launches_per_batch"),
            "launches_fixed_per_chunk": (lm or {}).get("launches_fixed"),
            "chunk_calls": self.chunk_calls,
            "batches": self.batches,
            "chunk_seconds": round(self.chunk_seconds, 6),
            "launches_per_chunk": (round(lpc, 1) if lpc is not None
                                   else None),
            "launch_overhead_us": round(self.overhead_s * 1e6, 3),
            "launch_overhead_share": None,
            "per_level": self.level_launches,
        }
        if lm is not None and self.chunk_seconds and self.batches:
            tax = (lm["launches_per_batch"] * self.batches
                   + lm["launches_fixed"] * self.chunk_calls) \
                * self.overhead_s
            launch["launch_tax_seconds"] = round(tax, 6)
            launch["launch_overhead_share"] = round(
                min(1.0, tax / self.chunk_seconds), 6)
        means = dict(chunk_stages or {})
        means.pop("total", None)
        rows = (roofline_mod.build_roofline(self.traffic, means, self.peak)
                if self.traffic else {})
        advisor = roofline_mod.advise(rows, self.overhead_s) if rows \
            else {"ranking": [], "top": None,
                  "verdict": "launch accounting only (no per-stage "
                             "roofline on this engine)"}
        out = {
            "pipeline": self.pipeline,
            "launch": launch,
            "roofline": {"peak_bytes_per_sec":
                         float(self.peak["bytes_per_sec"]),
                         "peak_source": self.peak["source"],
                         "stages": rows},
            "advisor": advisor,
            "plan_launches": dict(self.plan_launches),
        }
        if self.collective_probe_seconds is not None and lm is not None:
            probe = self.collective_probe_seconds
            coll = {"probe_seconds": round(probe, 6),
                    "collectives_per_batch": lm["collectives_per_batch"],
                    "share": None}
            if self.chunk_seconds and self.batches:
                coll["share"] = round(min(1.0, (
                    probe * lm["collectives_per_batch"] * self.batches)
                    / self.chunk_seconds), 6)
            out["collectives"] = coll
        return out

    def feed_metrics(self, mt, perf: dict) -> None:
        launch = perf["launch"]
        if launch["launches_per_chunk"] is not None:
            mt.gauge("perf/launches_per_chunk",
                     launch["launches_per_chunk"])
        if launch["launch_overhead_share"] is not None:
            mt.gauge("perf/launch_overhead_share",
                     launch["launch_overhead_share"])

    def render_table(self, perf: dict) -> str:
        """The run-end table: launches a batch and a chunk and their
        share of the chunk time, the port's kernels a chunk, the roofline
        rows, the advisor's verdict."""
        launch = perf["launch"]
        lines = [f"perf ({self.pipeline} pipeline, "
                 f"{launch['chunk_calls']} chunk calls, "
                 f"{launch['batches']} batches):"]
        if launch["launches_per_batch"] is not None:
            share = launch["launch_overhead_share"]
            lines.append(
                f"  launches: {launch['launches_per_batch']} device ops/"
                f"step, {launch['launches_per_chunk'] or 0:,.1f}/chunk; at "
                f"{launch['launch_overhead_us']:g} us a launch (measured) "
                + (f"{share:.1%} of the chunk time"
                   if share is not None else "(no chunk time)"))
        if perf.get("plan_launches"):
            lines.append("  kernel launches a chunk: " + ", ".join(
                f"{k} {v:g}" for k, v in perf["plan_launches"].items()))
        rows = perf["roofline"]["stages"]
        if rows:
            lines.append(
                f"  roofline vs {perf['roofline']['peak_bytes_per_sec'] / 1e9:,.0f}"
                f" GB/s ({perf['roofline']['peak_source']}):")
            lines.append(f"    {'stage':14s} {'KB/batch':>10s} "
                         f"{'floor ms':>9s} {'meas ms':>9s} "
                         f"{'of peak':>8s} {'kernels':>7s}")
            for stage, r in rows.items():
                meas = (f"{r['mean_seconds'] * 1e3:9.4f}"
                        if r["mean_seconds"] is not None else f"{'-':>9s}")
                frac = (f"{r['bandwidth_fraction']:8.1%}"
                        if r["bandwidth_fraction"] is not None
                        else f"{'-':>8s}")
                lines.append(
                    f"    {stage:14s} {r['bytes_total'] / 1024:10.1f} "
                    f"{(r['floor_seconds'] or 0) * 1e3:9.4f} {meas} "
                    f"{frac} {r['launches']:7d}")
        if perf.get("collectives"):
            c = perf["collectives"]
            share = c["share"]
            lines.append(
                f"  collectives: {c['collectives_per_batch']}/step, "
                f"probe {c['probe_seconds'] * 1e3:.3f} ms"
                + (f", modeled share {share:.1%}" if share is not None
                   else ""))
        lines.append(f"  advisor: {perf['advisor']['verdict']}")
        return "\n".join(lines)

    def finish(self, evlog, chunk_stages=None, stream=None) -> dict:
        """Run end: the block, the ``perf`` event, the gauges, the table.
        Returns the block (``EngineResult.perf``)."""
        self.note_kernel_launches()
        perf = self.summary(chunk_stages)
        evlog.emit("perf", perf=perf)
        if self.metrics is not None:
            self.feed_metrics(self.metrics, perf)
        print(self.render_table(perf), file=stream or sys.stderr)
        return perf


def timed_collective_probe(fn, *args, warm: bool = True) -> float:
    """Seconds of one call of ``fn`` (a crossing that returns when its
    result is on the host), after a warm-up call unless ``warm`` is
    False."""
    if warm:
        fn(*args)
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0
