"""Traffic kind ``exhaustive_repeat``: one client's exhaustive checks of one
configuration, back to back on one warm engine, as the checker service
runs a tenant's repeated job: a closed loop, each check started once the
last one's verdict is in.

The entry is the one ``check`` and the service's warm engines use:
``engine/check.py make_engine(setup, EngineConfig)``, then
``BFSEngine.run(initial_states(setup))`` once a check.  Set-up reads the
cfg (``cfg``), builds the engine (``engine``: the program's imports, the
kernels loaded) and runs one check at the cell's shapes (``warmup_check``:
the CUDA context, the step's graphs captured once, the allocator warm).  The window runs
checks until ``--seconds`` have passed; a check that starts before the
deadline runs to its end.  A check from ``Init`` has no randomness (as in
TLC, where the seed matters only to simulation), so the seed changes no
work here.

Parameters (the cell's ``params``): ``max_diameter``, the depth of each
check; ``reference_live_depth``, how deep the reference searches anew in
every run; ``profile_checks``, the checks the traced run profiles.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List

from portbench import devtrace
from portbench.reference import compare, oracle


@dataclasses.dataclass
class State:
    engine: object
    roots: list


@dataclasses.dataclass
class Profile:
    """The traced sub-window: its device operations and host spans (within
    the profiled checks' ranges), the ranges, and those checks' answers."""
    dev: list
    marks: list
    spans: list
    checks: list

    @property
    def window_us(self) -> float:
        return sum(e - s for _n, s, e in self.marks)

    @property
    def busy_us(self) -> float:
        return sum(devtrace.busy_us(self.dev, s, e) for _n, s, e in self.marks)

    def idle_gaps(self) -> list:
        gaps = []
        for _n, s, e in self.marks:
            gaps += devtrace.idle_gaps(self.dev, s, e)
        return gaps


def summary(res, t_start: float, t_end: float) -> dict:
    """What a check answered, and its host clock and program counters."""
    return {"t_start": t_start, "t_end": t_end, "seconds": t_end - t_start,
            "distinct": res.distinct, "generated": res.generated,
            "diameter": res.diameter, "levels": list(res.levels),
            "stop_reason": res.stop_reason,
            "violation": (res.violation.invariant
                          if res.violation is not None else None),
            "deadlock": res.deadlock is not None,
            "action_counts": dict(res.action_counts),
            "phases": dict(res.phases), "batches": res.batches,
            "steps": res.steps, "chunks": res.chunks}


def _check_constants(setup, constants: dict) -> None:
    """The program's reading of the cfg has to be the configuration's."""
    got = {"n_servers": setup.dims.n_servers,
           "n_values": setup.dims.n_values,
           "max_term": setup.bounds.max_term,
           "max_log_len": setup.bounds.max_log_len,
           "max_msg_count": setup.bounds.max_msg_count}
    if got != constants:
        raise ValueError(f"the cfg reads as {got}, the configuration "
                         f"states {constants}")


def prepare(run) -> State:
    from raft_tla_tpu_torch.engine.bfs import EngineConfig
    from raft_tla_tpu_torch.engine.check import initial_states, make_engine
    from raft_tla_tpu_torch.models.schema import state_width
    from raft_tla_tpu_torch.utils.cfg import load_config
    conf = run.config
    setup = load_config(os.path.join(run.root, conf["cfg"]))
    _check_constants(setup, conf["constants"])
    run.mark("cfg")
    cfg = EngineConfig(**conf["engine"],
                       max_diameter=run.params["max_diameter"])
    engine = make_engine(setup, cfg, device=run.device)
    roots = initial_states(setup)
    run.row_bytes = state_width(setup.dims)
    run.n_roots = len(roots)
    run.mark("engine")
    engine.run(roots)
    _sync(run)
    run.mark("warmup_check")
    return State(engine, roots)


def _sync(run) -> None:
    if run.device != "cpu":
        import torch
        torch.cuda.synchronize()


def window(state: State, run, seconds: float) -> List[dict]:
    checks = []
    deadline = time.perf_counter() + seconds
    while True:
        t = time.perf_counter()
        res = state.engine.run(state.roots)
        _sync(run)
        e = time.perf_counter()
        checks.append(summary(res, t, e))
        if e >= deadline:
            return checks


def _aligned_spans(events: list, mark) -> list:
    """A check's host spans (the ``SpanTracer`` file's complete events,
    in microseconds from the tracer's start) on the profile's clock: the
    ``run`` span ends as the check's range does."""
    xs = [ev for ev in events if ev.get("ph") == "X"]
    runs = [ev for ev in xs if ev["name"] == "run"]
    off = (mark[2] - (runs[-1]["ts"] + runs[-1]["dur"]) if runs
           else mark[1])
    return [(ev["name"], ev["ts"] + off, ev["ts"] + ev["dur"] + off)
            for ev in xs]


def profile(state: State, run) -> Profile:
    """``profile_checks`` whole checks under ``torch.profiler``, each in
    its own range, with the engine's span tracer on for them alone."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function
    from raft_tla_tpu_torch.obs.tracing import SpanTracer
    eng = state.engine
    path = os.path.join(run.out_dir, "spans.json")
    quiet = eng.tracer
    eng.tracer = eng.metrics.tracer = SpanTracer(path)
    checks, span_files = [], []
    _sync(run)
    try:
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(int(run.params.get("profile_checks", 1))):
                t = time.perf_counter()
                with record_function(devtrace.MARK):
                    res = eng.run(state.roots)
                    _sync(run)
                checks.append(summary(res, t, time.perf_counter()))
                with open(path) as f:
                    span_files.append(json.load(f))
    finally:
        eng.tracer = eng.metrics.tracer = quiet
    dev, marks = devtrace.collect(prof)
    if len(marks) != len(checks):
        # The ranges did not all come back: nothing to read.
        dev, marks, span_files = [], [], []
    spans = []
    for mark, events in zip(marks, span_files):
        spans += _aligned_spans(events, mark)
    inside = [d for d in dev
              if any(s <= d[1] < e for _n, s, e in marks)]
    return Profile(dev=inside, marks=marks, spans=spans, checks=checks)


def release(state: State, run) -> None:
    """The engine's device memory given back before the reference runs."""
    state.engine.release()
    state.engine = None
    if run.device != "cpu":
        import torch
        torch.cuda.empty_cache()


def judge(run) -> dict:
    """Every check of the window (and of the traced sub-window) against
    the reference's answer."""
    dims = oracle.Dims(**run.config["constants"])
    ref, gap = compare.reference_answer(
        run.config["name"], dims, run.params["max_diameter"],
        run.params["reference_live_depth"])
    checks = list(run.checks)
    if run.profile is not None:
        checks += run.profile.checks
    return compare.judge(checks, ref, prefix_gap=gap)
