"""Checker service — the TLC-delegation endpoint, on the card.

The JAX package's ``server.py``, kept as the port's own copy: a
long-lived service wrapping the port's engines, reachable from anything
that can open a socket — in particular the TLC module override shipped
in ``native/tlc_override/`` (a Java operator that forwards a ``.cfg`` to
this service and returns the result as a TLA+ record), but also ad-hoc
drivers and notebooks.  The service holds the engines warm between
requests (their kernels loaded, their graphs captured, their buffers
allocated), so a repeat check of the same model skips that set-up.
Every request runs on the server's device (``--device``, the card by
default; a server started for ``cuda`` without a card raises at start).
The protocol, the op schemas, the caches, the job layer and the metric
names are the JAX server's; ``ping`` answers ``"platform": "gpu"`` on the
card (with the card's name, read once at ``serve()``) and ``"cpu"`` with
``--device cpu``.  The ops served beside a run (``stats``, ``metrics``,
``watch``, the job ops and the HTTP listener) read host records only:
they make no CUDA call, so a graph capture on the run's thread is never
disturbed by them.

Protocol: newline-delimited JSON over TCP; one request per line, one
response per line.  Requests:

    {"op": "ping"}
        -> {"ok": true, "platform": "gpu", "device": "<card name>"}
    {"op": "check", "cfg": "<path>" | "cfg_text": "<.cfg contents>",
     "batch": 1024, "max_seconds": 60.0, "max_diameter": null,
     "queue_capacity": null, "seen_capacity": null, "trace": false,
     "engine": "single" | "mesh"}
        -> {"ok": true, "distinct": N, "generated": N, "diameter": N,
            "levels": [...], "stop_reason": "...",
            "report": {collision probability, per-level table,
                       out-degree, seen-set load — obs/report.py},
            "violation": null | {"invariant": "...", "fingerprint": "0x..",
                                 "trace": [{"action": "...",
                                            "state": "..."}, ...]},
            "deadlock": null | "<state>", "wall_seconds": S}
    {"op": "check", "cfg": ..., "mode": "swarm", "walks": 1024,
     "max_depth": 64, "num_steps": N, "seed": 0, "max_seconds": S}
        -> {"ok": true, "mode": "swarm", "walks": W, "steps": N,
            "visited": N, "traces": N, "diameter": N,
            "steps_per_second": R, "walks_per_second": R,
            "violation_at_seconds": S | null, "stop_reason": "...",
            "violation": null | {...}, "report": {...}}
       The swarm tier (engine/swarm.py): W deterministic randomized
       walks instead of exhaustive BFS — the cheap high-QPS job class.
       Mode resolves request field > cfg "\\* TPU: MODE" directive >
       exhaustive; an unknown mode answers {"ok": false} and counts
       server/rejected/bad_mode (submit validates it at admission, so
       it can never surface as an executor-thread failure).
    {"op": "simulate", "cfg": ..., "num_steps": N, "depth": D,
     "batch": B, "seed": 0, "max_seconds": S}
        -> {"ok": true, "steps": N, "traces": N, "wall_seconds": S,
            "violation": null | {...}}
    {"op": "stats"}
        -> {"ok": true, "metrics": {counters, gauges, histograms},
            "engine_cache": {"size": n, "capacity": c},
            "sim_cache": {...}}
       Live telemetry (obs/): per-op request counts and latency
       histograms, engine/sim LRU cache hit/miss/eviction counters.
       Served WITHOUT the device lock, so it answers while a check runs.
    {"op": "metrics"}
        -> {"ok": true, "content_type": "text/plain; version=0.0.4...",
            "exposition": "<Prometheus text exposition>"}
       The SAME registry as "stats", rendered in the Prometheus text
       format (obs/expose.py) — point a scraper sidecar here, or mount
       the standalone --metrics-port HTTP listener instead.  Also
       served without the device lock.
    {"op": "watch", "interval": 1.0, "count": 0}
        -> a STREAM of lines (the one multi-line-response op): one
           {"ok": true, "watch": {run, progress, level, coverage,
            chunk_stage, seq, armed}} snapshot per interval, closed by
           {"ok": true, "done": true, ...} when the watched run ends
           (or after "count" snapshots; count 0 = until run end).
       Run attach (obs/flight.py): snapshots come from the in-memory
       flight ring, not the event file — a check with no --events-out
       is still watchable.  Never takes the device lock.
       With "job": "<job-id>" the stream scopes to ONE job (serving/):
       snapshots carry the job summary plus ring progress while that
       job owns the device, and the stream stays open for as long as
       the job is alive — a watcher on a queued or compiling job is
       never reaped as idle.  The done line carries the terminal job.

Async jobs (serving/ — the multi-tenant job layer; see the README's
"Serving & jobs" for full schemas):

    {"op": "submit", "tenant": "acme", "job": {<check/simulate
     request>}, "cache": false, "slo_seconds": null}
        -> {"ok": true, "job": {id, state: "queued", ...}}
       Bounded admission + per-tenant fair scheduling; the job runs on
       the single executor thread under the same device lock as the
       blocking ops.  Queue-full rejects answer {"ok": false} (and
       count server/rejected/queue_full).  "cache": true completes a
       repeat submit from the fingerprint-keyed result cache (refused
       for max_seconds-budgeted requests — a truncated run is not
       reusable).
    {"op": "status", "job_id": ID}   -> {"ok": true, "job": {...}}
    {"op": "result", "job_id": ID}   -> {"ok": true, "state": ...,
                                         "result": {<check response>}}
    {"op": "cancel", "job_id": ID}   -> {"ok": true, "job": {...}}
       queued/admitted only — a running single-device job is not
       preemptible; a cancelled job never ran and never will.
    {"op": "jobs", "tenant": null, "state": null}
        -> {"ok": true, "jobs": [...], "queue_depth": N, "running": N,
            "by_state": {...}, "queue_capacity": N}

    Every check job gets a scoped JSONL event log + postmortem dir
    under --job-dir/<job-id>/ and job/tenant tags on the flight ring's
    run_context (simulate jobs have neither — the simulator has no run
    event log); every job gets per-tenant counters and queue-wait/SLO
    histograms in the registry (the "stats"/"metrics" ops and the
    --metrics-port HTTP endpoint expose them), and — with --history —
    a kind=server run-history ledger entry.  The journal in --job-dir
    makes the registry survive restarts: queued jobs resume, the job a
    crash caught running is re-run once then failed with a postmortem
    pointer.

Errors: {"ok": false, "error": "<message>"}.  check/simulate are served
one at a time (a checking run owns the device); concurrent connections
queue.  ping/stats/metrics/watch and the job ops never queue behind
them (submit returns as soon as the job is journaled).

Run:  python -m raft_tla_tpu_torch.server [--port 8610] [--device cpu]
          [--job-dir DIR] [--job-queue N] [--history LEDGER]
          [--metrics-port PORT]

--metrics-port serves GET /metrics (Prometheus text exposition of the
same registry as "stats"), /flight (the flight ring), and /jobs (the
job registry) over HTTP from THIS process — the long-lived server is
the natural scrape target, no engine-side listener required.

Trust model: the service is UNAUTHENTICATED and the "cfg" op accepts an
arbitrary filesystem path, whose parse errors can echo file contents —
so the default bind is loopback and the service trusts every client the
bind address admits (same model as TLC's distributed-mode RMI endpoints).
Binding a non-loopback --host hands that power to the network segment;
do it only behind a firewall/ssh tunnel, or pass cfg_text instead of
path-based cfg and run the process with a restricted filesystem view.
"""

from __future__ import annotations

import json
import os
import socketserver
import tempfile
import threading
from typing import Optional

_LOCK = threading.Lock()          # one engine run at a time (one device)
# Process-global telemetry (obs/): request/latency/cache counters for
# every handler thread, exposed verbatim by the "stats" op.
from .obs.metrics import MetricsRegistry  # noqa: E402
_METRICS = MetricsRegistry()
# Warm caches, LRU-capped: a long-lived service iterating on cfg_text
# variants must not pin one warm engine (plus its trace store) per
# variant forever.
_CACHE_CAP = 8
from collections import OrderedDict  # noqa: E402
_ENGINES: "OrderedDict" = OrderedDict()   # (cfg identity, opts) -> engine
_SIMS: "OrderedDict" = OrderedDict()      # ditto for simulators
_SWARMS: "OrderedDict" = OrderedDict()    # ditto for swarm engines
# The caches are keyed as the JAX server's, with the device appended:
# several servers in one process (the tests) may serve different devices.
# NOTE the run-history ledger path (--history) is deliberately NOT a
# module global: several servers can live in one process (tests do),
# and a global would split-brain their ledgers.  It rides per-request
# telemetry (handle_request reads it off the server's JobManager, the
# single source of truth the manager's own restart bookkeeping uses).


def _cache_put(cache: "OrderedDict", key, value, name: str):
    cache[key] = value
    cache.move_to_end(key)
    while len(cache) > _CACHE_CAP:
        _key, old = cache.popitem(last=False)
        _release(old)
        _METRICS.counter(f"server/{name}/evictions")


def _release(engine) -> None:
    """An evicted warm engine's device memory back: its captured graphs
    first (their pool lives as long as they do), then its buffers; what
    else it holds goes with the object."""
    engine.release()


def _cache_get(cache: "OrderedDict", key, name: str):
    v = cache.get(key)
    if v is not None:
        cache.move_to_end(key)
    # Hit/miss counters per LRU cache: a miss on a repeat model means the
    # cap is churning warm engines — the number that tells an operator
    # to raise _CACHE_CAP before blaming the engine build.
    _METRICS.counter(f"server/{name}/" + ("hits" if v is not None
                                          else "misses"))
    return v


def _load_setup(req):
    """Returns (setup, identity, cfg text).  Identity is a hash of the
    cfg CONTENT (not the path): editing a .cfg between requests must
    never serve the previous model's engine.  The text rides along for
    the history ledger's cfg fingerprint."""
    import hashlib
    from .utils.cfg import load_config
    if req.get("cfg"):
        path = req["cfg"]
        with open(path, "rb") as f:
            raw = f.read()
        ident = hashlib.sha256(raw).hexdigest()
        return load_config(path), ident, raw.decode(errors="replace")
    if req.get("cfg_text"):
        text = req["cfg_text"]
        ident = hashlib.sha256(text.encode()).hexdigest()
        f = tempfile.NamedTemporaryFile("w", suffix=".cfg", delete=False)
        try:
            f.write(text)
            f.close()
            return load_config(f.name), ident, text
        finally:
            os.unlink(f.name)
    raise ValueError("need 'cfg' (path) or 'cfg_text'")


def _platform_of(device) -> dict:
    """``ping``'s answer for ``device``: ``gpu`` and the card's name for a
    CUDA device (read here, once), ``cpu`` otherwise."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu",
                "device": torch.cuda.get_device_name(dev)}
    return {"platform": "cpu"}


def _cfg_label(req: dict) -> str:
    """Ledger/job label for one request: the cfg basename, or a short
    content fingerprint for path-less cfg_text submissions."""
    if req.get("cfg"):
        return os.path.basename(str(req["cfg"]))
    if req.get("cfg_text"):
        import hashlib
        return ("cfg_text:"
                + hashlib.sha256(req["cfg_text"].encode())
                .hexdigest()[:10])
    return "?"


def _violation_json(engine, violation, dims):
    from .models.pystate import format_state
    out = {"invariant": violation.invariant,
           "fingerprint": hex(violation.fingerprint)}
    try:
        steps = engine.replay(violation.fingerprint)
        out["trace"] = [
            {"action": ("Init" if g < 0 else dims.describe_instance(g)),
             "state": format_state(st, dims)}
            for g, st in steps]
    except Exception as e:          # trace-off runs: report the state only
        out["trace"] = []
        out["trace_error"] = str(e)
        out["state"] = format_state(violation.state, dims)
    return out


def _do_check(req, telemetry=None, device="cuda"):
    """Run one check request.  ``telemetry`` (the job executor's
    per-job scoping) carries ``events_out`` / ``postmortem_dir`` /
    ``run_context`` overrides; they are applied to the (possibly warm,
    cached) engine's host-side config on EVERY request — a direct
    check after a job must reset them back to the request's own
    values, never inherit the job's scoped paths."""
    from .engine.check import initial_states, make_engine

    from .models.pystate import format_state

    import dataclasses
    from .engine.check import engine_config_from_backend

    setup, ident, cfg_text = _load_setup(req)
    # Engine-tier routing (request "mode" field > cfg "\* TPU: MODE"
    # directive > exhaustive — the standard precedence): swarm-mode
    # checks run the randomized-walk tier (engine/swarm.py) through
    # the same request/telemetry/ledger surface.  Unknown modes reject
    # cleanly here; submit requests are additionally validated at
    # admission (_do_submit) so a bad mode never reaches the executor
    # thread.
    mode = req.get("mode") or setup.backend.get("MODE") or "exhaustive"
    if mode == "swarm":
        return _do_swarm(req, telemetry, device=device,
                         _loaded=(setup, ident, cfg_text))
    if mode != "exhaustive":
        _METRICS.counter("server/rejected/bad_mode")
        raise ValueError(f"unknown mode {mode!r} (expected "
                         f"'exhaustive' or 'swarm')")
    record_trace = bool(req.get("trace", False))
    # Precedence everywhere (utils/cfg.py): request field > cfg "\* TPU:"
    # backend directive > built-in default — the backend-seeded config is
    # the base, request fields overlay only when present.
    # A JSON null is the protocol's "unset" (the docstring's idiomatic
    # form), so only non-null request values override the directives.
    base = engine_config_from_backend(setup)
    cfg = dataclasses.replace(
        base,
        # Engines share the process-global registry, so engine counters,
        # phase timers, and coverage gauges aggregate across requests
        # and surface in the "stats" op (the obs/ aggregation pattern).
        metrics=_METRICS,
        batch=(int(req["batch"]) if req.get("batch") is not None
               else base.batch),
        queue_capacity=(req["queue_capacity"]
                        if req.get("queue_capacity") is not None
                        else base.queue_capacity),
        seen_capacity=(req["seen_capacity"]
                       if req.get("seen_capacity") is not None
                       else base.seen_capacity),
        max_seconds=req.get("max_seconds"),
        max_diameter=req.get("max_diameter"),
        record_trace=record_trace,
        check_deadlock=req.get("check_deadlock"),
        # The chunk's plan (v3: the compaction kernel and the fused
        # tail; v4: the front kernel and the fused tail; auto and v2 run
        # v3); same request-over-directive precedence as every key.
        pipeline=(req["pipeline"] if req.get("pipeline") is not None
                  else base.pipeline),
        por=(bool(req["por"]) if req.get("por") is not None
             else base.por),
        por_table=(req["por_table"] if req.get("por_table") is not None
                   else base.por_table))
    # check_deadlock (and the POR mask) are baked into the engine's
    # step, so they key the cache; the StopAfter budgets are host-side
    # and are refreshed on the cached engine's config below.
    # A table artifact keys by CONTENT, not path (the same file-identity
    # rule as ``ident``): regenerating the artifact in place must build
    # a fresh engine, not keep serving the stale mask.
    por_key = None
    if cfg.por_table is not None:
        if isinstance(cfg.por_table, str):
            import hashlib
            with open(cfg.por_table, "rb") as f:
                por_key = hashlib.sha256(f.read()).hexdigest()
        else:
            por_key = cfg.por_table.fingerprint
    # pipeline keys the cache: the chunk's step differs per plan, so a
    # v3 request must never be served a warm v4 engine (or vice versa).
    key = (ident, req.get("engine", "single"), cfg.batch,
           cfg.queue_capacity, cfg.seen_capacity, record_trace,
           cfg.check_deadlock, cfg.pipeline, cfg.por, por_key, str(device))
    engine = _cache_get(_ENGINES, key, "engine_cache")
    if engine is None:
        engine_cls = req.get("engine")
        if engine_cls not in ("mesh", "auto"):
            engine_cls = None
        # make_engine applies the cfg-file fallbacks (CHECK_DEADLOCK,
        # StopAfter) identically for both engine classes.
        engine = make_engine(setup, cfg, device=device,
                             engine_cls=engine_cls)
        _cache_put(_ENGINES, key, engine, "engine_cache")
    # Budgets are per-request: apply the request value (or the cfg-file
    # fallback) to the warm engine's host-side config.
    engine.config.max_seconds = (cfg.max_seconds
                                 if cfg.max_seconds is not None
                                 else setup.max_seconds)
    engine.config.max_diameter = (cfg.max_diameter
                                  if cfg.max_diameter is not None
                                  else setup.max_diameter)
    # Per-request telemetry scoping (see docstring): ALWAYS assigned,
    # so a cached engine never leaks one job's event log / postmortem
    # dir / run tags into the next request's run.
    tel = telemetry or {}
    engine.config.events_out = tel.get("events_out", cfg.events_out)
    engine.config.postmortem_dir = tel.get("postmortem_dir",
                                           cfg.postmortem_dir)
    engine.config.run_context_extra = tel.get("run_context")
    history_path = tel.get("history")
    res = engine.run(initial_states(setup, seed=int(req.get("seed", 0))))
    if history_path:
        # Served-traffic leg of the run-history ledger: every
        # server-executed check lands a kind=server entry (host_key +
        # job/tenant ids when a job ran it) so bench_history renders
        # served runs alongside CLI/bench ones.  Bookkeeping only —
        # a ledger write failure must not fail the check response.
        try:
            from .obs import history as history_mod
            from .obs.flight import host_fingerprint
            ctx = tel.get("run_context") or {}
            history_mod.append_entry(
                history_path,
                history_mod.entry_from_result(
                    "server", res, cfg_text=cfg_text, dims=setup.dims,
                    host_fingerprint=host_fingerprint(),
                    label=_cfg_label(req),
                    extra={"job_id": ctx.get("job_id"),
                           "tenant": ctx.get("tenant")}))
        except Exception as e:
            import sys as _sys
            print(f"server history append failed: "
                  f"{type(e).__name__}: {e}", file=_sys.stderr)
    out = {"ok": True, "distinct": res.distinct,
           "generated": res.generated, "diameter": res.diameter,
           "levels": list(res.levels), "stop_reason": res.stop_reason,
           "wall_seconds": round(res.wall_seconds, 3),
           "batch": engine.config.batch,      # resolved, for observability
           # Which plan actually ran, and its resolved per-stage kernels
           # — what ran and why is visible to the client, never silent.
           "pipeline": res.pipeline,
           "fused_stages": dict(res.fused_stages),
           "fused_reasons": dict(res.fused_reasons),
           "action_counts": dict(res.action_counts),
           # (capacity-after, off-clock stall seconds) per seen-set
           # doubling — the SEEN_CAPACITY sizing evidence.
           "growth_stalls": list(res.growth_stalls),
           # Host-side per-phase wall-time breakdown for THIS run
           # (obs/ phase timers) — same shape bench.py embeds.
           "phases": {k: round(v, 4) for k, v in res.phases.items()},
           # TLC-style per-action coverage (obs/coverage.py), same
           # object bench JSON carries; also mirrored as coverage/*
           # gauges in the "stats" op.
           "coverage": dict(res.coverage),
           # TLC-parity statespace report (obs/report.py): collision
           # probability, per-level table, out-degree, seen-set load.
           # Also mirrored as statespace/* gauges in "stats", so the
           # two surfaces can never disagree about the scalar spine.
           "report": dict(res.report),
           "violation": None, "deadlock": None}
    if res.violation is not None:
        out["violation"] = _violation_json(engine, res.violation,
                                           setup.dims)
    if res.deadlock is not None:
        out["deadlock"] = format_state(res.deadlock, setup.dims)
    return out


def _do_swarm(req, telemetry=None, _loaded=None, device="cuda"):
    """Run one swarm-mode check request — the cheap high-QPS tier
    (engine/swarm.py), reached via ``_do_check``'s mode routing.  Same
    warm-cache + per-request contract as ``_do_check``: the built
    engine is LRU-cached on the program-shaping knobs (walks, depth,
    batch, pipeline key the cache; seed and the step/wall budgets are
    per-request run() arguments), and the job executor's scoped
    ``events_out`` / ``postmortem_dir`` / ``run_context`` are
    (re)assigned on EVERY request so a cached engine never leaks one
    job's paths into the next."""
    from .engine.check import (initial_states, resolve_constraint,
                               resolve_invariants)
    from .engine.swarm import SwarmEngine

    setup, ident, cfg_text = (_loaded if _loaded is not None
                              else _load_setup(req))
    backend = setup.backend
    walks = (int(req["walks"]) if req.get("walks") is not None
             else int(backend.get("WALKS", 1024)))
    max_depth = (int(req["max_depth"])
                 if req.get("max_depth") is not None
                 else int(setup.max_diameter or 128))
    batch = (int(req["batch"]) if req.get("batch") is not None
             else int(backend.get("BATCH", walks)))
    pipeline = (req["pipeline"] if req.get("pipeline") is not None
                else backend.get("PIPELINE", "auto"))
    key = (ident, "swarm", walks, max_depth, min(batch, walks), pipeline,
           str(device))
    eng = _cache_get(_SWARMS, key, "swarm_cache")
    if eng is None:
        # The hunt observatory is on, as in the JAX server's swarm.
        eng = SwarmEngine(setup.dims,
                          invariants=resolve_invariants(setup),
                          constraint=resolve_constraint(setup),
                          walks=walks, max_depth=max_depth,
                          batch=min(batch, walks), pipeline=pipeline,
                          metrics=_METRICS, hunt=True, device=device)
        _cache_put(_SWARMS, key, eng, "swarm_cache")
    tel = telemetry or {}
    eng.events_out = tel.get("events_out")
    eng.postmortem_dir = tel.get("postmortem_dir")
    eng.run_context_extra = tel.get("run_context")
    # Progress cadence is per-request (a watch-heavy client wants
    # sub-second swarm_progress lines); reassigned every request so a
    # cached engine never inherits the previous job's cadence.
    eng.progress_seconds = (float(req["progress_seconds"])
                            if req.get("progress_seconds") is not None
                            else 5.0)
    seed = int(req.get("seed", 0))
    res = eng.run(initial_states(setup, seed=seed), seed=seed,
                  num_steps=(int(req["num_steps"])
                             if req.get("num_steps") is not None
                             else None),
                  max_seconds=(req.get("max_seconds")
                               if req.get("max_seconds") is not None
                               else setup.max_seconds))
    history_path = tel.get("history")
    if history_path:
        # Two ledger legs per served swarm run: kind=swarm (the tier's
        # own dialect, with the swarm rate block) AND the kind=server
        # serving leg every server-executed check lands — one run,
        # both ledger surfaces.  Bookkeeping only: a ledger write
        # failure must not fail the response.
        try:
            from .obs import history as history_mod
            from .obs.flight import host_fingerprint
            ctx = tel.get("run_context") or {}
            hfp = host_fingerprint()
            hunt_sum = None
            if res.report.get("hunt"):
                from .obs import hunt as hunt_obs
                hunt_sum = hunt_obs.summarize(res.report["hunt"])
            for kind, extra in (
                    ("swarm", {"swarm": res.report.get("swarm"),
                               "hunt": hunt_sum}),
                    ("server", {"job_id": ctx.get("job_id"),
                                "tenant": ctx.get("tenant"),
                                "mode": "swarm"})):
                history_mod.append_entry(
                    history_path,
                    history_mod.entry_from_result(
                        kind, res, cfg_text=cfg_text, dims=setup.dims,
                        host_fingerprint=hfp, label=_cfg_label(req),
                        extra=extra))
        except Exception as e:
            import sys as _sys
            print(f"server history append failed: "
                  f"{type(e).__name__}: {e}", file=_sys.stderr)
    out = {"ok": True, "mode": "swarm", "walks": res.walks,
           "steps": res.steps, "visited": res.visited,
           "traces": res.traces, "distinct": res.distinct,
           "generated": res.generated, "diameter": res.diameter,
           "stop_reason": res.stop_reason,
           "wall_seconds": round(res.wall_seconds, 3),
           "steps_per_second": round(res.steps_per_second, 1),
           "walks_per_second": round(res.walks_per_second, 1),
           "violation_at_seconds": res.violation_at_seconds,
           "pipeline": res.pipeline,
           "phases": {k: round(v, 4) for k, v in res.phases.items()},
           "report": dict(res.report),
           "hunt": res.report.get("hunt"),
           "violation": None}
    if res.violation is not None:
        out["violation"] = _violation_json(eng, res.violation,
                                           setup.dims)
    return out


def _do_simulate(req, device="cuda"):
    from .engine.check import resolve_constraint, resolve_invariants
    from .engine.simulate import Simulator
    from .engine.check import initial_states

    setup, ident, _cfg_text = _load_setup(req)
    batch = (int(req["batch"]) if req.get("batch") is not None
             else int(setup.backend.get("BATCH", 1024)))
    depth = int(req.get("depth", 100))
    key = (ident, batch, depth, str(device))
    sim = _cache_get(_SIMS, key, "sim_cache")  # warm path, like _ENGINES
    if sim is None:
        sim = Simulator(setup.dims,
                        invariants=resolve_invariants(setup),
                        constraint=resolve_constraint(setup),
                        batch=batch, depth=depth, device=device)
        _cache_put(_SIMS, key, sim, "sim_cache")
    res = sim.run(initial_states(setup, seed=int(req.get("seed", 0))),
                  num_steps=int(req.get("num_steps", 1 << 20)),
                  seed=int(req.get("seed", 0)),
                  max_seconds=req.get("max_seconds"))
    out = {"ok": True, "steps": res.steps, "traces": res.traces,
           "wall_seconds": round(res.wall_seconds, 3), "violation": None}
    if res.violation_invariant is not None:
        from .models.pystate import format_state
        out["violation"] = {
            "invariant": res.violation_invariant,
            "trace": [
                {"action": ("Init" if g < 0
                            else setup.dims.describe_instance(g)),
                 "state": format_state(st, setup.dims)}
                for g, st in (res.violation_trace or [])]}
    return out


def _do_metrics() -> dict:
    """Prometheus text exposition of the same process-global registry
    the ``stats`` op serves as JSON — one snapshot() call feeds both,
    so the two views can never disagree about a counter taken in the
    same instant (the acceptance contract tests exactly this)."""
    from .obs.expose import (CONTENT_TYPE, default_labels,
                             render_prometheus)
    return {"ok": True,
            "content_type": CONTENT_TYPE,
            "exposition": render_prometheus(_METRICS.snapshot(),
                                            labels=default_labels())}


def _do_stats() -> dict:
    """The live-stats endpoint: the process-global registry verbatim
    (request counts, per-op latency histograms, LRU cache hit/miss/
    eviction counters) plus the caches' occupancy.  Read-only and
    lock-free — it answers instantly even while a check owns the device
    lock, which is the whole point of a LIVE stats op."""
    return {"ok": True,
            "metrics": _METRICS.snapshot(),
            "engine_cache": {"size": len(_ENGINES),
                             "capacity": _CACHE_CAP},
            "sim_cache": {"size": len(_SIMS), "capacity": _CACHE_CAP},
            "swarm_cache": {"size": len(_SWARMS),
                            "capacity": _CACHE_CAP}}


def _execute_job(request: dict, job: dict,
                 history: Optional[str] = None, device="cuda") -> dict:
    """JobManager executor: the job's request through the SAME device
    lock + handlers as the blocking ops (engine semantics untouched),
    with per-job telemetry scoping — the job's own event log and
    postmortem dir, job/tenant tags on the flight ring's run_context
    record, and the owning server's history ledger."""
    tel = {"events_out": job.get("events_out"),
           "postmortem_dir": job.get("job_dir"),
           "history": history,
           "run_context": {"job_id": job["id"],
                           "tenant": job["tenant"]}}
    with _LOCK:
        if request.get("op") == "simulate":
            return _do_simulate(request, device=device)
        return _do_check(request, telemetry=tel, device=device)


def _cache_key_for(req: dict, inner: dict) -> Optional[str]:
    """Result-cache key for a submit request (None = uncacheable /
    caching not asked for).  Keyed by cfg CONTENT fingerprint (the
    history ledger's fingerprint idiom — the cfg text determines the
    model) + the canonicalized engine-shaping request fields.
    Wall-clock-budgeted requests are refused: a max_seconds-truncated
    result is not reusable.  Structural invariant: a cacheable job is
    ALWAYS content-pinned (``_do_submit`` converts cfg paths to
    cfg_text before calling here) — fingerprinting a path the job
    would re-read later is the poisoned-cache TOCTOU, so a path-based
    cacheable request is rejected rather than keyed."""
    if not req.get("cache"):
        return None
    if inner.get("max_seconds") is not None:
        raise ValueError("cache: true is not allowed with max_seconds "
                         "(a wall-clock-truncated result is not "
                         "reusable)")
    import hashlib
    from .obs.history import fingerprint_text
    if inner.get("cfg_text"):
        cfg_fp = fingerprint_text(inner["cfg_text"])
    elif inner.get("cfg"):
        raise ValueError("cacheable jobs must be content-pinned "
                         "(cfg_text); _do_submit converts paths")
    else:
        raise ValueError("need 'cfg' (path) or 'cfg_text'")
    shape = {k: v for k, v in sorted(inner.items())
             if k not in ("cfg", "cfg_text")}
    blob = json.dumps([inner.get("op", "check"), cfg_fp, shape],
                      sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def _do_submit(req: dict, manager) -> dict:
    inner = req.get("job")
    if not isinstance(inner, dict) \
            or inner.get("op") not in ("check", "simulate"):
        raise ValueError("submit needs a 'job' object whose op is "
                         "'check' or 'simulate'")
    # Validate the engine-tier selector at ADMISSION, not execution:
    # an unknown mode must answer THIS submit with a clean
    # {"ok": false}, never queue and then surface as an
    # executor-thread exception hours later.
    if inner.get("mode") not in (None, "exhaustive", "swarm"):
        _METRICS.counter("server/rejected/bad_mode")
        raise ValueError(f"unknown mode {inner.get('mode')!r} "
                         f"(expected 'exhaustive' or 'swarm')")
    label = _cfg_label(inner)
    if req.get("cache") and inner.get("cfg"):
        # Pin the cfg CONTENT at submit time: the cache key is
        # fingerprinted now, but the job runs later — a path-based job
        # would re-read the file at execution, and an edit in between
        # would store the NEW model's result under the OLD content's
        # key (a poisoned cache hit).  Content-addressing the job
        # closes the window.
        with open(inner["cfg"], encoding="utf-8") as f:
            inner = dict(inner, cfg_text=f.read())
        inner.pop("cfg")
    job = manager.submit(dict(inner), tenant=req.get("tenant"),
                         label=label,
                         cache_key=_cache_key_for(req, inner),
                         slo_seconds=req.get("slo_seconds"))
    return {"ok": True, "job": job}


def _do_job_op(op: str, req: dict, manager) -> dict:
    if op == "jobs":
        limit = req.get("limit")
        out = {"ok": True}
        out.update(manager.jobs_doc(
            tenant=req.get("tenant"), state=req.get("state"),
            limit=int(limit) if limit is not None else None))
        return out
    job_id = req.get("job_id")
    if not job_id:
        raise ValueError(f"{op} needs 'job_id'")
    if op == "status":
        return {"ok": True, "job": manager.get(job_id)}
    if op == "cancel":
        return {"ok": True, "job": manager.cancel(job_id)}
    # op == "result": state + result read under one manager lock (a
    # retention eviction between two reads must not turn a fetched
    # result into an 'unknown job' error).
    doc = manager.result_doc(job_id)
    return {"ok": True, "state": doc["state"], "result": doc["result"]}


#: Ops that need the job manager (serving/) — split out so the metric
#: label table and the dispatch below can never disagree.
_JOB_OPS = ("submit", "status", "result", "cancel", "jobs")


def handle_request(req: dict, manager=None, device="cuda",
                   platform: Optional[dict] = None) -> dict:
    """One request's response.  ``device`` is the server's (every run goes
    there); ``platform`` is what ``ping`` answers, read once at
    ``serve()`` so that ``ping`` makes no CUDA call (without it, the
    device's type alone)."""
    op = req.get("op")
    # Metric names must not echo client-controlled strings: one counter +
    # histogram per distinct bogus op would grow the process-global
    # registry without bound in this long-lived service.
    op_label = op if op in ("ping", "check", "simulate", "stats",
                            "metrics") + _JOB_OPS else "unknown"
    _METRICS.counter(f"server/requests/{op_label}")
    ok = False
    with _METRICS.phase_timer(f"request/{op_label}"):
        try:
            if op == "ping":
                resp = {"ok": True}
                resp.update(platform or {"platform": (
                    "gpu" if str(device).startswith("cuda") else "cpu")})
            elif op == "stats":
                resp = _do_stats()
            elif op == "metrics":
                resp = _do_metrics()
            elif op in _JOB_OPS:
                # Job ops never take the device lock: submit journals
                # and returns; the executor thread does the running.
                if manager is None:
                    resp = {"ok": False,
                            "error": "no job manager (job ops need a "
                                     "served CheckerServer)"}
                elif op == "submit":
                    resp = _do_submit(req, manager)
                else:
                    resp = _do_job_op(op, req, manager)
            elif op in ("check", "simulate"):
                # Direct (blocking) ops log to the same per-server
                # ledger as jobs — the manager holds the path.
                hist = getattr(manager, "history_path", None)
                with _LOCK:
                    resp = (_do_check(req, telemetry={"history": hist},
                                      device=device)
                            if op == "check"
                            else _do_simulate(req, device=device))
            else:
                resp = {"ok": False, "error": f"unknown op {op!r}"}
            ok = bool(resp.get("ok"))
            return resp
        except Exception as e:
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        finally:
            if not ok:
                _METRICS.counter(f"server/errors/{op_label}")


class _Handler(socketserver.StreamRequestHandler):
    """Connection hardening (resilience): the service is long-lived, so a
    single connection must not be able to take it down or pin it —

    - the request LINE is size-bounded (``max_request_bytes``): the
      newline-delimited protocol otherwise buffers an arbitrarily long
      line in RAM before json parsing ever sees it, so one huge line
      could OOM the whole warm-engine process;
    - the socket gets an IDLE timeout (``idle_timeout_seconds``): a dead
      or wedged client would otherwise hold its handler thread (and its
      open fd) forever.  The timeout covers reads between requests and
      response writes — a check/simulate in flight does not tick it,
      because the handler is computing, not blocked on the socket.

    The oversized reject answers ``{"ok": false}`` (the client is
    mid-exchange and waiting for a line) and then closes — an oversized
    line cannot be resynced, its remainder would parse as garbage
    requests.  The idle timeout closes SILENTLY: the client is between
    requests, and an unsolicited error line sitting in the socket
    buffer would be misread as the response to whatever it sends next
    from a stale pooled connection."""

    def handle(self):
        srv = self.server
        try:
            self.connection.settimeout(srv.idle_timeout_seconds)
        except OSError:
            pass
        while True:
            try:
                line = self.rfile.readline(srv.max_request_bytes + 1)
            except (TimeoutError, OSError):
                _METRICS.counter("server/rejected/idle_timeout")
                return       # silent close: see class docstring
            if not line:
                return
            if len(line) > srv.max_request_bytes:
                _METRICS.counter("server/rejected/oversized")
                self._try_respond({
                    "ok": False,
                    "error": f"request line exceeds "
                             f"{srv.max_request_bytes} bytes"})
                return
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except json.JSONDecodeError as e:
                resp = {"ok": False, "error": f"bad json: {e}"}
            else:
                if isinstance(req, dict) and req.get("op") == "watch":
                    # The one streaming op: run attach emits one
                    # snapshot line per interval on THIS connection,
                    # then a done line; the connection then continues
                    # serving normal requests.
                    if not self._serve_watch(req):
                        return
                    continue
                srv = self.server
                resp = handle_request(req, getattr(srv, "jobs", None),
                                      device=getattr(srv, "device", "cuda"),
                                      platform=getattr(srv, "platform",
                                                       None))
            if not self._try_respond(resp):
                return

    def _serve_watch(self, req: dict) -> bool:
        """Stream flight-recorder snapshots (obs/flight.py) until the
        watched run ends, ``count`` snapshots have been sent, or the
        client goes away.  Never touches the device lock — attach to a
        server mid-check and the snapshots flow while the check runs.
        With ``job`` the stream scopes to one job (``_serve_job_watch``).
        Returns False when the client died (ends the handler)."""
        import time as _time

        from .obs.flight import RECORDER
        _METRICS.counter("server/requests/watch")
        try:
            interval = min(max(float(req.get("interval", 1.0)), 0.05),
                           60.0)
            count = int(req.get("count", 0))
        except (TypeError, ValueError) as e:
            return self._try_respond(
                {"ok": False, "error": f"bad watch params: {e}"})
        # 0/negative = until run end — still bounded so an orphaned
        # watcher cannot pin its handler thread forever.
        limit = count if count > 0 else 3600
        mgr = getattr(self.server, "jobs", None)
        if req.get("job"):
            return self._serve_job_watch(str(req["job"]), mgr,
                                         interval, count, limit)
        attach_seq = RECORDER.note_attach(
            transport="server", peer=str(self.client_address[0]),
            interval=interval, count=count)
        sent = 0
        saw_run = False
        t_attach = _time.monotonic()
        while True:
            run_end = RECORDER.last_event("run_end")
            snapshot = {
                "seq": RECORDER.seq(), "armed": RECORDER.armed,
                "run": RECORDER.last_record("run_context"),
                "progress": RECORDER.last_record("progress"),
                "level": RECORDER.last_event("level_complete"),
                "coverage": RECORDER.last_event("coverage"),
                "chunk_stage": RECORDER.last_record("chunk_stage"),
                "hunt": RECORDER.last_record("hunt"),
            }
            if not self._try_respond({"ok": True, "watch": snapshot}):
                return False
            sent += 1
            ended = (run_end is not None
                     and run_end["seq"] > attach_seq)
            saw_run = saw_run or RECORDER.armed or ended
            # A live job queue counts as a live run for idleness: a
            # watcher attached while jobs are still queued (the engine
            # not yet armed) must ride out the whole queue wait, not
            # get reaped by the no-run grace below.
            jobs_alive = mgr is not None and mgr.has_live_jobs()
            # Done when: the watched run ended after we attached; an
            # explicit count is exhausted; or (count 0) the run we saw
            # is gone / none ever started within the grace window — a
            # watcher launched alongside its run must ride out engine
            # construction and the first graph captures (seconds on a cold
            # cache), so the no-run-yet grace is time-based.
            idle = (count <= 0 and not RECORDER.armed and not jobs_alive
                    and (saw_run
                         or _time.monotonic() - t_attach
                         > self.server.watch_grace_seconds))
            if sent >= limit or ended or idle:
                # Re-read: the run can end (emit run_end, then disarm)
                # between the loop-top read and the idle computation —
                # the done line must carry the freshest record, not a
                # stale null.  Pre-attach run_ends stay out: the done
                # line reports THIS watch's run or nothing.
                end = RECORDER.last_event("run_end")
                if end is not None and end["seq"] <= attach_seq:
                    end = None
                return self._try_respond(
                    {"ok": True, "done": True, "snapshots": sent,
                     "run_end": end})
            _time.sleep(interval)

    def _serve_job_watch(self, job_id: str, mgr, interval: float,
                         count: int, limit: int) -> bool:
        """Per-job run attach: one snapshot per interval carrying the
        job's registry summary, plus the flight ring's progress records
        while THIS job owns the device (the manager's running id is
        the authority; the ring's run_context carries the same job_id
        tag).  Liveness is the JOB's, not the engine's: a queued or
        compiling job keeps its watcher — the stream closes on the
        job's terminal state, an explicit ``count``, or a ~24 h safety
        bound; a bound hit on a still-live job closes with
        ``truncated: true`` (re-attach to keep watching), never with a
        false claim that the job ended."""
        import time as _time

        from .obs.flight import RECORDER
        if count <= 0:
            # The generic watch's 3600-snapshot cap would reap a
            # watcher of a deeply queued job in minutes at small
            # intervals; the job stream's orphan bound is a day.
            limit = max(3600, int(86400.0 / interval))
        if mgr is None:
            return self._try_respond(
                {"ok": False, "error": "no job manager"})
        try:
            job = mgr.get(job_id)
        except KeyError as e:
            return self._try_respond({"ok": False, "error": str(e)})
        RECORDER.note_attach(
            transport="server", peer=str(self.client_address[0]),
            interval=interval, count=count, job_id=job_id)
        sent = 0
        while True:
            try:
                job = mgr.get(job_id)
            except KeyError:
                # Terminal-retention eviction raced the watch loop:
                # the job went terminal and was pruned between polls.
                # Close with a done line carrying the last summary we
                # saw — never a dead socket with no terminal record.
                return self._try_respond(
                    {"ok": True, "done": True, "snapshots": sent,
                     "job": job, "evicted": True})
            running = mgr.running_job_id() == job_id
            snapshot = {"seq": RECORDER.seq(), "armed": RECORDER.armed,
                        "job": job, "running": running}
            runrec = RECORDER.last_record("run_context")
            if running and runrec is not None \
                    and runrec.get("job_id") == job_id \
                    and RECORDER.context().get("job_id") == job_id:
                # Ring records are attributed to THIS job only once the
                # armed run_context carries its tag, and only records
                # NEWER than that context (seq-ordered) — a stale
                # progress line from the previous run must never render
                # as this job's.
                snapshot["run"] = runrec
                for key, rec in (
                        ("progress", RECORDER.last_record("progress")),
                        ("level",
                         RECORDER.last_event("level_complete")),
                        ("coverage", RECORDER.last_event("coverage")),
                        ("hunt", RECORDER.last_record("hunt"))):
                    if rec is not None and rec["seq"] > runrec["seq"]:
                        snapshot[key] = rec
            terminal = job["state"] in ("done", "failed", "cancelled")
            if terminal:
                return self._try_respond(
                    {"ok": True, "done": True, "snapshots": sent,
                     "job": job})
            if not self._try_respond({"ok": True, "watch": snapshot}):
                return False
            sent += 1
            if sent >= limit:
                return self._try_respond(
                    {"ok": True, "done": True, "snapshots": sent,
                     "job": job,
                     # Only an explicit count is a clean close; the
                     # safety bound on a live job is a truncation.
                     "truncated": count <= 0})
            _time.sleep(interval)

    def _try_respond(self, resp: dict) -> bool:
        """Best-effort one-line reply; False when the client is gone (a
        failed write must end the handler, never crash the thread)."""
        try:
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()
            return True
        except (TimeoutError, OSError):
            _METRICS.counter("server/rejected/dead_client")
            return False


class CheckerServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    # Hardening knobs (see _Handler): overridable per instance/CLI.
    max_request_bytes = 10 << 20       # a sane cfg_text is far smaller
    idle_timeout_seconds = 300.0
    # How long a count-0 watch with NO live run and NO live jobs waits
    # before concluding there is nothing to watch (see _serve_watch).
    # Class-level so the idle-vs-watch regression tests can shrink it.
    watch_grace_seconds = 120.0
    # Serving layer (serve() wires these): the JobManager behind the
    # submit/status/result/cancel/jobs ops + per-job watch, and the
    # optional HTTP exposition listener (--metrics-port).
    jobs = None
    metrics_http = None
    # The device every request runs on, and ping's answer (serve()).
    device = "cuda"
    platform = None

    def server_close(self):
        """Tear down the serving side too: the exposition listener's
        socket and the job executor thread (its queued jobs stay
        journaled for the next server on the same --job-dir).  The
        close WAITS for the in-flight job to finish journaling its
        terminal state — a same-process successor on the same job dir
        would otherwise replay the journal's last word ('running'),
        re-queue the job, and execute it twice while the old executor
        is still finishing it (graceful drain, like the device lock)."""
        if self.metrics_http is not None:
            try:
                self.metrics_http.shutdown()
                self.metrics_http.server_close()
            except Exception:
                pass
            self.metrics_http = None
        if self.jobs is not None:
            if not self.jobs.close(wait=True):
                # The drain gave up (a check can outlast the join
                # budget): the in-flight job is STILL RUNNING and will
                # journal its terminal state when it finishes.  Say so
                # loudly — a successor server started on this job dir
                # before then would replay the 'running' tail and run
                # that job a second time.
                import sys
                print(f"server_close: job executor still running "
                      f"(job {self.jobs.running_job_id()}); do not "
                      f"start another server on "
                      f"{self.jobs.base_dir!r} until it finishes",
                      file=sys.stderr)
        super().server_close()


def serve(host: str = "127.0.0.1", port: int = 8610,
          max_request_bytes: Optional[int] = None,
          idle_timeout_seconds: Optional[float] = None,
          job_dir: Optional[str] = None,
          job_queue_capacity: Optional[int] = None,
          history: Optional[str] = None,
          metrics_port: Optional[int] = None,
          device: str = "cuda") -> CheckerServer:
    """Create (and return) a listening server; caller decides threading.
    Port 0 picks an ephemeral port (see ``server_address[1]``).

    ``job_dir`` is where the job journal + per-job artifact dirs live;
    None uses a fresh per-process temp dir (jobs work, but the registry
    does not survive a restart — pass a stable dir for that).
    ``history`` appends a kind=server run-history ledger entry per
    server-executed check (scoped to THIS server — several servers in
    one process keep separate ledgers).  ``metrics_port`` serves GET
    /metrics + /flight + /jobs over HTTP from this process (0 =
    ephemeral port, see ``metrics_http.server_address``).  ``device``
    (``cuda``, the default, or ``cpu``) is where every request runs: a
    server for ``cuda`` on a machine without a card raises here, before
    it listens."""
    from .utils.device import resolve_device
    dev = resolve_device(device)
    platform = _platform_of(dev)
    srv = CheckerServer((host, port), _Handler)
    srv.device, srv.platform = str(dev), platform
    if max_request_bytes is not None:
        srv.max_request_bytes = max_request_bytes
    if idle_timeout_seconds is not None:
        srv.idle_timeout_seconds = idle_timeout_seconds
    from .serving import JobManager
    if job_dir is None:
        job_dir = tempfile.mkdtemp(prefix="raft-jobs-")

    def _executor(request, job):
        return _execute_job(request, job, history=history,
                            device=srv.device)

    srv.jobs = JobManager(
        job_dir, executor=_executor, metrics=_METRICS,
        history_path=history,
        **({"queue_capacity": int(job_queue_capacity)}
           if job_queue_capacity is not None else {}))
    if metrics_port is not None:
        from .obs.expose import start_metrics_server
        from .obs.flight import RECORDER
        srv.metrics_http, _ = start_metrics_server(
            int(metrics_port), _METRICS, flight=RECORDER, host=host,
            # Newest 1000 rows per GET: a scraper polling /jobs must
            # not serialize the whole 10k-job retention under the
            # manager lock every few seconds (counts stay global).
            jobs_provider=lambda: srv.jobs.jobs_doc(limit=1000))
    return srv


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(prog="raft_tla_tpu_torch.server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8610)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where every request runs: the card (default; "
                        "raises at start without one) or the CPU's plain "
                        "PyTorch versions")
    p.add_argument("--max-request-bytes", type=int, default=None,
                   help="reject request lines larger than this "
                        f"(default {CheckerServer.max_request_bytes})")
    p.add_argument("--idle-timeout", type=float, default=None,
                   help="drop connections idle longer than this many "
                        "seconds "
                        f"(default {CheckerServer.idle_timeout_seconds})")
    p.add_argument("--job-dir", default=None, metavar="DIR",
                   help="job journal + per-job artifact dirs (serving/"
                        "): pass a stable directory so the job "
                        "registry survives restarts — queued jobs "
                        "resume, the job a crash caught running is "
                        "re-run once then failed with a postmortem "
                        "pointer.  Default: a fresh temp dir (jobs "
                        "work, no cross-restart durability)")
    p.add_argument("--job-queue", type=int, default=None, metavar="N",
                   help="admission queue capacity (queued jobs beyond "
                        "this are rejected with server/rejected/"
                        "queue_full; default 64)")
    p.add_argument("--history", default=None, metavar="FILE",
                   help="append a kind=server run-history ledger entry "
                        "(obs/history.py, with host_key + job/tenant "
                        "ids) per server-executed check, so "
                        "scripts/bench_history.py renders served "
                        "traffic alongside CLI runs")
    p.add_argument("--metrics-port", type=int, default=None,
                   metavar="PORT",
                   help="serve GET /metrics (Prometheus text "
                        "exposition), /flight (flight-recorder ring), "
                        "and /jobs (job registry) over HTTP from this "
                        "process — the natural scrape target for the "
                        "long-lived service")
    args = p.parse_args(argv)
    srv = serve(args.host, args.port,
                max_request_bytes=args.max_request_bytes,
                idle_timeout_seconds=args.idle_timeout,
                job_dir=args.job_dir,
                job_queue_capacity=args.job_queue,
                history=args.history,
                metrics_port=args.metrics_port,
                device=args.device)
    print(f"raft_tla_tpu_torch checker service on "
          f"{srv.server_address[0]}:{srv.server_address[1]} "
          f"({srv.platform.get('device') or srv.device})", flush=True)
    if srv.metrics_http is not None:
        print(f"metrics: http://{srv.metrics_http.server_address[0]}:"
              f"{srv.metrics_http.server_address[1]}/metrics "
              f"(+ /flight /jobs)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
