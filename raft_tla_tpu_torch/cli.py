"""Command line: ``python3 -m raft_tla_tpu_torch check|explain|simulate
<cfg>``.

``check`` runs the exhaustive check on the card (``--device cpu`` for the
plain PyTorch versions; the cfg's PLATFORM directive when no flag is
given) with the engine sizes and plan of the cfg's ``\\* TPU:`` directives
(a flag overrides its directive: ``--batch`` BATCH, ``--queue-capacity``
QUEUE_CAPACITY, ``--seen-capacity`` SEEN_CAPACITY, ``--pipeline``
PIPELINE (``auto`` and ``v2`` run the v3 plan), ``--checkpoint-dir``
CHECKPOINT_DIR, ``--checkpoint-every``, ``--checkpoint-interval``,
``--keep-checkpoints``, ``--spill-dir`` SPILL_DIR,
``--progress-interval`` PROGRESS_SECONDS, ``--por-table`` POR_TABLE,
``--events-out`` EVENTS_OUT, ``--counterexample-dir``
COUNTEREXAMPLE_DIR, ``--no-report`` REPORT, ``--max-log`` MAX_LOG,
``--n-msg-slots`` N_MSG_SLOTS; ``--max-seconds`` over the cfg's
StopAfter duration, ``--no-degrade`` to fail on running out of device
memory instead of halving the batch; ``--seed`` for the smoke roots of a
cfg with ``Init <- SmokeInit``).  It prints the TLC-style progress line
on stderr (every 60 s by default; at the end, the coverage table and the
statespace report there too) and the result block, then on a violation
the JAX CLI's printout: the TLC-style numbered error trace
(``engine/explain.py``), read back from ``counterexample.txt`` when a
workdir resolved (``--counterexample-dir``, else the directive, else the
checkpoint directory, else the current directory under
``--render-trace``), or the violating state under ``--no-trace``; on a
deadlock the deadlocked state.  ``--metrics-out`` writes the engine's
metrics registry as JSON.  ``--resume PATH`` continues from a level
snapshot, ``--resume auto`` from the newest intact one in the checkpoint
directory; ``--enqueue-method`` picks the chunk's tail.  Exit code 0
when the run exhausts or stops on a budget, 1 on a violation or
deadlock.

``check --mode swarm`` (or the cfg's ``\\* TPU: MODE = swarm``) runs the
randomized-walk swarm instead (``engine/swarm.py``; ``--walks`` over
WALKS over 1024, ``--max-depth`` over the cfg's diameter budget over 128,
``--batch`` lanes a dispatch over BATCH over the walks, at most 65,536;
``--seed`` its seed), prints the JAX CLI's summary line and, on a
violation, the rendered counterexample (exit 1).  ``explain`` runs the
check with trace recording on and renders its counterexample as text,
JSON or HTML (``--format``, ``--out``), and with ``--graph`` writes the
reached state graph as DOT or GraphML.  ``simulate`` runs TLC-style
random traces (``engine/simulate.py``: ``--num-steps`` walker-steps,
``--depth``, ``--batch`` walkers, ``--max-seconds`` over the cfg's
StopAfter, ``--seed``) and prints the JAX CLI's result block.

``--engine`` (``check``, ``explain``, ``simulate``; the JAX CLI's
choices) picks the single-device engine or the mesh (``parallel/``):
``mesh`` shards over every visible card (one shard with ``--device
cpu``), ``auto`` (the default) takes the mesh when more than one card is
visible.

The launch contract of the JAX CLI (``parallel/multihost.py``): export
``RAFT_COORDINATOR`` (host:port), ``RAFT_NUM_PROCESSES`` and
``RAFT_PROCESS_ID`` and run the same command in every process; the group
forms before any device is touched, and the mesh spans every process's
shards (``--engine single`` is a usage error, ``auto`` takes the mesh).
``check`` then needs ``--no-trace``, as in the JAX CLI; ``--trace-dir``
(the TRACE_DIR directive) names the directory where a traced run's
controllers exchange their trace pieces.  Before it returns, ``main``
leaves the process group (``multihost.shutdown``).

Resilience and serving, the JAX CLI's: ``check --supervise[=N]`` runs
the check in a child process and resumes it from the newest intact
snapshot after a crash (``resilience/supervisor.py``; needs a checkpoint
directory), ``check --fault-plan PLAN`` (or ``FAULT_PLAN``) injects
deterministic faults (``resilience/faults.py``).  The clients of the
checker service (``server.py``): ``submit <cfg>`` queues a job (``--wait``
for its result), ``jobs`` lists the registry, ``watch [HOST:PORT |
http://HOST:PORT]`` streams a run's or a job's (``--job``) snapshots.  The
supervisor parent and the clients make no CUDA call: they hold no card
memory.

Observability, the JAX CLI's flags (a flag over its cfg directive):
``--trace-out`` (TRACE_OUT: the run's spans as a Chrome trace),
``--profile-chunks [N]`` (PROFILE_CHUNKS: the stage profile of every Nth
chunk call), ``--perf`` (PERF: launch accounting, roofline and advisor;
implies ``--profile-chunks 16``), ``--metrics-port`` (METRICS_PORT:
``/metrics`` and ``/flight`` on 127.0.0.1 while the run lasts),
``--xla-profile [N]`` and ``--xla-profile-dir`` (XLA_PROFILE: a
``torch.profiler`` capture of the first N chunk calls, a Chrome trace)
and ``--history`` (HISTORY: one run-history entry appended).
``check --mode swarm`` runs the
hunt observatory and prints its report, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

from . import clients
from .engine import checkpoint as ckpt_mod
from .engine import explain as explain_mod
from .engine.bfs import PLAN_NAMES, EngineConfig
from .engine.check import (ENGINES, MODES, device_for,
                           engine_config_from_backend,
                           format_result, format_swarm, initial_states,
                           make_engine, make_simulator, make_swarm,
                           resolve_mode, use_mesh)
from .models.pystate import format_state
from .obs import hunt as hunt_mod
from .ops.pipeline_v3 import ENQUEUE_METHODS
from .parallel import multihost
from .utils.cfg import load_config

PIPELINES = tuple(sorted(PLAN_NAMES))


def _common(sp):
    """The arguments ``check`` and ``explain`` share."""
    sp.add_argument("cfg")
    sp.add_argument("--device",
                    help="cuda (the card) or cpu (flag > cfg PLATFORM "
                         "directive > cuda)")
    sp.add_argument("--batch", type=int, help="parents expanded a batch")
    sp.add_argument("--queue-capacity", type=int,
                    help="device rows of the next-level queue")
    sp.add_argument("--seen-capacity", type=int,
                    help="initial seen-set slots")
    sp.add_argument("--max-diameter", type=int)
    sp.add_argument("--max-seconds", type=float,
                    help="duration budget (over the cfg's StopAfter)")
    sp.add_argument("--pipeline", choices=PIPELINES,
                    help="the chunk's plan (auto and v2 run v3)")
    sp.add_argument("--max-log", type=int,
                    help="log capacity (over the cfg's MAX_LOG)")
    sp.add_argument("--n-msg-slots", type=int,
                    help="message slots (over the cfg's N_MSG_SLOTS)")
    sp.add_argument("--seed", type=int, default=0,
                    help="seed of the smoke roots (Init <- SmokeInit)")
    sp.add_argument("--engine", choices=ENGINES, default="auto",
                    help="mesh = shard over all visible cards (one shard "
                         "with --device cpu or an indexed device); auto = "
                         "mesh iff more than one card (default)")


def main(argv=None) -> int:
    """The command's exit code.  A process group the command forms under
    the launch contract is left (``multihost.shutdown``) before it
    returns; a group its caller formed is the caller's to leave."""
    forms = (bool(os.environ.get("RAFT_COORDINATOR"))
             and not multihost.is_multiprocess())
    try:
        return _main(argv)
    finally:
        if forms:
            multihost.shutdown()


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raft_tla_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check", help="exhaustive BFS check of a TLC cfg")
    _common(c)
    c.add_argument("--no-trace", action="store_true")
    c.add_argument("--enqueue-method", choices=ENQUEUE_METHODS,
                   help="the chunk's tail: fused insert+enqueue kernel "
                        "(default), or the insert kernel and then the "
                        "enqueue kernel / a PyTorch lowering")
    c.add_argument("--checkpoint-dir",
                   help="write level-boundary snapshots here")
    c.add_argument("--checkpoint-every", type=int,
                   help="snapshot every k BFS levels (default 1)")
    c.add_argument("--checkpoint-interval", type=float,
                   help="least seconds between snapshots (default 60; "
                        "0 = every eligible level)")
    c.add_argument("--keep-checkpoints", type=int,
                   help="keep only the newest N intact snapshots")
    c.add_argument("--resume",
                   help="snapshot .npz to resume from, or 'auto' for the "
                        "newest in the checkpoint directory")
    c.add_argument("--spill-dir",
                   help="memory-map spilled level segments here instead "
                        "of host RAM")
    c.add_argument("--no-degrade", action="store_true",
                   help="fail on running out of device memory instead of "
                        "halving the batch and resuming")
    c.add_argument("--supervise", nargs="?", const=3, type=int,
                   metavar="N",
                   help="crash-resume supervisor (resilience/): run the "
                        "check in a child process and, on a crash exit, "
                        "resume it from the newest intact checkpoint with "
                        "exponential backoff, up to N restarts (default "
                        "3).  Requires --checkpoint-dir (or the "
                        "CHECKPOINT_DIR directive); 'restart' events go "
                        "into the JSONL event log")
    c.add_argument("--fault-plan",
                   help="deterministic fault injection (resilience/"
                        "faults.py), e.g. 'ckpt_torn_write@level=3,"
                        "kill@level=5,oom@grow=1'; the FAULT_PLAN "
                        "environment variable is the fallback.  Testing "
                        "and chaos drills only")
    c.add_argument("--progress-interval", "--progress-seconds",
                   dest="progress_interval", type=float,
                   help="seconds between progress lines on stderr (0 = "
                        "none; default 60)")
    c.add_argument("--por-table", metavar="FILE",
                   help="apply a certified POR table (the artifact of the "
                        "JAX package's `analyze --passes por "
                        "--por-artifact FILE`)")
    c.add_argument("--events-out",
                   help="JSONL run events (flag > cfg EVENTS_OUT > "
                        "events.jsonl next to the checkpoint directory)")
    c.add_argument("--metrics-out",
                   help="write the metrics registry's snapshot (JSON) "
                        "here after the run")
    c.add_argument("--counterexample-dir", metavar="DIR",
                   help="where a traced violation's counterexample."
                        "{txt,json} land (flag > cfg COUNTEREXAMPLE_DIR > "
                        "the checkpoint directory)")
    c.add_argument("--render-trace", action="store_true",
                   help="write counterexample.{txt,json} into the current "
                        "directory when no other directory resolves")
    c.add_argument("--no-report", action="store_true",
                   help="no statespace report (flag > cfg REPORT > on)")
    c.add_argument("--mode", choices=MODES,
                   help="checking tier: exhaustive BFS or the randomized-"
                        "walk swarm (flag > cfg MODE directive > "
                        "exhaustive)")
    c.add_argument("--walks", type=int,
                   help="swarm: concurrent walks (flag > cfg WALKS "
                        "directive > 1024)")
    c.add_argument("--max-depth", type=int,
                   help="swarm: depth bound before a walk restarts "
                        "(default: the cfg's diameter budget, else 128)")
    e = sub.add_parser(
        "explain", help="run a check and render its counterexample the "
                        "TLC way, and/or write the reached state graph")
    _common(e)
    e.add_argument("--format", choices=tuple(explain_mod.RENDERERS),
                   default="text", help="the rendering (default text)")
    e.add_argument("--out", metavar="FILE",
                   help="write the rendering here instead of stdout")
    e.add_argument("--graph", metavar="FILE",
                   help="also write the reached state graph (small "
                        "spaces: see --graph-cap)")
    e.add_argument("--graph-format", choices=("dot", "graphml"),
                   help="default: GraphML for a .graphml/.xml file, else "
                        "DOT")
    e.add_argument("--graph-cap", type=int,
                   help="refuse graphs of more states than this "
                        f"(default {explain_mod.GRAPH_CAP_DEFAULT})")
    s = sub.add_parser("simulate", help="random-trace simulation")
    s.add_argument("cfg")
    s.add_argument("--device",
                   help="cuda (the card) or cpu (flag > cfg PLATFORM "
                        "directive > cuda)")
    s.add_argument("--batch", type=int,
                   help="walkers (flag > cfg BATCH directive > 1024)")
    s.add_argument("--num-steps", type=int, default=1 << 27,
                   help="total walker-steps (default %(default)s, ~1e8: "
                        "the BASELINE workload)")
    s.add_argument("--depth", type=int, default=100)
    s.add_argument("--max-seconds", type=float,
                   help="wall-clock budget (over the cfg's StopAfter)")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--engine", choices=ENGINES, default="auto",
                   help="mesh = one walker fleet a visible card; auto = "
                        "mesh iff more than one card (default)")
    s.add_argument("--trace-out",
                   help="write the simulation's spans as Chrome "
                        "trace-event JSON (flag > cfg TRACE_OUT)")
    c.add_argument("--trace-out",
                   help="write the run's spans (every phase, a level span "
                        "a BFS level, the run) as Chrome trace-event JSON "
                        "(flag > cfg TRACE_OUT)")
    c.add_argument("--profile-chunks", nargs="?", const=1, type=int,
                   metavar="N",
                   help="re-run every Nth chunk call's first batch stage "
                        "by stage between CUDA events (default 1): "
                        "chunk_stage/* histograms, a chunk_profile event "
                        "and a stage table on stderr; results are "
                        "bit-identical (flag > cfg PROFILE_CHUNKS)")
    c.add_argument("--perf", action="store_true",
                   help="launch accounting (device ops a step, the "
                        "kernels' launches a chunk), the stages' roofline "
                        "and the fusion advisor: a perf event, perf/* "
                        "gauges and a table; implies --profile-chunks 16 "
                        "(flag > cfg PERF)")
    c.add_argument("--metrics-port", type=int, metavar="PORT",
                   help="serve /metrics (Prometheus text) and /flight "
                        "(the flight recorder's ring) on 127.0.0.1:PORT "
                        "while the run lasts; 0 = off (flag > cfg "
                        "METRICS_PORT)")
    c.add_argument("--xla-profile", nargs="?", const=8, type=int,
                   metavar="N",
                   help="torch.profiler capture (CPU and CUDA activity) "
                        "from the run's start through its first N chunk "
                        "calls (default 8), written as a Chrome trace "
                        "into --xla-profile-dir (flag > cfg XLA_PROFILE)")
    c.add_argument("--xla-profile-dir", metavar="DIR",
                   help="where --xla-profile writes (default: "
                        "<--checkpoint-dir>/xla_profile, else "
                        "./xla_profile)")
    c.add_argument("--history", metavar="FILE",
                   help="append one run-history entry (JSONL: cfg, model "
                        "and host fingerprints, verdict, counts, rates) "
                        "(flag > cfg HISTORY)")
    c.add_argument("--trace-dir",
                   help="shared directory where the controllers of a "
                        "process group exchange their trace pieces "
                        "(flag > cfg TRACE_DIR > the checkpoint "
                        "directory)")
    # The checker service's clients (clients.py): pure sockets.
    clients.add_parsers(sub)

    args = ap.parse_args(argv)

    # The clients: pure sockets, dispatched before any device is touched.
    if args.cmd in clients.COMMANDS:
        return clients.run(args)
    if args.cmd == "check" and args.supervise is not None:
        return _supervise(ap, args, argv)

    if os.environ.get("RAFT_COORDINATOR"):
        # The launch contract: the group forms before any device is
        # touched, and the mesh spans every process's shards.
        multihost.initialize()
        if args.engine == "single":
            ap.error("multi-host mode (RAFT_COORDINATOR) requires "
                     "--engine mesh or auto")
        args.engine = "mesh"
        if args.cmd == "check" and not args.no_trace:
            ap.error("multi-host check requires --no-trace "
                     "(counterexample traces are not multi-host yet)")

    if args.cmd == "simulate":
        return _simulate(args, load_config(args.cfg))
    setup = load_config(args.cfg, max_log=args.max_log,
                        n_msg_slots=args.n_msg_slots)
    if args.cmd == "explain":
        return _explain(args, setup)
    try:
        mode = resolve_mode(setup, args.mode)
    except ValueError as e:
        ap.error(str(e))
    if mode == "swarm":
        return _swarm(args, setup)
    cfg = engine_config_from_backend(setup)

    def resolve(flag, current):
        return current if flag is None else flag

    ckpt_dir = resolve(args.checkpoint_dir, cfg.checkpoint_dir)
    cfg = dataclasses.replace(
        cfg, max_diameter=args.max_diameter,
        max_seconds=args.max_seconds,
        batch=resolve(args.batch, cfg.batch),
        queue_capacity=resolve(args.queue_capacity, cfg.queue_capacity),
        seen_capacity=resolve(args.seen_capacity, cfg.seen_capacity),
        spill_dir=resolve(args.spill_dir, cfg.spill_dir),
        degrade_on_oom=not args.no_degrade,
        progress_interval_seconds=float(resolve(
            args.progress_interval,
            setup.backend.get("PROGRESS_SECONDS", 60.0))),
        record_trace=not args.no_trace,
        pipeline=resolve(args.pipeline, cfg.pipeline),
        enqueue_method=resolve(args.enqueue_method, cfg.enqueue_method),
        checkpoint_dir=ckpt_dir,
        checkpoint_every=resolve(args.checkpoint_every,
                                 cfg.checkpoint_every),
        checkpoint_interval_seconds=float(resolve(
            args.checkpoint_interval,
            setup.backend.get("CHECKPOINT_INTERVAL", 60.0))),
        keep_checkpoints=resolve(args.keep_checkpoints,
                                 cfg.keep_checkpoints),
        por_table=resolve(args.por_table, cfg.por_table),
        events_out=resolve(args.events_out, cfg.events_out),
        trace_dir=resolve(args.trace_dir, cfg.trace_dir),
        trace_out=resolve(args.trace_out, cfg.trace_out),
        profile_chunks_every=resolve(args.profile_chunks,
                                     cfg.profile_chunks_every),
        perf=args.perf or cfg.perf,
        xla_profile_chunks=resolve(args.xla_profile,
                                   cfg.xla_profile_chunks),
        xla_profile_dir=args.xla_profile_dir,
        statespace_report=cfg.statespace_report and not args.no_report,
        counterexample_dir=_counterexample_dir(args, cfg.counterexample_dir,
                                               ckpt_dir))
    # Fault injection (resilience/): --fault-plan or the FAULT_PLAN a
    # supervised child inherits.  Fired markers default next to the
    # checkpoints, so a restarted child never fires a die-class fault at
    # the same level again.
    from .resilience import faults
    faults.install_from_env(
        default_state_dir=(os.path.join(ckpt_dir, ".fault_state")
                           if ckpt_dir else None),
        text=args.fault_plan)
    engine = make_engine(setup, cfg, device=args.device,
                         **_engine_kw(args, setup))
    resume = args.resume
    if resume == "auto":
        if not cfg.checkpoint_dir:
            ap.error("--resume auto requires --checkpoint-dir (or a "
                     "CHECKPOINT_DIR directive)")
        resume = ckpt_mod.latest(cfg.checkpoint_dir)
        if resume is None:
            ap.error("--resume auto: no checkpoint found in "
                     f"{cfg.checkpoint_dir!r}")
        print(f"resuming from {resume}")
    with _metrics_listener(args, setup, engine.metrics):
        if resume is None:
            res = engine.run(initial_states(setup, seed=args.seed))
        else:
            res = engine.run(resume=resume)
    print(format_result(res))
    if args.metrics_out:
        _write_metrics(args.metrics_out, engine.metrics)
    _append_history(args, setup, "check", res)
    if res.violation is not None:
        if args.no_trace:
            print("\nviolating state (trace recording disabled):")
            print(format_state(res.violation.state, setup.dims))
        else:
            print()
            _print_counterexample(engine, res, setup.dims)
        return 1
    if res.deadlock is not None:
        print("\ndeadlock state:")
        print(format_state(res.deadlock, setup.dims))
        return 1
    return 0


@contextlib.contextmanager
def _metrics_listener(args, setup, registry):
    """``--metrics-port`` (METRICS_PORT; 0 is off): the listener up for
    the run; a port it cannot bind is said and the run goes on."""
    port = args.metrics_port
    if port is None:
        port = setup.backend.get("METRICS_PORT")
    srv = None
    if port:
        from .obs.expose import start_metrics_server
        from .obs.flight import RECORDER
        try:
            srv, _thread = start_metrics_server(int(port), registry,
                                                flight=RECORDER)
            print(f"metrics: http://127.0.0.1:{srv.server_address[1]}"
                  f"/metrics (+ /flight)", file=sys.stderr)
        except OSError as e:
            print(f"metrics: cannot listen on port {port} ({e}); "
                  f"continuing without the listener", file=sys.stderr)
    try:
        yield srv
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()


def _append_history(args, setup, kind: str, res, extra=None) -> None:
    """``--history`` (HISTORY): one ledger entry for the run."""
    path = args.history or setup.backend.get("HISTORY")
    if not path:
        return
    from .obs import history as history_mod
    from .obs.flight import host_fingerprint
    with open(args.cfg) as f:
        cfg_text = f.read()
    history_mod.append_entry(path, history_mod.entry_from_result(
        kind, res, cfg_text=cfg_text, dims=setup.dims,
        host_fingerprint=host_fingerprint(),
        label=os.path.basename(args.cfg), extra=extra))
    print(f"history: entry appended to {path}", file=sys.stderr)


def _supervise(ap, args, argv) -> int:
    """``check --supervise[=N]``: this same command again in a child
    process, without ``--supervise`` (the child checks) and ``--resume``
    (the supervisor picks the resume point for each attempt).  The
    parent reads the cfg's directives as text and makes no CUDA call."""
    from .resilience.supervisor import run_supervised, strip_supervisor_flags
    from .utils.cfg import parse_backend_directives
    ckdir, events_out = args.checkpoint_dir, args.events_out
    trace_out = args.trace_out
    if ckdir is None or events_out is None or trace_out is None:
        try:
            with open(args.cfg) as f:
                be = parse_backend_directives(f.read())
        except (OSError, ValueError):
            be = {}
        ckdir = ckdir if ckdir is not None else be.get("CHECKPOINT_DIR")
        events_out = (events_out if events_out is not None
                      else be.get("EVENTS_OUT"))
        trace_out = (trace_out if trace_out is not None
                     else be.get("TRACE_OUT"))
    if not ckdir:
        ap.error("--supervise requires --checkpoint-dir (or a "
                 "CHECKPOINT_DIR directive): crash-resume restarts from "
                 "its snapshots")
    raw = list(argv) if argv is not None else sys.argv[1:]
    child = [sys.executable, "-m", "raft_tla_tpu_torch"] \
        + strip_supervisor_flags(raw)
    # The user's own --resume is honoured on the first attempt.
    return run_supervised(child, ckdir, max_restarts=args.supervise,
                          events_out=events_out, initial_resume=args.resume,
                          trace_out=trace_out)


def _engine_kw(args, setup, key: str = "engine_cls") -> dict:
    """``{key: "mesh"}`` where ``--engine`` resolves to the mesh on the
    run's device, else nothing (the single engine)."""
    if use_mesh(args.engine, device_for(setup, args.device)):
        return {key: "mesh"}
    return {}


def _counterexample_dir(args, directive, ckpt_dir):
    """Flag > directive > (the engine's fallback, the checkpoint
    directory); with none of them, ``--render-trace`` names the current
    directory."""
    d = args.counterexample_dir or directive
    if d is None and args.render_trace and not ckpt_dir:
        d = "."
    return d


def _print_counterexample(engine, res, dims):
    """The rendered trace: the text of ``counterexample.txt`` where the
    run wrote one, else rendered from a replay."""
    if res.counterexample:
        with open(res.counterexample["txt"], encoding="utf-8") as f:
            print(f.read(), end="")
        print(f"\ncounterexample written: {res.counterexample['txt']} "
              "(+ .json)")
    else:
        print(explain_mod.render_text(
            engine.replay(res.violation.fingerprint), dims,
            violation=res.violation), end="")


def _write_metrics(path: str, registry) -> None:
    """``--metrics-out``: the registry's snapshot as sorted JSON, written
    atomically."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(registry.snapshot(), f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def _explain(args, setup) -> int:
    """``explain``: the check with trace recording on at the JAX CLI's
    sizes (flag > directive > 1024 / 2^20 / 2^22), its counterexample
    rendered; exit 1 on a rendered violation, 2 when only the graph
    export failed."""
    be = setup.backend

    def resolve(flag, key, default):
        return flag if flag is not None else be.get(key, default)

    cfg = EngineConfig(
        batch=resolve(args.batch, "BATCH", 1024),
        queue_capacity=resolve(args.queue_capacity, "QUEUE_CAPACITY",
                               1 << 20),
        seen_capacity=resolve(args.seen_capacity, "SEEN_CAPACITY",
                              1 << 22),
        max_diameter=args.max_diameter, max_seconds=args.max_seconds,
        record_trace=True,
        pipeline=resolve(args.pipeline, "PIPELINE", "auto"))
    engine = make_engine(setup, cfg, device=args.device,
                         **_engine_kw(args, setup))
    res = engine.run(initial_states(setup, seed=args.seed))
    rc = 0
    if res.violation is not None:
        steps = engine.replay(res.violation.fingerprint)
        if args.format == "text":
            doc = explain_mod.render_text(steps, setup.dims,
                                          violation=res.violation)
        elif args.format == "json":
            doc = json.dumps(
                explain_mod.render_json(steps, setup.dims,
                                        violation=res.violation),
                indent=2, sort_keys=True) + "\n"
        else:
            doc = explain_mod.render_html(
                steps, setup.dims, violation=res.violation,
                title=f"counterexample: {res.violation.invariant}")
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                f.write(doc)
            print(f"counterexample ({args.format}, {len(steps)} states) "
                  f"-> {args.out}")
        else:
            print(doc, end="")
        rc = 1
    else:
        print(format_result(res))
        print("no violation found; nothing to explain"
              + (" (graph still exported)" if args.graph else ""))
    if args.graph:
        fmt = args.graph_format or (
            "graphml" if args.graph.endswith((".graphml", ".xml"))
            else "dot")
        try:
            text = explain_mod.export_graph(
                engine.trace, setup.dims, fmt=fmt,
                cap=(args.graph_cap if args.graph_cap is not None
                     else explain_mod.GRAPH_CAP_DEFAULT))
        except ValueError as exc:
            print(f"explain: {exc}", file=sys.stderr)
            return rc or 2
        with open(args.graph, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"state graph ({fmt}, {len(engine.trace)} recorded states) "
              f"-> {args.graph}")
    return rc


def _swarm(args, setup) -> int:
    """``check --mode swarm``: the summary line, and on a violation the
    rendered counterexample and exit 1."""
    be = setup.backend
    ckpt_dir = args.checkpoint_dir or be.get("CHECKPOINT_DIR")
    engine = make_swarm(
        setup, walks=args.walks, max_depth=args.max_depth,
        batch=args.batch, device=args.device,
        events_out=args.events_out, checkpoint_dir=ckpt_dir,
        counterexample_dir=_counterexample_dir(
            args, be.get("COUNTEREXAMPLE_DIR"), ckpt_dir),
        progress_seconds=float(
            args.progress_interval if args.progress_interval is not None
            else be.get("PROGRESS_SECONDS", 5.0)),
        hunt=True, perf=args.perf, profile_chunks_every=args.profile_chunks,
        xla_profile_chunks=args.xla_profile,
        xla_profile_dir=args.xla_profile_dir, trace_out=args.trace_out)
    max_seconds = (args.max_seconds if args.max_seconds is not None
                   else setup.max_seconds)
    with _metrics_listener(args, setup, engine.metrics):
        res = engine.run(initial_states(setup, seed=args.seed),
                         seed=args.seed, max_seconds=max_seconds)
    print(format_swarm(res, engine.max_depth))
    hunt = res.report.get("hunt")
    if hunt:
        print(hunt_mod.render_report(hunt))
    if args.metrics_out:
        _write_metrics(args.metrics_out, engine.metrics)
    _append_history(args, setup, "swarm", res, extra={
        "swarm": {"walks": res.walks,
                  "steps_per_sec": round(res.steps_per_second, 1),
                  "walks_per_sec": round(res.walks_per_second, 1),
                  "violation_at_seconds": res.violation_at_seconds},
        "hunt": hunt_mod.summarize(hunt) if hunt else None})
    if res.violation is None:
        return 0
    print()
    _print_counterexample(engine, res, setup.dims)
    return 1


def _simulate(args, setup) -> int:
    """``simulate``: the JAX CLI's result block; exit 1 on a violation."""
    sim = make_simulator(setup, batch=args.batch, depth=args.depth,
                         device=args.device,
                         **_engine_kw(args, setup, "engine"))
    max_seconds = (args.max_seconds if args.max_seconds is not None
                   else setup.max_seconds)
    from .obs.tracing import SpanTracer
    tracer = sim.tracer = SpanTracer(args.trace_out
                                     or setup.backend.get("TRACE_OUT"))
    with tracer.span("simulate_run", num_steps=args.num_steps,
                     batch=sim.batch, depth=args.depth):
        res = sim.run(initial_states(setup, seed=args.seed),
                      num_steps=args.num_steps, seed=args.seed,
                      max_seconds=max_seconds)
    tracer.write()
    print(f"steps visited      {res.steps}")
    print(f"traces             {res.traces}")
    print(f"wall seconds       {res.wall_seconds:.2f}")
    print(f"states/sec         {res.states_per_second:.0f}")
    if res.violation_invariant is None:
        return 0
    print(f"VIOLATION          {res.violation_invariant}")
    for g, st in res.violation_trace or []:
        label = "Initial state" if g < 0 else setup.dims.describe_instance(g)
        print(f"-- {label}")
        print(format_state(st, setup.dims))
    return 1


if __name__ == "__main__":
    sys.exit(main())
