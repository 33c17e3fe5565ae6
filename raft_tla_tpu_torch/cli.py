"""Command line: ``python3 -m raft_tla_tpu_torch check <cfg>`` and
``python3 -m raft_tla_tpu_torch simulate <cfg>``.

Runs the exhaustive check on the card (``--device cpu`` for the plain
PyTorch versions) with the engine sizes and plan of the cfg's ``\\* TPU:``
directives (a flag overrides its directive: ``--batch`` BATCH,
``--queue-capacity`` QUEUE_CAPACITY, ``--seen-capacity`` SEEN_CAPACITY,
``--pipeline`` PIPELINE,
``--checkpoint-dir`` CHECKPOINT_DIR, ``--checkpoint-every``,
``--checkpoint-interval``, ``--keep-checkpoints``, ``--spill-dir``
SPILL_DIR, ``--progress-interval`` PROGRESS_SECONDS, ``--por-table``
POR_TABLE; ``--max-seconds`` over the cfg's StopAfter duration,
``--no-degrade`` to fail on running out of device memory instead of
halving the batch; ``--seed`` for the smoke roots of a cfg with
``Init <- SmokeInit``), prints the
TLC-style progress line on stderr (every 60 s by default) and the
result block and, for a violation with
trace recording on, the replayed counterexample.  ``--resume PATH``
continues from a level snapshot, ``--resume auto`` from the newest intact
one in the checkpoint directory; ``--enqueue-method`` picks the chunk's
tail.  Exit code 0 when the run exhausts or stops on a budget, 1 on a
violation or deadlock.

``check --mode swarm`` (or the cfg's ``\\* TPU: MODE = swarm``) runs the
randomized-walk swarm instead (``engine/swarm.py``; ``--walks`` over
WALKS over 1024, ``--max-depth`` over the cfg's diameter budget over 128,
``--batch`` lanes a dispatch over BATCH over the walks, at most 65,536;
``--seed`` its seed),
prints the JAX CLI's summary line and, on a violation, the replayed
trace (exit 1).  ``simulate`` runs TLC-style random traces
(``engine/simulate.py``: ``--num-steps`` walker-steps, ``--depth``,
``--batch`` walkers, ``--max-seconds`` over the cfg's StopAfter,
``--seed``) and prints the JAX CLI's result block.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from .engine import checkpoint as ckpt_mod
from .engine.check import (MODES, engine_config_from_backend,
                           format_result, format_swarm, initial_states,
                           make_engine, make_simulator, make_swarm,
                           resolve_mode)
from .ops.pipeline_v3 import ENQUEUE_METHODS
from .models.pystate import format_state
from .utils.cfg import load_config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raft_tla_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check", help="exhaustive BFS check of a TLC cfg")
    c.add_argument("cfg")
    c.add_argument("--device", default="cuda")
    c.add_argument("--batch", type=int, help="parents expanded a batch")
    c.add_argument("--queue-capacity", type=int,
                   help="device rows of the next-level queue")
    c.add_argument("--seen-capacity", type=int,
                   help="initial seen-set slots")
    c.add_argument("--max-diameter", type=int)
    c.add_argument("--max-seconds", type=float,
                   help="duration budget (over the cfg's StopAfter)")
    c.add_argument("--no-trace", action="store_true")
    c.add_argument("--pipeline", choices=("v3", "v4"))
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
    c.add_argument("--progress-interval", "--progress-seconds",
                   dest="progress_interval", type=float,
                   help="seconds between progress lines on stderr (0 = "
                        "none; default 60)")
    c.add_argument("--seed", type=int, default=0,
                   help="seed of the smoke roots (Init <- SmokeInit)")
    c.add_argument("--por-table", metavar="FILE",
                   help="apply a certified POR table (the artifact of the "
                        "JAX package's `analyze --passes por "
                        "--por-artifact FILE`)")
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
    s = sub.add_parser("simulate", help="random-trace simulation")
    s.add_argument("cfg")
    s.add_argument("--device", default="cuda")
    s.add_argument("--batch", type=int,
                   help="walkers (flag > cfg BATCH directive > 1024)")
    s.add_argument("--num-steps", type=int, default=1 << 27,
                   help="total walker-steps (default %(default)s, ~1e8: "
                        "the BASELINE workload)")
    s.add_argument("--depth", type=int, default=100)
    s.add_argument("--max-seconds", type=float,
                   help="wall-clock budget (over the cfg's StopAfter)")
    s.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    setup = load_config(args.cfg)
    if args.cmd == "simulate":
        return _simulate(args, setup)
    try:
        mode = resolve_mode(setup, args.mode)
    except ValueError as e:
        ap.error(str(e))
    if mode == "swarm":
        return _swarm(args, setup)
    cfg = engine_config_from_backend(setup)

    def resolve(flag, current):
        return current if flag is None else flag

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
        checkpoint_dir=resolve(args.checkpoint_dir, cfg.checkpoint_dir),
        checkpoint_every=resolve(args.checkpoint_every,
                                 cfg.checkpoint_every),
        checkpoint_interval_seconds=float(resolve(
            args.checkpoint_interval,
            setup.backend.get("CHECKPOINT_INTERVAL", 60.0))),
        keep_checkpoints=resolve(args.keep_checkpoints,
                                 cfg.keep_checkpoints),
        por_table=resolve(args.por_table, cfg.por_table))
    engine = make_engine(setup, cfg, device=args.device)
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
    if resume is None:
        res = engine.run(initial_states(setup, seed=args.seed))
    else:
        res = engine.run(resume=resume)
    print(format_result(res))
    if res.violation is not None and not args.no_trace:
        _print_trace(engine.replay(res.violation.fingerprint), setup.dims)
    return 1 if (res.violation or res.deadlock) else 0


def _print_trace(steps, dims):
    for depth, (g, st) in enumerate(steps):
        what = "Init" if g < 0 else dims.describe_instance(g)
        print(f"{depth}: {what}\n{format_state(st, dims)}")


def _swarm(args, setup) -> int:
    """``check --mode swarm``: the summary line, and on a violation the
    replayed trace and exit 1."""
    engine = make_swarm(setup, walks=args.walks, max_depth=args.max_depth,
                        batch=args.batch, device=args.device)
    max_seconds = (args.max_seconds if args.max_seconds is not None
                   else setup.max_seconds)
    res = engine.run(initial_states(setup, seed=args.seed), seed=args.seed,
                     max_seconds=max_seconds)
    print(format_swarm(res, engine.max_depth))
    if res.violation is None:
        return 0
    print(f"VIOLATION          {res.violation.invariant} "
          f"(fp {res.violation.fingerprint:#018x})")
    _print_trace(engine.replay(res.violation.fingerprint), setup.dims)
    return 1


def _simulate(args, setup) -> int:
    """``simulate``: the JAX CLI's result block; exit 1 on a violation."""
    sim = make_simulator(setup, batch=args.batch, depth=args.depth,
                         device=args.device)
    max_seconds = (args.max_seconds if args.max_seconds is not None
                   else setup.max_seconds)
    res = sim.run(initial_states(setup, seed=args.seed),
                  num_steps=args.num_steps, seed=args.seed,
                  max_seconds=max_seconds)
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
