"""Command line: ``python3 -m raft_tla_tpu_torch check <cfg>``.

Runs the exhaustive check on the card (``--device cpu`` for the plain
PyTorch versions) with the engine sizes and plan of the cfg's ``\\* TPU:``
directives (``--pipeline`` overrides PIPELINE), prints the TLC-style
result block and, for a violation with trace recording on, the replayed
counterexample.  Exit
code 0 when the run exhausts or stops on a budget, 1 on a violation or
deadlock.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from .engine.check import (engine_config_from_backend, format_result,
                           initial_states, make_engine)
from .models.pystate import format_state
from .utils.cfg import load_config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raft_tla_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check", help="exhaustive BFS check of a TLC cfg")
    c.add_argument("cfg")
    c.add_argument("--device", default="cuda")
    c.add_argument("--max-diameter", type=int)
    c.add_argument("--no-trace", action="store_true")
    c.add_argument("--pipeline", choices=("v3", "v4"))
    args = ap.parse_args(argv)

    setup = load_config(args.cfg)
    cfg = engine_config_from_backend(setup)
    cfg = dataclasses.replace(cfg, max_diameter=args.max_diameter,
                              record_trace=not args.no_trace,
                              pipeline=args.pipeline or cfg.pipeline)
    engine = make_engine(setup, cfg, device=args.device)
    res = engine.run(initial_states(setup))
    print(format_result(res))
    if res.violation is not None and not args.no_trace:
        for depth, (g, st) in enumerate(
                engine.replay(res.violation.fingerprint)):
            what = "Init" if g < 0 else setup.dims.describe_instance(g)
            print(f"{depth}: {what}\n{format_state(st, setup.dims)}")
    return 1 if (res.violation or res.deadlock) else 0


if __name__ == "__main__":
    sys.exit(main())
