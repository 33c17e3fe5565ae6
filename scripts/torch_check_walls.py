#!/usr/bin/env python3
"""Check walls of the PyTorch port's main path, for comparing two trees.

    python3 scripts/torch_check_walls.py [--root DIR] [--depth 11]
                                         [--runs 3] [--pipeline v4]

Imports ``raft_tla_tpu_torch`` from ``--root`` (default: this checkout),
builds its kernels, and checks ``configs/MCraft_bounded.cfg`` on the card
to ``--depth`` at the main path's sizes (batch 2048, a 2^21-row queue,
2^25 seen slots, trace off; the tree's defaults otherwise, so a tree
with the statespace report runs with it on), once to warm up and then
``--runs`` times.
Prints one JSON line: the tree, the card and its power limit, and each
run's distinct, generated and check seconds (``EngineResult.wall_seconds``,
unrounded).  Two trees compare inside one call, in turns: parent, change,
change, parent, each its own process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--depth", type=int, default=11)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--pipeline", default="v4")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("torch_check_walls: no CUDA card", file=sys.stderr)
        return 2
    from raft_tla_tpu_torch.engine.bfs import EngineConfig
    from raft_tla_tpu_torch.engine.check import run_check
    from raft_tla_tpu_torch.utils import build
    build.build_all()
    cfg = EngineConfig(batch=2048, queue_capacity=1 << 21,
                       seen_capacity=1 << 25, record_trace=False,
                       max_diameter=args.depth, pipeline=args.pipeline)
    path = os.path.join(root, "configs/MCraft_bounded.cfg")
    run_check(path, cfg, device="cuda")          # warm-up
    runs = []
    for _ in range(args.runs):
        res = run_check(path, cfg, device="cuda")
        runs.append({"distinct": res.distinct, "generated": res.generated,
                     "check_seconds": res.wall_seconds})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": root, "card": smi, "depth": args.depth,
                      "pipeline": args.pipeline, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
