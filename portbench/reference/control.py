"""The control: the reference in the program's place, one precision down.

The program keys its seen set on a 64-bit fingerprint; the nearest
precision below is 32 bits.  The control is the oracle's search keyed on
the low 32 bits of a seeded hash of each state (``oracle.bfs`` with
``key_bits=32``), judged by ``compare.judge`` as a check of the program
would be.  At a cell's size two distinct states share a 32-bit key a few
thousand times (about n^2 / 2^33 pairs for n distinct states), each such
state is counted once and its descendants may go unexplored, so its
answer must come out not correct.

    python3 portbench/reference/control.py --config mcraft_bounded \\
        --depth 11 --seed 7 [--bits 32]

prints one JSON line: the control's answer and the compared numbers with
their limits.  Its memory is the widest frontier's states and one int a
distinct state (a few GB at TPUraft L8); it runs on the host alone.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from portbench.reference import compare, oracle  # noqa: E402


def dims_of(config_name: str) -> oracle.Dims:
    """The reference's constants of a configuration (its JSON file)."""
    path = os.path.join(os.path.dirname(compare.HERE), "configs",
                        f"{config_name}.json")
    with open(path) as f:
        return oracle.Dims(**json.load(f)["constants"])


def run_control(config_name: str, depth: int, seed: int,
                bits: int = 32) -> dict:
    dims = dims_of(config_name)
    t = time.time()
    got = oracle.bfs(dims, depth, key_bits=bits, seed=seed)
    seconds = time.time() - t
    ref, _gap = compare.reference_answer(config_name, dims, depth,
                                         live_depth=0)
    check = {"levels": got.levels, "distinct": got.distinct[-1],
             "generated": got.generated[-1],
             "action_counts": dict(zip(oracle.FAMILY_NAMES,
                                       got.actions[-1])),
             "diameter": depth,
             "stop_reason": compare.STOP_AT_DEPTH,
             "violation": got.violation, "deadlock": got.deadlock}
    compared = compare.judge([check], ref)
    return {"config": config_name, "depth": depth, "seed": seed,
            "bits": bits, "seconds": seconds, "distinct": check["distinct"],
            "generated": check["generated"], "levels": got.levels,
            "action_counts": check["action_counts"],
            "correct": compare.is_correct(compared),
            "compared": {k: {"value": v, "limit": lim}
                         for k, (v, lim) in compared.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--depth", type=int, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bits", type=int, default=32)
    a = ap.parse_args(argv)
    print(json.dumps(run_control(a.config, a.depth, a.seed, a.bits)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
