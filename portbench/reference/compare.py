"""What decides ``correct``: each check's answer against the reference's.

A check of an exhaustive cell answers as TLC does: no invariant violated
and no deadlock, stopped by the diameter budget at the cell's depth, per
level the frontier, with the cumulative distinct and generated counts,
and the generated count of each action family (TLC's coverage,
``EngineResult.action_counts``).  The reference's answer to the same question is the oracle's
(``oracle.py``): its search to ``live_depth`` runs in every run, once the
window has closed, and the deeper levels come from its frozen profile
(``profiles/<config>.json``), which the live levels must match.  Every
number compared is exact, so every limit is 0.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

from . import oracle

HERE = os.path.dirname(os.path.abspath(__file__))

#: The verdict of a check that is right: ``stop_reason`` of a search that
#: reached its diameter budget with no violation and no deadlock.
STOP_AT_DEPTH = "diameter_budget"


def load_profile(config_name: str) -> dict:
    with open(os.path.join(HERE, "profiles", f"{config_name}.json")) as f:
        return json.load(f)


def reference_answer(config_name: str, dims: oracle.Dims, depth: int,
                     live_depth: int) -> Tuple[dict, int]:
    """The reference's answer to a check to ``depth``, and the widest gap
    between its live search to ``live_depth`` and its frozen profile
    (0 where they agree)."""
    prof = load_profile(config_name)
    if depth >= len(prof["actions"]):
        raise ValueError(f"{config_name}: the reference profile stops at "
                         f"level {len(prof['actions']) - 1}, not {depth}")
    live = oracle.bfs(dims, min(live_depth, depth))
    gap = 0
    for key in ("levels", "distinct", "generated"):
        for a, b in zip(getattr(live, key), prof[key]):
            gap = max(gap, abs(a - b))
    for a, b in zip(live.actions, prof["actions"]):
        gap = max([gap] + [abs(x - y) for x, y in zip(a, b)])
    if live.violation is not None or live.deadlock:
        gap = max(gap, 1)
    answer = {"levels": prof["levels"][:depth + 1],
              "distinct": prof["distinct"][depth],
              "generated": prof["generated"][depth],
              "actions": dict(zip(oracle.FAMILY_NAMES,
                                  prof["actions"][depth])),
              "diameter": depth, "stop_reason": STOP_AT_DEPTH,
              "violation": None, "deadlock": False}
    return answer, gap


def level_gap(a: List[int], b: List[int]) -> int:
    """The widest gap between two level profiles, a missing level read
    as 0."""
    n = max(len(a), len(b))
    a = list(a) + [0] * (n - len(a))
    b = list(b) + [0] * (n - len(b))
    return max((abs(x - y) for x, y in zip(a, b)), default=0)


def action_gap(a: Dict[str, int], b: Dict[str, int]) -> int:
    """The widest gap between two families' counts, a missing family
    read as 0."""
    return max((abs(a.get(f, 0) - b.get(f, 0)) for f in set(a) | set(b)),
               default=0)


def judge(checks: List[dict], ref: dict,
          prefix_gap: int = 0) -> Dict[str, Tuple[float, float]]:
    """``{name: (number, limit)}``: checks whose answer is not the
    reference's, the widest gaps of distinct, generated, any level's
    frontier and any family's generated count over the checks, and the
    reference's own prefix gap."""
    wrong = dgap = ggap = lgap = agap = 0
    for c in checks:
        d = abs(c["distinct"] - ref["distinct"])
        g = abs(c["generated"] - ref["generated"])
        lv = level_gap(c["levels"], ref["levels"])
        ac = action_gap(c["action_counts"], ref["actions"])
        verdict = (c["violation"] == ref["violation"]
                   and bool(c["deadlock"]) == ref["deadlock"]
                   and c["stop_reason"] == ref["stop_reason"]
                   and c["diameter"] == ref["diameter"])
        wrong += int(bool(d or g or lv or ac or not verdict))
        dgap, ggap, lgap = max(dgap, d), max(ggap, g), max(lgap, lv)
        agap = max(agap, ac)
    if not checks:
        wrong = 1
    return {"checks_wrong": (wrong, 0), "distinct_gap": (dgap, 0),
            "generated_gap": (ggap, 0), "level_gap": (lgap, 0),
            "action_gap": (agap, 0),
            "reference_prefix_gap": (prefix_gap, 0)}


def is_correct(compared: Dict[str, Tuple[float, float]]) -> bool:
    return all(v <= limit for v, limit in compared.values())
