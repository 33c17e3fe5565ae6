"""Roofline: per-stage byte floors, priced against the card's bandwidth,
with the fusion advisor.

The JAX package's ``obs/roofline.py`` takes its floors from a
provenance walk of the stage programs' jaxprs; the port's analyzer
(``analysis/``) walks aten graphs of the action kernels but has no such
traffic walk yet (ROADMAP A8b), so its floors come from the stage
tensors' shapes, under the JAX rule: every stage input is read once, every output written once, and
intermediates are free.  The byte counts are the ones ``chip_smoke.py``
prices each kernel's bound with (it imports them from here: one count).
A stage's floor assumes a full batch: every one of the K compacted lanes
live, distinct, new and enqueued.

``achieved fraction = (floor bytes / measured stage seconds) / peak``;
``headroom = measured - floor time`` is what fusion can win back;
``advise`` ranks the stages by ``launches x per-launch overhead +
headroom``.  ``peak_bandwidth`` reads the card's name (``RAFT_PEAK_GBPS``
overrides); the ``source`` field says which figure was used.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional

#: Peak memory bandwidth by card-name substring (bytes/s), matched
#: case-insensitively against ``torch.cuda.get_device_name``; the first
#: match wins.  NVIDIA data sheets.
PEAK_BW_TABLE = (
    ("h100 pcie", 2.0e12),
    ("h100", 3.35e12),          # H100 SXM, HBM3
)

#: Off the card: dual-channel DDR4-3200 class, marked "assumed".
CPU_ASSUMED_BW = 51.2e9


def peak_bandwidth(device=None) -> Dict[str, object]:
    """``{"bytes_per_sec", "source"}`` for the card (the first visible
    one unless ``device`` names another, or the CPU).  An unknown card
    gets the assumed figure with a source that says so."""
    env = os.environ.get("RAFT_PEAK_GBPS")
    if env:
        try:
            return {"bytes_per_sec": float(env) * 1e9,
                    "source": "RAFT_PEAK_GBPS override"}
        except ValueError:
            print(f"perf: ignoring malformed RAFT_PEAK_GBPS={env!r} "
                  f"(want GB/s as a number)", file=sys.stderr)
    kind = ""
    try:
        import torch
        dev = torch.device(device) if device is not None else None
        if (dev is None or dev.type == "cuda") \
                and torch.cuda.is_available():
            kind = torch.cuda.get_device_name(dev).lower()
    except Exception:
        kind = ""
    if kind:
        for sub, bw in PEAK_BW_TABLE:
            if sub in kind:
                return {"bytes_per_sec": bw,
                        "source": f"datasheet ({kind})"}
        return {"bytes_per_sec": CPU_ASSUMED_BW,
                "source": f"assumed (unknown accelerator {kind!r})"}
    return {"bytes_per_sec": CPU_ASSUMED_BW,
            "source": "assumed (cpu ddr-class)"}


# ---------------------------------------------------------------------------
# The byte counts of the kernels and stages


def compact_bytes(b: int, g: int, k: int, total: int) -> int:
    """B3: the [b, g] mask once, kspread only in the dead slots, lane_id,
    kvalid and (P, total) written once."""
    return b * g + (k - total) * 4 + k * 4 + k + 8


def insert_bytes(n: int, n_distinct: int, n_new: int) -> int:
    """B1: queries + valid + is_new + fail, one 32-byte sector read a
    distinct valid key (a duplicate finds its key where the first lane
    did) and one written a claimed slot."""
    return n * (8 + 1 + 1) + 1 + 32 * n_distinct + 32 * n_new


def fused_tail_bytes(n: int, n_distinct: int, n_new: int, n_enq: int,
                     sw: int) -> int:
    """B2: the insert's bytes, enq_ok and the count, and each enqueued
    row read once and written once."""
    return insert_bytes(n, n_distinct, n_new) + n + 4 + 2 * n_enq * sw


def enqueue_bytes(k: int, n_enq: int, sw: int) -> int:
    """B5: the mask once, each enqueued row read once and written once,
    the count."""
    return k + 2 * n_enq * sw + 4


def salt_bytes(dims) -> int:
    """The delta fingerprint's salt tables."""
    return 4 * (2 + 2 * (7 * dims.n_servers + 2 * dims.n_servers
                         * dims.max_log + 2 * dims.n_servers ** 2)
                + 2 * dims.msg_width)


def lane_bytes(dims, total: int) -> int:
    """Written on each live lane: its row and six scalars."""
    from ..models.schema import state_width
    return total * (state_width(dims) + 8 * 5 + 1)


def front_bytes(dims, b: int, k: int, total: int) -> int:
    """B4, one front call.  Read: the parent rows, valid, kspread in the
    dead slots and the salt tables; written: the three [b, G] masks,
    (P, total), lane_id, kvalid and on each live lane its row and six
    scalars (dead lanes are left unwritten by contract)."""
    from ..models.schema import state_width
    sw, g = state_width(dims), dims.n_instances
    return (b * sw + b + (k - total) * 4 + salt_bytes(dims) + 3 * b * g + 8
            + k * 4 + k + lane_bytes(dims, total))


def _row(read: int, written: int, launches: int) -> dict:
    return {"bytes_read": int(read), "bytes_written": int(written),
            "bytes_total": int(read + written), "launches": int(launches),
            "notes": ["floor from the stage tensors' shapes, every lane "
                      "live"]}


def stage_traffic(dims, B: int, K: int, *, pipeline: str = "v4",
                  ring: int = 16, enqueue_method: str = "fused",
                  swarm_pipeline: str = "v2") -> Dict[str, dict]:
    """``{stage: {bytes_read, bytes_written, bytes_total, launches,
    notes}}`` for the chunk profiler's stages (``obs/profile.py``), keyed
    as its stage means.  ``launches`` counts the stage's launches of the
    port's kernels (a PyTorch stage: 0); ``enqueue_method`` names the
    tail (fused: B2's four launches; split: B1's three and B5's two; v1
    has no fused tail and takes the split one); ``swarm_pipeline`` "v1"
    has the swarm's expand write every instance's row."""
    from ..models.schema import state_width
    sw, G = state_width(dims), dims.n_instances
    if pipeline == "v1":
        if enqueue_method == "fused":
            enqueue_method = "kernel"
        # Every [B, G] candidate row and its three masks, then B3.
        written = B * G * sw + 3 * B * G
        enq_l = 2 if enqueue_method == "kernel" else 0
        return {
            "expand": _row(B * sw + B + B * G,
                           written + compact_bytes(B, G, K, K) - B * G, 2),
            "fingerprint": _row(K * sw + 4 * K + B * sw,
                                lane_bytes(dims, K) - K * sw, 0),
            "dedup_insert": _row(insert_bytes(K, K, K) - 2 * K - 1,
                                 2 * K + 1, 3),
            "enqueue": _row(enqueue_bytes(K, K, sw) - K * sw - 4,
                            K * sw + 4, enq_l),
        }
    if pipeline == "swarm":
        # B lanes: rows in; states and the two [B, G] masks out; the
        # choice; the chosen successor's row and fingerprint; the ring.
        expand_w = B * sw + 2 * B * G
        if swarm_pipeline == "v1":
            expand_w += B * G * sw + B * G
        return {
            "expand": _row(B * sw + B, expand_w, 0),
            "choose": _row(B * G, 8 * B, 0),
            "latch": _row(B * sw + 8 * B, B * sw + 8 * B, 0),
            "ring_probe": _row(8 * B * ring + 4 * B + 8 * B + 2 * B * G,
                               8 * B * ring + 4 * B, 0),
        }
    # The tail's outputs: the enqueued rows, the claimed slots, is_new,
    # fail and the count; the rest of its floor is read.
    tail_w = K * sw + 32 * K + K + 1 + 4
    if enqueue_method == "fused":
        tail_t, tail_l = fused_tail_bytes(K, K, K, K, sw), 4
    else:
        tail_t = insert_bytes(K, K, K) + enqueue_bytes(K, K, sw)
        tail_l = 5 if enqueue_method == "kernel" else 3
    tail = _row(tail_t - tail_w, tail_w, tail_l)
    if pipeline == "v4":
        written = 3 * B * G + 8 + K * 4 + K + lane_bytes(dims, K)
        return {"front": _row(front_bytes(dims, B, K, K) - written,
                              written, 3),
                "insert_enqueue": tail}
    if pipeline == "v3":
        return {
            "masks": _row(B * sw + B, B * sw + 2 * B * G, 0),
            "compact": _row(B * G, compact_bytes(B, G, K, K) - B * G, 2),
            "fingerprint": _row(B * sw + 4 * K + salt_bytes(dims),
                                lane_bytes(dims, K), 0),
            "insert_enqueue": tail,
        }
    raise ValueError(f"no stage traffic for pipeline {pipeline!r}")


# ---------------------------------------------------------------------------
# Roofline rows and the fusion advisor (the JAX module's)


def build_roofline(traffic: Dict[str, dict],
                   stage_means: Optional[Dict[str, float]],
                   peak: Dict[str, object]) -> Dict[str, dict]:
    """Join the floors with the chunk profiler's measured stage means.
    Rows without a measurement keep their floors and launches with null
    achieved fields."""
    bw = float(peak["bytes_per_sec"])
    means = stage_means or {}
    rows: Dict[str, dict] = {}
    for stage, t in traffic.items():
        floor_s = t["bytes_total"] / bw if bw else None
        mean_s = means.get(stage)
        row = {
            "bytes_read": t["bytes_read"],
            "bytes_written": t["bytes_written"],
            "bytes_total": t["bytes_total"],
            "launches": t["launches"],
            "floor_seconds": round(floor_s, 9) if floor_s else floor_s,
            "mean_seconds": (round(mean_s, 6) if mean_s is not None
                             else None),
            "achieved_gbps": None,
            "bandwidth_fraction": None,
            "headroom_seconds": None,
            "notes": t.get("notes", []),
        }
        if mean_s:
            achieved = t["bytes_total"] / mean_s
            row["achieved_gbps"] = round(achieved / 1e9, 3)
            row["bandwidth_fraction"] = round(achieved / bw, 6) if bw \
                else None
            row["headroom_seconds"] = round(
                max(0.0, mean_s - (floor_s or 0.0)), 6)
        rows[stage] = row
    return rows


def advise(rows: Dict[str, dict], overhead_seconds: float) -> dict:
    """Rank the stages by the time fusion could win back (``launches x
    per-launch overhead + headroom``) and name the top one; a stage with
    no measured mean scores on its launches alone (``basis`` says
    which)."""
    ranking = []
    for stage, row in rows.items():
        tax = row["launches"] * overhead_seconds
        headroom = row["headroom_seconds"]
        score = tax + (headroom or 0.0)
        ranking.append({
            "stage": stage,
            "score_seconds": round(score, 6),
            "launch_tax_seconds": round(tax, 6),
            "headroom_seconds": headroom,
            "launches": row["launches"],
            "bandwidth_fraction": row["bandwidth_fraction"],
            "basis": ("measured+model" if headroom is not None
                      else "launch-model-only"),
        })
    ranking.sort(key=lambda r: (-r["score_seconds"], r["stage"]))
    if not ranking:
        return {"ranking": [], "top": None, "verdict": "no stages"}
    top = ranking[0]
    frac = top["bandwidth_fraction"]
    verdict = (
        f"fuse '{top['stage']}' next: {top['launches']} kernel launches/"
        f"batch (~{top['launch_tax_seconds'] * 1e3:.3f} ms launch tax)"
        + (f", {top['headroom_seconds'] * 1e3:.3f} ms above the "
           f"bandwidth floor ({frac:.1%} of peak achieved)"
           if top["headroom_seconds"] is not None and frac is not None
           else ", unmeasured headroom"))
    return {"ranking": ranking, "top": top["stage"], "verdict": verdict}
