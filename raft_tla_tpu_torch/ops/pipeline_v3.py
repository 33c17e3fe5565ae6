"""The v3 chunk's stage plan: which implementation runs each stage.

The v3 pipeline is the v2 delta pipeline (``models/actions2.py``) with
its compaction and its tail as kernels:

    masks        guards-only enabled/overflow masks     PyTorch
                 (+ the POR step, with a table)
    compact      ops/compact_cuda.py                    kernel
    fingerprint  delta fingerprints + sparse rows       PyTorch
    insert       ops/fused_tail_cuda.py                 fused kernel
    enqueue        (insert and enqueue in one launch)

With a split tail (``EngineConfig.enqueue_method`` other than "fused")
the last two stages are separate: ``ops/fpset_cuda.py`` inserts, then
``ops/enqueue_cuda.py`` ("kernel") or one of the PyTorch lowerings of
``ops/enqueue.py`` ("scatter", "window") enqueues.  The JAX package
reaches the same split through ``insert_method``, ``enqueue_method`` and
``v3_force_stages={"insert": "xla"}``.

On the mesh (``parallel/mesh.py``, ``resolve_mesh_plan``) the compaction
is the shared-P one (the kernel on each shard, cut to the least P over
the shards), the insert is routed to each key's owner shard, and the
fused tail resolves to the split tail's enqueue kernel: the insert runs
on the owner and the enqueue on the shard that generated the row, so
they cannot be one launch.  "scatter" and "window" stay as asked.  This
is a rule of resolution, as in the JAX plans (``mesh=True``), not a fall
back on a failure.

On CUDA tensors each kernel stage launches its kernel or raises; on CPU
tensors it runs its plain version.  There is no fall back from a kernel
to anything else: a kernel that does not build or launch stops the run.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

ENQUEUE_METHODS = ("fused", "kernel", "scatter", "window")


def tail_plan(device, enqueue_method: str) -> Dict[str, str]:
    """The tail's two stages (shared with the v4 plan)."""
    if enqueue_method not in ENQUEUE_METHODS:
        raise ValueError(f"enqueue_method must be one of {ENQUEUE_METHODS}, "
                         f"got {enqueue_method!r}")
    kernel = "cuda" if torch.device(device).type == "cuda" else "plain"
    if enqueue_method == "fused":
        return {"insert": f"fused-{kernel}", "enqueue": f"fused-{kernel}"}
    return {"insert": kernel,
            "enqueue": kernel if enqueue_method == "kernel"
            else enqueue_method}


def resolve_plan(device, enqueue_method: str = "fused") -> Dict[str, str]:
    """Stage -> implementation on ``device`` (``EngineResult.fused_stages``)."""
    kernel = "cuda" if torch.device(device).type == "cuda" else "plain"
    return {"masks": "torch", "compact": kernel, "fingerprint": "torch",
            **tail_plan(device, enqueue_method)}


#: Why each mesh stage is what it is (``EngineResult.fused_reasons``).
MESH_REASONS = {
    "compact": "P is the minimum over the shards (the JAX mesh's pmin): "
               "the kernel runs on each shard and its lanes are cut to "
               "the first P parents",
    "insert": "owner-routed all_to_all dedup is a collective; cannot "
              "fuse on the mesh",
}

#: Why the mesh's default tail is the split one.
MESH_FUSED_REASON = ("the insert runs on the owner shard and the enqueue "
                     "on the generating shard, so they cannot be one "
                     "launch: the fused tail resolves to the enqueue "
                     "kernel")


def resolve_mesh_plan(device, enqueue_method: str = "fused"
                      ) -> Tuple[Dict[str, str], Dict[str, str], str]:
    """``(stages, reasons, enqueue_method)`` of the mesh's chunk on
    ``device``: the v3 arrangement with the shared-P compaction, the
    routed insert and a split tail ("fused" resolves to "kernel")."""
    if enqueue_method not in ENQUEUE_METHODS:
        raise ValueError(f"enqueue_method must be one of {ENQUEUE_METHODS}, "
                         f"got {enqueue_method!r}")
    reasons = dict(MESH_REASONS)
    if enqueue_method == "fused":
        enqueue_method = "kernel"
        reasons["enqueue"] = MESH_FUSED_REASON
    kernel = "cuda" if torch.device(device).type == "cuda" else "plain"
    stages = {"masks": "torch", "compact": f"{kernel}-shared-p",
              "fingerprint": "torch", "insert": f"{kernel}-routed",
              "enqueue": kernel if enqueue_method == "kernel"
              else enqueue_method}
    return stages, reasons, enqueue_method
