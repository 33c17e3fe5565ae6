"""The v1 chunk's stage plan: which implementation runs each stage.

The v1 pipeline is the classical one (``models/actions.py``
``build_expand``): every instance of every parent is built as a packed
successor, then the enabled lanes are compacted and only those K lanes
go on:

    expand       every [B, G] candidate + its pack guard  PyTorch
                 (+ the POR step, with a table)
    compact      ops/compact_cuda.py                      kernel (B3)
    fingerprint  the full hash of the K gathered rows     PyTorch
                 (and of the B parents for trace links)
    insert       ops/fpset_cuda.py                        kernel (B1)
    enqueue      ops/enqueue_cuda.py ("kernel")           kernel (B5)
                 or "scatter" / "window" as asked

The JAX package has no fused tail on v1 (its chunk refuses a fused tail
without the v2 delta pipeline), so ``enqueue_method="fused"`` resolves to
the split tail's enqueue kernel, recorded in ``fused_reasons``.  This is
a rule of resolution, as the mesh's is (``pipeline_v3.MESH_FUSED_REASON``),
not a fall back on a failure.

On the mesh (``parallel/mesh.py``) v1 takes v3's arrangement: the
shared-P compaction, the owner-routed insert and the split tail.

On CUDA tensors each kernel stage launches its kernel or raises; on CPU
tensors it runs its plain version.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import pipeline_v3
from .pipeline_v3 import ENQUEUE_METHODS

#: Why v1's default tail is the split one.
V1_FUSED_REASON = ("the JAX package has no fused tail on v1 (it needs the "
                   "v2 delta pipeline): the fused tail resolves to the "
                   "insert kernel and the enqueue kernel")


def resolve_method(enqueue_method: str) -> Tuple[str, Dict[str, str]]:
    """``(tail method, reasons)``: "fused" resolves to "kernel"."""
    if enqueue_method not in ENQUEUE_METHODS:
        raise ValueError(f"enqueue_method must be one of {ENQUEUE_METHODS}, "
                         f"got {enqueue_method!r}")
    if enqueue_method == "fused":
        return "kernel", {"enqueue": V1_FUSED_REASON}
    return enqueue_method, {}


def resolve_plan(device, enqueue_method: str = "fused") -> Dict[str, str]:
    """Stage -> implementation on ``device`` (``EngineResult.fused_stages``)."""
    method, _reasons = resolve_method(enqueue_method)
    kernel = "cuda" if torch.device(device).type == "cuda" else "plain"
    return {"expand": "torch", "compact": kernel, "fingerprint": "torch",
            **pipeline_v3.tail_plan(device, method)}


def resolve_mesh_plan(device, enqueue_method: str = "fused"
                      ) -> Tuple[Dict[str, str], Dict[str, str], str]:
    """v3's mesh arrangement with the v1 expand."""
    stages, reasons, method = pipeline_v3.resolve_mesh_plan(device,
                                                            enqueue_method)
    stages = {"expand": "torch", **{s: v for s, v in stages.items()
                                    if s != "masks"}}
    return stages, reasons, method
