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

On CUDA tensors each kernel stage launches its kernel or raises; on CPU
tensors it runs its plain version.  There is no fall back from a kernel
to anything else: a kernel that does not build or launch stops the run.
"""

from __future__ import annotations

from typing import Dict

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
