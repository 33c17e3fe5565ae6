"""The v3 chunk's stage plan: which implementation runs each stage.

The v3 pipeline is the v2 delta pipeline (``models/actions2.py``) with
its compaction and its insert + enqueue tail as kernels:

    masks        guards-only enabled/overflow masks     PyTorch
    compact      ops/compact_cuda.py                    kernel
    fingerprint  delta fingerprints + sparse rows       PyTorch
    insert       ops/fused_tail_cuda.py                 fused kernel
    enqueue        (insert and enqueue in one launch)

On CUDA tensors each kernel stage launches its kernel or raises; on CPU
tensors it runs its plain version.  There is no fall back from a kernel
to anything else: a kernel that does not build or launch stops the run.
"""

from __future__ import annotations

from typing import Dict

import torch


def resolve_plan(device) -> Dict[str, str]:
    """Stage -> implementation on ``device`` (``EngineResult.fused_stages``)."""
    kernel = "cuda" if torch.device(device).type == "cuda" else "plain"
    return {"masks": "torch", "compact": kernel, "fingerprint": "torch",
            "insert": f"fused-{kernel}", "enqueue": f"fused-{kernel}"}
