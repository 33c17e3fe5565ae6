"""The v4 chunk's stage plan: which implementation runs each stage.

The v4 pipeline is the v2 delta pipeline with both halves of the chunk
body as kernels:

    masks        \\
    compact       }  ops/chunk_front_cuda.py   one front call
    fingerprint  /   (masks, POR, compaction, lanes: three launches)
    insert       \\   ops/fused_tail_cuda.py    fused kernel
    enqueue      /

With a split tail (``EngineConfig.enqueue_method`` other than "fused")
the insert and the enqueue are separate stages, as ``ops/pipeline_v3.py``
says.

On CUDA tensors each kernel launches or raises; on CPU tensors it runs its
plain version.  The JAX package's plan (``raft_tla_tpu/ops/pipeline_v4.py``)
also carries forced stages and a build-and-probe fall back per stage; the
port has no fall back, so it has none of that.
"""

from __future__ import annotations

from typing import Dict

import torch

from .pipeline_v3 import tail_plan


def resolve_plan(device, enqueue_method: str = "fused") -> Dict[str, str]:
    """Stage -> implementation on ``device`` (``EngineResult.fused_stages``)."""
    kernel = "cuda" if torch.device(device).type == "cuda" else "plain"
    return {**{s: f"fused-{kernel}"
               for s in ("masks", "compact", "fingerprint")},
            **tail_plan(device, enqueue_method)}
