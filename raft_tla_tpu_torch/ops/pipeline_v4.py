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

On the mesh the front cannot run: its compaction happens inside the
launch, and a P shared across shards cannot be computed there.  So v4
on the mesh resolves to v3's arrangement (``resolve_mesh_plan``), with
the JAX package's reason recorded, as its plan does (``mesh=True``).

On CUDA tensors each kernel launches or raises; on CPU tensors it runs its
plain version.  The JAX package's plan (``raft_tla_tpu/ops/pipeline_v4.py``)
also carries forced stages and a build-and-probe fall back per stage; the
port has no fall back, so it has none of that.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import pipeline_v3
from .pipeline_v3 import tail_plan

#: The JAX plan's reason for running v3's arrangement on the mesh.
MESH_FRONT_REASON = ("the mesh chunk's compact P is pmin-replicated and "
                     "its dedup is an all_to_all; collectives cannot live "
                     "inside the front kernel")


def resolve_plan(device, enqueue_method: str = "fused") -> Dict[str, str]:
    """Stage -> implementation on ``device`` (``EngineResult.fused_stages``)."""
    kernel = "cuda" if torch.device(device).type == "cuda" else "plain"
    return {**{s: f"fused-{kernel}"
               for s in ("masks", "compact", "fingerprint")},
            **tail_plan(device, enqueue_method)}


def resolve_mesh_plan(device, enqueue_method: str = "fused"
                      ) -> Tuple[Dict[str, str], Dict[str, str], str]:
    """v3's mesh plan, with the reason the front does not run."""
    stages, reasons, method = pipeline_v3.resolve_mesh_plan(device,
                                                            enqueue_method)
    return stages, {"front": MESH_FRONT_REASON, **reasons}, method
