"""State carried between the JAX package and the port.

The checker has no weights; what a run carries is the fingerprint
constants, the packed queue rows and the seen-set keys.  Each function
takes the JAX package's host form (numpy arrays), so a JAX run's level
snapshot can be continued by the port:

- ``seen_from_numpy(hi, lo, capacity, device)``: uint32 key lanes as
  ``raft_tla_tpu.ops.fpset.to_host_keys`` returns them -> an ``FPSet``;
- ``queue_from_numpy(rows, device)``: uint8 [n, state_width] rows (the
  row format is shared byte for byte) -> a tensor;
- ``fingerprint_constants(dims)``: the fixed-seed constants both packages
  draw, ``{lane: (c_ord, c_msg, seed)}``;
- ``checkpoint_from_numpy(dims, ...)``: the same host arrays and counters
  as an ``engine/checkpoint.py`` ``Checkpoint``, which
  ``BFSEngine.run(resume=...)`` continues and ``checkpoint.save`` writes.

Whole runs cross as files: ``engine/checkpoint.py`` keeps the JAX
package's ``.npz`` format (version 4) key for key, so a snapshot written
by either package's engine is loaded and resumed by the other's
(``check --resume PATH`` on both sides).
"""

from __future__ import annotations

import numpy as np
import torch

from .engine.checkpoint import Checkpoint
from .models.dims import RaftDims
from .ops import fpset
from .ops.fingerprint import constants_np


def seen_from_numpy(hi: np.ndarray, lo: np.ndarray, capacity: int,
                    device) -> fpset.FPSet:
    return fpset.from_host_keys(hi, lo, capacity, device)


def queue_from_numpy(rows: np.ndarray, device) -> torch.Tensor:
    rows = np.ascontiguousarray(rows)
    if rows.dtype != np.uint8 or rows.ndim != 2:
        raise ValueError("queue rows must be uint8 [n, state_width]")
    return torch.as_tensor(rows).to(device)


def fingerprint_constants(dims: RaftDims):
    return constants_np(dims)


def checkpoint_from_numpy(dims: RaftDims, frontier: np.ndarray,
                          seen_hi: np.ndarray, seen_lo: np.ndarray, *,
                          distinct: int, generated: int, diameter: int,
                          levels, action_counts=None,
                          wall_seconds: float = 0.0) -> Checkpoint:
    """A trace-less ``Checkpoint`` from a level boundary's host arrays:
    frontier rows uint8 [n, state_width], seen keys as ``to_host_keys``
    returns them.  Resume it with ``record_trace=False``."""
    frontier = np.ascontiguousarray(frontier)
    if frontier.dtype != np.uint8 or frontier.ndim != 2:
        raise ValueError("frontier rows must be uint8 [n, state_width]")
    hi, lo = np.asarray(seen_hi, np.uint32), np.asarray(seen_lo, np.uint32)
    order = np.lexsort((lo, hi))
    return Checkpoint(
        dims=dims, frontier=frontier, seen_hi=hi[order], seen_lo=lo[order],
        distinct=int(distinct), generated=int(generated),
        diameter=int(diameter), levels=tuple(int(x) for x in levels),
        action_counts=dict(action_counts or {}),
        wall_seconds=float(wall_seconds),
        trace_fps=np.empty(0, np.uint64), trace_parents=np.empty(0, np.uint64),
        trace_actions=np.empty(0, np.int32), roots={})
