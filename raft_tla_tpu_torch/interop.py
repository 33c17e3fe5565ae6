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
  draw, ``{lane: (c_ord, c_msg, seed)}``.
"""

from __future__ import annotations

import numpy as np
import torch

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
