"""The split tail's enqueue: its contract, its plain version and the two
PyTorch lowerings.

After a separate seen-set insert the chunk body appends the novel,
constraint-passing rows to the next-level queue.  Contract of every
function here, ``f(qnext, next_count, krows, enq) -> count``:

- ``krows`` [K, sw] uint8, ``enq`` [K] bool, ``qnext`` [rows, sw] uint8
  (written in place), ``next_count`` a host int with
  ``next_count + K <= rows``;
- row ``j`` of the ``enq`` lanes, in ascending lane order, lands at
  ``qnext[next_count + j]`` byte for byte; rows ``[0, next_count)`` are
  untouched;
- ``count`` ([] int32 tensor on the rows' device) is ``next_count +
  enq.sum()``, so the caller never waits for the device to learn it;
- rows at and past ``count`` are unspecified (each lowering leaves other
  bytes there) but no write falls outside ``qnext``.

``enqueue_plain`` is the plain version of the CUDA kernel
(``ops/enqueue_cuda.py``, which replaces the JAX package's
``ops/enqueue_pallas.py``).  ``enqueue_scatter`` and ``enqueue_window`` are
the JAX package's two XLA lowerings (``engine/chunk.py``, methods
"scatter" and "window"), which it computes outside any kernel: they are
PyTorch operations here too, on either device, with no host wait.
"""

from __future__ import annotations

import torch

from .compact import inv_positions


def _count(next_count: int, enq: torch.Tensor) -> torch.Tensor:
    return (enq.sum() + next_count).to(torch.int32)


def enqueue_plain(qnext, next_count: int, krows, enq) -> torch.Tensor:
    """Plain version: gather the enq rows, assign them as one slice.
    (``nonzero`` waits for the device on a CUDA tensor.)"""
    idx = enq.nonzero().squeeze(1)
    qnext[next_count:next_count + idx.shape[0]] = krows[idx]
    return _count(next_count, enq)


def enqueue_scatter(qnext, next_count: int, krows, enq, Q: int):
    """The "scatter" lowering: every lane writes its row, an enq lane at
    its running position, any other lane at its own trash row ``Q +
    lane`` (``qnext`` carries at least K rows past ``Q``)."""
    K = krows.shape[0]
    if Q + K > qnext.shape[0]:
        raise ValueError(f"enqueue_scatter: trash rows [{Q}, {Q + K}) "
                         f"overrun the {qnext.shape[0]}-row queue")
    epos = next_count + enq.to(torch.int64).cumsum(0) - 1
    epos = torch.where(enq, epos, Q + torch.arange(K, device=enq.device))
    qnext.index_copy_(0, epos, krows)
    return _count(next_count, enq)


def enqueue_window(qnext, next_count: int, krows, enq):
    """The "window" lowering: the K-row window at ``next_count`` is
    rebuilt by a gather through the inverted placement and written back
    as one slice; rows of the window past the new count keep their
    bytes."""
    K = krows.shape[0]
    src = inv_positions(enq, K)
    live = torch.arange(K, device=enq.device) < enq.sum()
    win = qnext[next_count:next_count + K]
    win.copy_(torch.where(live[:, None], krows.index_select(0, src), win))
    return _count(next_count, enq)
