"""The split tail's enqueue: its contract, its plain version and the two
PyTorch lowerings.

After a separate seen-set insert the chunk body appends the novel,
constraint-passing rows to the next-level queue.  Contract of every
function here, ``f(qnext, next_count, krows, enq) -> count``:

- ``krows`` [K, sw] uint8, ``enq`` [K] bool, ``qnext`` [rows, sw] uint8
  (written in place), ``next_count`` a host int or an int32 tensor of one
  element on the rows' device (the level loop keeps it there), with
  ``next_count + K <= rows``;
- row ``j`` of the ``enq`` lanes, in ascending lane order, lands at
  ``qnext[next_count + j]`` byte for byte; rows ``[0, next_count)`` are
  untouched;
- ``count`` ([] int32 tensor on the rows' device) is ``next_count +
  enq.sum()``, so the caller never waits for the device to learn it;
  given a device ``next_count``, no function but the plain version reads
  it on the host;
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


def count_arg(next_count, n: int, qrows: int, device, max_count=None,
              what: str = "enqueue") -> torch.Tensor:
    """``next_count`` as an int32 [1] tensor on ``device``, after the
    bound check: every count the call can start from leaves room for its
    n rows in the ``qrows``-row queue.  A host int is that count; a
    device tensor may hold any value up to ``max_count`` (the level loop
    holds its count at most Q - K, and its queues have Q + PAD rows)."""
    if isinstance(next_count, torch.Tensor):
        if max_count is None:
            raise ValueError(f"{what}: a device next_count needs max_count, "
                             "the largest value it can hold")
        if (next_count.dtype != torch.int32 or next_count.numel() != 1
                or next_count.device != torch.device(device)):
            raise ValueError(f"{what}: next_count must be one int32 on the "
                             "rows' device")
        lo, hi = 0, max_count
    else:
        lo = hi = next_count
    if lo < 0 or hi + n > qrows:
        raise ValueError(f"{what}: {n} rows at {hi} overrun the {qrows}-row "
                         "queue")
    if isinstance(next_count, torch.Tensor):
        return next_count.view(1)
    return torch.tensor([next_count], dtype=torch.int32, device=device)


def _count(next_count, enq: torch.Tensor) -> torch.Tensor:
    return (enq.sum() + next_count).to(torch.int32).view(())


def enqueue_plain(qnext, next_count, krows, enq) -> torch.Tensor:
    """Plain version: gather the enq rows, assign them as one slice.
    (``nonzero`` and a device ``next_count`` wait for the device on a
    CUDA tensor.)"""
    nc = int(next_count)
    idx = enq.nonzero().squeeze(1)
    qnext[nc:nc + idx.shape[0]] = krows[idx]
    return _count(nc, enq)


def _offset(next_count, device) -> torch.Tensor:
    """``next_count`` as a 0-dim int64 tensor on ``device``."""
    if isinstance(next_count, torch.Tensor):
        return next_count.view(()).to(torch.int64)
    return torch.tensor(next_count, dtype=torch.int64, device=device)


def enqueue_scatter(qnext, next_count, krows, enq, Q: int):
    """The "scatter" lowering: every lane writes its row, an enq lane at
    its running position, any other lane at its own trash row ``Q +
    lane`` (``qnext`` carries at least K rows past ``Q``)."""
    K = krows.shape[0]
    if Q + K > qnext.shape[0]:
        raise ValueError(f"enqueue_scatter: trash rows [{Q}, {Q + K}) "
                         f"overrun the {qnext.shape[0]}-row queue")
    off = _offset(next_count, enq.device)
    epos = off + enq.to(torch.int64).cumsum(0) - 1
    epos = torch.where(enq, epos, Q + torch.arange(K, device=enq.device))
    qnext.index_copy_(0, epos, krows)
    return _count(off, enq)


def enqueue_window(qnext, next_count, krows, enq):
    """The "window" lowering: the K-row window at ``next_count`` is
    gathered, rebuilt through the inverted placement and written back;
    rows of the window past the new count keep their bytes."""
    K = krows.shape[0]
    src = inv_positions(enq, K)
    live = torch.arange(K, device=enq.device) < enq.sum()
    off = _offset(next_count, enq.device)
    at = off + torch.arange(K, device=enq.device)
    win = qnext.index_select(0, at)
    qnext.index_copy_(0, at, torch.where(live[:, None],
                                         krows.index_select(0, src), win))
    return _count(off, enq)
