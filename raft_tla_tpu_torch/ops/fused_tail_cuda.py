"""Fused insert -> enqueue: the CUDA kernel ``csrc/fused_tail.cu`` and its
plain version.

Replaces the JAX package's ``ops/fused_tail_pallas.py`` (``_tail_padded``).
Contract of ``insert_enqueue(seen, keys, valid, krows, enq_ok, qnext,
next_count, max_count=None) -> (is_new, fail, count)``, where
``next_count`` is a host int or an int32 device tensor of one element
holding at most ``max_count`` (``ops/enqueue.py count_arg``), read on the
card by the kernel:

- ``is_new`` and ``fail``, and the table update, are ``fpset_cuda.insert``'s
  (so equal to the plain version's when no query fails);
- each lane with ``is_new & enq_ok`` has its row ``krows[lane]`` written
  to ``qnext[next_count + rank]`` in place, rank counted among those lanes
  in lane order;
- ``count`` ([] int32 device tensor) is ``next_count`` plus that number.

The JAX kernel also writes every other lane's row to a per-lane trash slot
past the live region; that region is not part of the contract and is left
untouched.  ``insert_enqueue`` launches the kernel for CUDA tensors and
takes ``insert_enqueue_plain`` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import build
from .enqueue import count_arg
from .fpset import FPSet
from .fpset_cuda import check_queries, insert_plain

#: Kernel launches since the last reset (chip_smoke reads it).
launches = 0


def insert_enqueue_plain(seen: FPSet, keys, valid, krows, enq_ok, qnext,
                         next_count):
    """Plain version: the sequential insert, then the enqueued rows copied
    in lane order."""
    is_new, fail = insert_plain(seen, keys, valid)
    nc = int(next_count)
    enq = (is_new & enq_ok).nonzero().squeeze(1)
    qnext[nc:nc + enq.shape[0]] = krows[enq]
    count = torch.tensor(nc + enq.shape[0], dtype=torch.int32,
                         device=krows.device)
    return is_new, fail, count


#: The CUDA launches of one call, in order (``launch_info``).
KERNELS = ("probe_claim_kernel", "own_kernel", "resolve_kernel",
           "enqueue_tiles_kernel")


def tiles(n: int, tile: int) -> int:
    """Tiles of n lanes: the blocks of the enqueue launch (at least one,
    which writes the count when n is 0) and the ints of the per-tile
    count scratch."""
    return max(1, -(-n // tile))


@functools.cache
def geometry():
    """``(tile, widest row)`` of the built kernel: the lanes of one tile of
    its enqueue launch, and the widest row in bytes its shared-memory
    stage takes."""
    out = (ctypes.c_int * 2)()
    _lib().fused_tail_geometry(out)
    return out[0], out[1]


def launch_info(n: int):
    """``{kernel: build.kernel_info}`` of each launch of one call of n
    lanes."""
    return {name: build.kernel_info("fused_tail", i, n)
            for i, name in enumerate(KERNELS)}


def _lib():
    lib = build.library("fused_tail")
    fn = lib.fused_tail_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, i, p, ll, p, p, p, p, p, p, p, i, p, p, p, p]
        lib.fused_tail_geometry.restype = None
        lib.fused_tail_geometry.argtypes = [p]
    return lib


def check_tail(seen: FPSet, keys, valid, krows, enq_ok, qnext, next_count,
               max_count=None) -> torch.Tensor:
    """Raise on arguments the fused tail does not take (on any device);
    ``next_count`` as an int32 [1] tensor otherwise."""
    if krows.dim() != 2 or qnext.dim() != 2:
        raise ValueError("insert_enqueue: rows must be [n, sw] / [Q, sw]")
    n, sw = krows.shape
    nc = count_arg(next_count, n, qnext.shape[0], keys.device, max_count,
                   "insert_enqueue")
    check_queries(seen, keys, valid)
    if (krows.dtype != torch.uint8 or qnext.dtype != torch.uint8
            or qnext.shape[1] != sw or not krows.is_contiguous()
            or not qnext.is_contiguous() or enq_ok.dtype != torch.bool
            or enq_ok.shape != (n,) or keys.shape != (n,)):
        raise ValueError("insert_enqueue: rows must be contiguous uint8 "
                         "[n, sw] / [Q, sw], keys int64 [n], enq_ok bool [n]")
    dev = keys.device
    if krows.device != dev or enq_ok.device != dev or qnext.device != dev:
        raise ValueError("insert_enqueue: arguments on different devices")
    if qnext.shape[0] >= 1 << 31:
        raise ValueError("insert_enqueue: at most 2^31 - 1 queue rows")
    return nc


def insert_enqueue(seen: FPSet, keys: torch.Tensor, valid: torch.Tensor,
                   krows: torch.Tensor, enq_ok: torch.Tensor,
                   qnext: torch.Tensor, next_count, max_count=None):
    """``(is_new, fail, count)``; see the module contract.  On the card:
    four launches, and no other device operation."""
    global launches
    nc = check_tail(seen, keys, valid, krows, enq_ok, qnext, next_count,
                    max_count)
    if krows.device.type == "cpu":
        return insert_enqueue_plain(seen, keys, valid, krows, enq_ok, qnext,
                                    next_count)
    if krows.device.type != "cuda":
        raise ValueError(f"insert_enqueue: unsupported device {krows.device}")
    keys, valid = keys.contiguous(), valid.contiguous()
    enq_ok = enq_ok.contiguous()
    n, sw = krows.shape
    tile, widest = geometry()
    if sw > widest:
        raise ValueError(f"insert_enqueue: rows of {sw} bytes, the kernel "
                         f"takes at most {widest}")
    dev = krows.device
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    is_new = torch.empty(n, dtype=torch.bool, device=dev)
    fail = torch.empty((), dtype=torch.bool, device=dev)
    tile_count = torch.empty(tiles(n, tile), dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    err = _lib().fused_tail_launch(
        keys.data_ptr(), valid.data_ptr(), enq_ok.data_ptr(), n,
        seen.keys.data_ptr(), seen.capacity, seen.owner.data_ptr(),
        slot.data_ptr(), is_new.data_ptr(), seen.size.data_ptr(),
        fail.data_ptr(), tile_count.data_ptr(), krows.data_ptr(), sw,
        qnext.data_ptr(), nc.data_ptr(), count.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "fused_tail_launch")
    launches += 1
    return is_new, fail, count[0]
