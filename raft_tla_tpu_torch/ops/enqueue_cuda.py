"""Split-tail enqueue: the CUDA kernel ``csrc/enqueue.cu`` and its wrapper.

Replaces the JAX package's ``ops/enqueue_pallas.py`` (``_enqueue_jit``,
entry ``enqueue``).  ``enqueue(qnext, next_count, krows, enq) -> count``
follows the contract of ``ops/enqueue.py``: the rows of the ``enq`` lanes
land in lane order at ``qnext[next_count:]`` in place, ``count`` is a []
int32 device tensor, rows at and past it are unspecified.  ``next_count``
is a host int or, as the level loop passes it, an int32 device tensor of
one element with ``max_count`` the largest value it can hold (the bound
check of ``ops/enqueue.py count_arg``); the kernel reads it on the card,
so the call makes no host wait.  ``enqueue`` launches the kernel for
CUDA tensors and takes ``enqueue_plain`` only for CPU tensors.

On the card a call is two launches and no other device operation: a count
of the flags of each 64-lane tile, then the tile launch the fused tail
also runs (``csrc/enqueue.cuh``), a programmatic dependent of the first.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import build
from .enqueue import count_arg, enqueue_plain
from .fused_tail_cuda import tiles

#: Kernel launches since the last reset (chip_smoke reads it).
launches = 0

#: The CUDA launches of one call, in order (``launch_info``).
KERNELS = ("enqueue_count_kernel", "enqueue_tiles_kernel")


def count_scratch(n: int, tile: int, device) -> torch.Tensor:
    """The per-tile count scratch of a call of n lanes: one int32 a tile
    (``tiles``), written by the count launch before the tile launch reads
    it, so never filled."""
    return torch.empty(tiles(n, tile), dtype=torch.int32, device=device)


@functools.cache
def geometry():
    """``(tile, widest row)`` of the built kernel: the lanes of one tile,
    and the widest row in bytes its shared-memory stage takes."""
    out = (ctypes.c_int * 2)()
    _lib().enqueue_geometry(out)
    return out[0], out[1]


def launch_info(n: int):
    """``{kernel: build.kernel_info}`` of each launch of one call of n
    lanes."""
    return {name: build.kernel_info("enqueue", i, n)
            for i, name in enumerate(KERNELS)}


def _lib():
    lib = build.library("enqueue")
    fn = lib.enqueue_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, p, p, p, p, p]
        lib.enqueue_geometry.restype = None
        lib.enqueue_geometry.argtypes = [p]
    return lib


def enqueue(qnext: torch.Tensor, next_count, krows: torch.Tensor,
            enq: torch.Tensor, max_count=None) -> torch.Tensor:
    """``count``; see the module contract."""
    global launches
    n, sw = krows.shape
    nc = count_arg(next_count, n, qnext.shape[0], krows.device, max_count)
    if krows.device.type == "cpu":
        return enqueue_plain(qnext, next_count, krows, enq)
    if krows.device.type != "cuda":
        raise ValueError(f"enqueue: unsupported device {krows.device}")
    if (krows.dtype != torch.uint8 or qnext.dtype != torch.uint8
            or qnext.dim() != 2 or qnext.shape[1] != sw
            or not krows.is_contiguous() or not qnext.is_contiguous()
            or enq.dtype != torch.bool or enq.shape != (n,)
            or enq.device != krows.device or qnext.device != krows.device
            or qnext.shape[0] >= 1 << 31):
        raise ValueError("enqueue: rows must be contiguous uint8 [n, sw] / "
                         "[Q, sw] and enq bool [n], on one device")
    tile, widest = geometry()
    if sw > widest:
        raise ValueError(f"enqueue: rows of {sw} bytes, the kernel takes at "
                         f"most {widest}")
    enq = enq.contiguous()
    if enq.data_ptr() % 16:          # the counts read the flags 16 at a time
        enq = enq.clone()
    dev = krows.device
    tile_count = count_scratch(n, tile, dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    err = _lib().enqueue_launch(
        enq.data_ptr(), n, krows.data_ptr(), sw, qnext.data_ptr(),
        nc.data_ptr(), tile_count.data_ptr(), count.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "enqueue_launch")
    launches += 1
    return count[0]
