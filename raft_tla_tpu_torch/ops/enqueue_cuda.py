"""Split-tail enqueue: the CUDA kernel ``csrc/enqueue.cu`` and its wrapper.

Replaces the JAX package's ``ops/enqueue_pallas.py`` (``_enqueue_jit``,
entry ``enqueue``).  ``enqueue(qnext, next_count, krows, enq) -> count``
follows the contract of ``ops/enqueue.py``: the rows of the ``enq`` lanes
land in lane order at ``qnext[next_count:]`` in place, ``count`` is a []
int32 device tensor, rows at and past it are unspecified.  ``next_count``
is a host int (the level loop holds it from the last stats read), so the
call makes no host wait.  ``enqueue`` launches the kernel for CUDA tensors
and takes ``enqueue_plain`` only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build
from .enqueue import enqueue_plain

#: Kernel launches since the last reset (chip_smoke reads it).
launches = 0


def _lib():
    lib = build.library("enqueue")
    fn = lib.enqueue_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, p, ctypes.c_longlong, p, p]
    return lib


def enqueue(qnext: torch.Tensor, next_count: int, krows: torch.Tensor,
            enq: torch.Tensor) -> torch.Tensor:
    """``count``; see the module contract."""
    global launches
    n, sw = krows.shape
    if next_count < 0 or next_count + n > qnext.shape[0]:
        raise ValueError(f"enqueue: {n} rows at {next_count} overrun the "
                         f"{qnext.shape[0]}-row queue")
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
    enq = enq.contiguous()
    if enq.data_ptr() % 16:          # the kernel reads the flags 16 at a time
        enq = enq.clone()
    count = torch.empty(1, dtype=torch.int32, device=krows.device)
    err = _lib().enqueue_launch(
        enq.data_ptr(), n, krows.data_ptr(), sw, qnext.data_ptr(),
        next_count, count.data_ptr(),
        torch.cuda.current_stream(krows.device).cuda_stream)
    build.check(err, "enqueue_launch")
    launches += 1
    return count[0]
