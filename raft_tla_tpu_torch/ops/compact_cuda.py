"""Lane compaction: the CUDA kernel ``csrc/compact.cu`` and its plain version.

Replaces the JAX package's ``ops/compact_pallas.py`` (``_compact_jit``).
Contract, for a [B, G] enabled mask and K compacted lanes:

- ``P``       the longest parent prefix whose total fan-out fits K;
- ``total``   the enabled lanes of those P parents;
- ``lane_id`` [K] int32: the flat indices ``b * G + g`` of those lanes in
              ascending order, then ``kspread`` in the dead slots;
- ``kvalid``  [K] bool: ``arange(K) < total``.

``P`` and ``total`` come back as a [2] int32 device tensor, so the chunk
reads them without a host round trip.  ``compact`` launches the kernel for
CUDA tensors (two CUDA launches on the current stream, the row counts and
the multi-block scan and write, counted as one call) and takes
``compact_plain`` only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build

#: Kernel launches since the last reset (chip_smoke reads it).
launches = 0

#: The CUDA launches of one ``compact`` call, in order.
KERNELS = ("count_kernel", "compact_scan_kernel")


def compact_plain(en: torch.Tensor, K: int, kspread: torch.Tensor,
                  p_cap=None):
    """Plain PyTorch version: ``(pt [2] int32, lane_id [K] int32,
    kvalid [K] bool)`` with ``pt = (P, total)``.  ``p_cap`` (an int)
    takes at most that many parents, as the JAX compactor with
    ``reduce_p`` does; the kernel's output cut by ``ops/compact.py
    cap_prefix`` is equal to it."""
    B, G = en.shape
    cum = en.to(torch.int64).sum(1).cumsum(0)
    P = int((cum <= K).sum())
    if p_cap is not None:
        P = min(P, int(p_cap))
    total = int(cum[P - 1]) if P > 0 else 0
    flat = en[:P].reshape(-1).nonzero().squeeze(1).to(torch.int32)
    lane_id = kspread.clone()
    lane_id[:total] = flat
    kvalid = torch.arange(K, device=en.device) < total
    pt = torch.tensor([P, total], dtype=torch.int32, device=en.device)
    return pt, lane_id, kvalid


def _lib():
    lib = build.library("compact")
    fn = lib.compact_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i] + [p] * 6
    return lib


def launch_info(B: int, G: int, K: int):
    """``{kernel: build.kernel_info}`` of each launch of one call."""
    return {name: build.kernel_info("compact", i, B, G, K)
            for i, name in enumerate(KERNELS)}


def compact(en: torch.Tensor, K: int, kspread: torch.Tensor):
    """``(pt, lane_id, kvalid)`` of ``en`` (see the module contract)."""
    global launches
    if en.device.type == "cpu":
        return compact_plain(en, K, kspread)
    if en.device.type != "cuda":
        raise ValueError(f"compact: unsupported device {en.device}")
    B, G = en.shape
    if en.dtype != torch.bool or not en.is_contiguous():
        raise ValueError("compact: en must be a contiguous bool [B, G]")
    if (kspread.dtype != torch.int32 or kspread.shape != (K,)
            or kspread.device != en.device):
        raise ValueError("compact: kspread must be int32 [K] on en's device")
    if K & (K - 1) or K < G:
        raise ValueError(f"compact: K={K} must be a power of two >= G={G}")
    if B < 1:
        raise ValueError("compact: en must have a row")
    counts = torch.empty(B, dtype=torch.int32, device=en.device)
    pt = torch.empty(2, dtype=torch.int32, device=en.device)
    lane_id = torch.empty(K, dtype=torch.int32, device=en.device)
    kvalid = torch.empty(K, dtype=torch.bool, device=en.device)
    stream = torch.cuda.current_stream(en.device).cuda_stream
    err = _lib().compact_launch(
        en.data_ptr(), B, G, K, kspread.data_ptr(), counts.data_ptr(),
        pt.data_ptr(), lane_id.data_ptr(), kvalid.data_ptr(), stream)
    build.check(err, "compact_launch")
    launches += 1
    return pt, lane_id, kvalid
