"""Seen-set insert: the CUDA kernel ``csrc/fpset.cu`` and its plain version.

Replaces the JAX package's ``ops/fpset_pallas.py`` (``_insert_padded``).
Contract of ``insert(seen, keys, valid) -> (is_new, fail)`` on packed
int64 keys (``ops/fpset.py pack`` of the JAX ``(hi, lo)`` lanes):

- every valid query's key is in the table afterwards;
- ``is_new[l]`` is True exactly on the lowest valid lane holding each key
  that was not in the table before the call;
- ``seen.size`` grows by ``is_new.sum()`` (in place, as ``seen.keys``);
- ``fail`` ([] bool) is True if a valid query found neither its key nor
  an empty slot within ``PROBE_ROUNDS`` probes of its chain.

The raw slot a key lands in may differ between the kernel and the plain
version.  When no query fails, the stored key set, ``is_new`` and the
size may not; near a full chain the different layouts can make different
queries fail, so ``fail`` is the same only up to that (the engine stops
on it either way).  ``insert`` launches the kernel for CUDA tensors and
takes ``insert_plain`` only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import build
from .fingerprint import MASK32
from .fpset import EMPTY, PROBE_ROUNDS, FPSet, probe_base

#: Kernel launches since the last reset (chip_smoke reads it).
launches = 0


def insert_plain(seen: FPSet, keys: torch.Tensor, valid: torch.Tensor):
    """Plain version: the queries are inserted one after another in lane
    order, as the TPU kernel does.  Tensors on the card are copied to the
    host and back."""
    c = seen.capacity
    table_t = seen.keys.cpu()
    table = table_t.numpy()
    keys_c = keys.cpu()
    h1, h2 = probe_base((keys_c >> 32) & MASK32, keys_c & MASK32, c)
    is_new = np.zeros(keys_c.shape[0], bool)
    fail = False
    for lane, (key, a, b, ok) in enumerate(zip(
            keys_c.tolist(), h1.tolist(), h2.tolist(), valid.cpu().tolist())):
        if not ok:
            continue
        step = 0
        for _r in range(PROBE_ROUNDS):
            idx = (a + step * b) & MASK32 & (c - 1)
            cur = int(table[idx])
            if cur == EMPTY:
                table[idx] = key
                is_new[lane] = True
                break
            if cur == key:
                break
            step += 1
        else:
            fail = True
    if seen.keys.device.type != "cpu":
        seen.keys.copy_(table_t)
    seen.size.add_(int(is_new.sum()))
    dev = keys.device
    return (torch.as_tensor(is_new, device=dev),
            torch.tensor(fail, device=dev))


def check_queries(seen: FPSet, keys: torch.Tensor, valid: torch.Tensor):
    """Raise on queries the insert does not take (on any device)."""
    dev = seen.keys.device
    if keys.device != dev or valid.device != dev:
        raise ValueError("insert: queries and table on different devices")
    if keys.dtype != torch.int64 or valid.dtype != torch.bool:
        raise ValueError("insert: keys must be int64, valid bool")
    if keys.shape != valid.shape or keys.dim() != 1:
        raise ValueError("insert: keys and valid must be [n]")
    if keys.shape[0] >= 1 << 31:
        raise ValueError("insert: more than 2^31 - 1 queries")
    if dev.type == "cuda" and seen.owner is None:
        raise ValueError("insert: CUDA table without its owner scratch")


def _lib():
    lib = build.library("fpset")
    fn = lib.fpset_insert_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_int, p, ctypes.c_longlong, p, p, p, p,
                       p, p]
    return lib


#: The CUDA launches of one call, in order (``launch_info``).
KERNELS = ("probe_claim_kernel", "own_kernel", "resolve_kernel")


def launch_info(n: int):
    """``{kernel: build.kernel_info}`` of each launch of one call of n
    queries."""
    return {name: build.kernel_info("fpset", i, n)
            for i, name in enumerate(KERNELS)}


def insert(seen: FPSet, keys: torch.Tensor, valid: torch.Tensor):
    """``(is_new [n] bool, fail [] bool)``; see the module contract.  On
    the card: three launches, and no other device operation (the outputs are
    allocated, the kernels zero and write ``fail``)."""
    global launches
    check_queries(seen, keys, valid)
    if keys.device.type == "cpu":
        return insert_plain(seen, keys, valid)
    if keys.device.type != "cuda":
        raise ValueError(f"insert: unsupported device {keys.device}")
    keys, valid = keys.contiguous(), valid.contiguous()
    n = keys.shape[0]
    dev = keys.device
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    is_new = torch.empty(n, dtype=torch.bool, device=dev)
    fail = torch.empty((), dtype=torch.bool, device=dev)
    err = _lib().fpset_insert_launch(
        keys.data_ptr(), valid.data_ptr(), n, seen.keys.data_ptr(),
        seen.capacity, seen.owner.data_ptr(), slot.data_ptr(),
        is_new.data_ptr(), seen.size.data_ptr(), fail.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "fpset_insert_launch")
    launches += 1
    return is_new, fail
