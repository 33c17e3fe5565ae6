"""Device resolution for the port's entry points, and CUDA graph capture.

Entry points run on the card unless the caller asks for the CPU: there is
no silent fall back, so asking for ``cuda`` on a machine without a card
raises, and a graph capture that fails raises rather than running eagerly.
"""

from __future__ import annotations

import gc

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def capture_graph(fn, device, pool=None, graph=None):
    """``fn`` captured as a CUDA graph (``graph``, or a new one) in
    ``pool`` on a side stream; the caller has run ``fn`` once eagerly
    (that loads every kernel it launches).  A capture that fails raises."""
    torch.cuda.synchronize(device)
    # No garbage collection during the capture: freeing another engine's
    # pinned or device memory there makes calls a capture forbids, which
    # voids it.
    collecting = gc.isenabled()
    gc.disable()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    g = graph if graph is not None else torch.cuda.CUDAGraph()
    try:
        with torch.cuda.stream(side):
            g.capture_begin(pool=pool)
            try:
                fn()
            except BaseException:
                try:
                    g.capture_end()
                except RuntimeError:
                    pass    # the capture is void; the first error counts
                raise
            g.capture_end()
    finally:
        if collecting:
            gc.enable()
    torch.cuda.current_stream(device).wait_stream(side)
    return g
