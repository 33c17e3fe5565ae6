"""Mesh simulation: TLC's ``-simulate`` worker pool over n shards.

The JAX package's ``parallel/simulate.py`` ``MeshSimulator``.  Simulation
is embarrassingly parallel (independent random walkers, no seen set), so
the mesh is n independent walker fleets, each the port's ``Simulator``
(``engine/simulate.py``) on its shard's device with ``batch`` walkers and
a generator of its own.  A round dispatches one chunk on every fleet,
then reads each fleet's restarts and latch; the first latched fleet, the
lowest index, reports, and its ``(root, actions)`` is replayed as the
single simulator replays it.  Fleet 0 draws from ``seed`` itself, so one
shard gives exactly the single ``Simulator``'s run; fleet s from
``fleet_seed(seed, s)``.  As for the single simulator, the draws are the
port's own (``torch.Generator``), not the JAX package's: a seeded run
repeats itself, walk for walk.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from ..engine.simulate import ACC_RESTARTS, ACC_VF, SimResult, Simulator
from ..models.dims import RaftDims
from ..models.pystate import PyState
from .mesh import resolve_devices


def fleet_seed(seed: int, s: int) -> int:
    """The generator seed of fleet ``s`` (fleet 0: ``seed``)."""
    return (seed + s * 0x9E3779B97F4A7C15) & ((1 << 63) - 1)


class MeshSimulator:
    """n independent fleets of ``batch`` walkers, one a device of
    ``devices`` (every visible card for None; a list may repeat one)."""

    def __init__(self, dims: RaftDims,
                 invariants: Optional[Dict[str, Callable]] = None,
                 constraint: Optional[Callable] = None,
                 batch: int = 256, depth: int = 100, chunk: int = 128,
                 pipeline: str = "auto", devices=None):
        self.dims = dims
        self.devices = resolve_devices(devices)
        self.n_dev = len(self.devices)
        self.batch, self.depth, self.chunk = batch, depth, chunk
        self.inv_names = list((invariants or {}).keys())
        self.fleets = [Simulator(dims, invariants=invariants,
                                 constraint=constraint, batch=batch,
                                 depth=depth, chunk=chunk, pipeline=pipeline,
                                 device=d) for d in self.devices]

    def run(self, roots: List[PyState], num_steps: int, seed: int = 0,
            max_seconds: Optional[float] = None) -> SimResult:
        res = SimResult(device=f"mesh of {self.n_dev}: " + ", ".join(
                            str(d) for d in self.devices),
                        phases={"capture": 0.0, "dispatch": 0.0,
                                "sync": 0.0})
        t0 = time.time()
        for s, fleet in enumerate(self.fleets):
            if not fleet.start(roots, fleet_seed(seed, s), res):
                res.wall_seconds = time.time() - t0
                return res
        phases = res.phases
        while res.steps < num_steps:
            t = time.time()
            for fleet in self.fleets:
                fleet.dispatch_chunk()
            t_s = time.time()
            accs = [fleet.read_chunk() for fleet in self.fleets]
            phases["dispatch"] += t_s - t
            phases["sync"] += time.time() - t_s
            res.chunks += 1
            res.steps += self.n_dev * self.batch * self.chunk
            res.traces += sum(acc[ACC_RESTARTS] for acc in accs)
            hit = next((s for s, acc in enumerate(accs) if acc[ACC_VF]),
                       None)
            if hit is not None:
                self.fleets[hit]._reconstruct(res, roots, accs[hit])
                break
            if (max_seconds is not None
                    and time.time() - t0 - phases["capture"] > max_seconds):
                break
        res.wall_seconds = time.time() - t0 - phases["capture"]
        return res
