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

Across processes (``parallel/multihost.py``) each process runs its own
L fleets of n = m·L global ones, process r fleets r·L … r·L+L−1, fleet
s still drawing from ``fleet_seed(seed, s)``: m processes give the
one-process mesh's run at the same n, walk for walk.  Each round
all-gathers every fleet's restarts and latch, and the lowest latched
fleet's accumulator (root, actions, choice) is sent from its owner, so
every process replays the same trace; a ``max_seconds`` stop is agreed
(``build_any``) before it ends the loop.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from ..engine.simulate import ACC_RESTARTS, ACC_VF, SimResult, Simulator
from ..models.dims import RaftDims
from ..models.pystate import PyState
from ..obs.tracing import SpanTracer
from . import multihost as mh
from .mesh import resolve_devices


def fleet_seed(seed: int, s: int) -> int:
    """The generator seed of fleet ``s`` (fleet 0: ``seed``)."""
    return (seed + s * 0x9E3779B97F4A7C15) & ((1 << 63) - 1)


class MeshSimulator:
    """n independent fleets of ``batch`` walkers, one a device of
    ``devices`` (every visible card for None; a list may repeat one).
    Under a process group ``devices`` are this process's fleets and n
    counts every process's."""

    def __init__(self, dims: RaftDims,
                 invariants: Optional[Dict[str, Callable]] = None,
                 constraint: Optional[Callable] = None,
                 batch: int = 256, depth: int = 100, chunk: int = 128,
                 pipeline: str = "auto", devices=None):
        self.dims = dims
        self.devices = resolve_devices(devices)
        L = len(self.devices)
        self._mp = mh.is_multiprocess()
        pc, pi = 1, 0
        if self._mp:
            per_rank = mh.all_gather_objects(L)
            if len(set(per_rank)) > 1:
                raise ValueError(
                    "every process of the group must drive as many "
                    f"fleets; the processes' counts are {per_rank}")
            pc, pi = len(per_rank), mh.process_index()
            self._any = mh.build_any()
        self._L, self._r0 = L, pi * L
        self.n_dev = pc * L
        self.batch, self.depth, self.chunk = batch, depth, chunk
        # The span tracer (obs/tracing.py): the CLI attaches one
        # for --trace-out; sim_chunk and sim_fetch spans a chunk.
        self.tracer = SpanTracer(None)
        self.inv_names = list((invariants or {}).keys())
        self.fleets = [Simulator(dims, invariants=invariants,
                                 constraint=constraint, batch=batch,
                                 depth=depth, chunk=chunk, pipeline=pipeline,
                                 device=d) for d in self.devices]

    def _round(self, accs):
        """``(restarts of every fleet, the lowest latched fleet's
        accumulator or None)``, the same on every process."""
        if not self._mp:
            hit = next((s for s, acc in enumerate(accs) if acc[ACC_VF]),
                       None)
            return ([acc[ACC_RESTARTS] for acc in accs],
                    None if hit is None else accs[hit])
        restarts = mh.gather_rows(torch.tensor(
            [acc[ACC_RESTARTS] for acc in accs], dtype=torch.int64))
        g, acc = mh.lowest_flagged([acc[ACC_VF] for acc in accs], accs)
        return restarts.tolist(), None if g is None else acc.tolist()

    def run(self, roots: List[PyState], num_steps: int, seed: int = 0,
            max_seconds: Optional[float] = None) -> SimResult:
        label = f"mesh of {self.n_dev}"
        if self._mp:
            label += f", process {self._r0 // self._L}"
        res = SimResult(device=label + ": " + ", ".join(
                            str(d) for d in self.devices),
                        phases={"capture": 0.0, "dispatch": 0.0,
                                "sync": 0.0})
        t0 = time.time()
        for s, fleet in enumerate(self.fleets, self._r0):
            if not fleet.start(roots, fleet_seed(seed, s), res):
                res.wall_seconds = time.time() - t0
                return res
        res.traces = self.n_dev * self.batch
        phases = res.phases
        tracer = self.tracer
        while res.steps < num_steps:
            t = time.time()
            with tracer.span("sim_chunk"):
                for fleet in self.fleets:
                    fleet.dispatch_chunk()
            t_s = time.time()
            with tracer.span("sim_fetch"):
                accs = [fleet.read_chunk() for fleet in self.fleets]
            phases["dispatch"] += t_s - t
            phases["sync"] += time.time() - t_s
            restarts, hit = self._round(accs)
            res.chunks += 1
            res.steps += self.n_dev * self.batch * self.chunk
            res.traces += sum(restarts)
            if hit is not None:
                self.fleets[0]._reconstruct(res, roots, hit)
                break
            over = (max_seconds is not None
                    and time.time() - t0 - phases["capture"] > max_seconds)
            if self._mp and max_seconds is not None:
                over = self._any(over)
            if over:
                break
        res.wall_seconds = time.time() - t0 - phases["capture"]
        return res
