"""Simulation mode: TLC's ``-simulate`` as B lockstep random walkers.

The JAX package's ``engine/simulate.py`` (the ``simulate`` subcommand).
Each step, every walker draws uniformly among its enabled action
instances (``ops/walk_kernels.py masked_choice`` over random bits), takes
that one successor through the v2 pipeline (``models/actions2.py``
``lane_out``), checks the invariants on it, and restarts onto a uniform
random root on a dead end, an overflow, a constraint stop or the depth
bound.  There is no seen set: simulation never dedups.  Each walker
carries its root and the actions since its last restart, so the chunk's
first violation (first step with a bad walker, lowest walker there)
latches a ``(root, actions)`` pair that the host replays from the root's
encoded row (``engine/swarm.py replay_actions``).  Roots are
invariant-checked first, on their unpacked encoding.

The JAX simulator draws from ``jax.random``, a stream the port cannot
reproduce; the port draws from its own ``torch.Generator`` on the run's
device, seeded from ``seed``, so a seeded run repeats itself exactly and
the JAX package's contract (steps, restarts, a replayed violation that
the spec allows, the root check) holds, not its walks.

On the card the chunk runs as replays of one CUDA graph of up to 32 steps
(the largest divisor of ``chunk`` that is at most 32), with the generator
registered to the graph, so every replay draws anew; the latch and the
restart count are reset before each chunk and read once after it.  A
capture that fails raises.  On the CPU the chunk runs eagerly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..models.actions2 import build_v2
from ..models.dims import RaftDims
from ..models.invariants import build_inv_id
from ..models.pystate import PyState
from ..models.schema import flatten_state, unflatten_state
from ..ops.walk_kernels import masked_choice
from ..utils.device import capture_graph, resolve_device
from .swarm import (check_roots, latch_update, replay_actions,
                    resolve_walk_pipeline, root_rows)

#: The most steps one graph of the chunk holds.
GRAPH_STEPS = 32

# The accumulator: restarts, then the latch.
ACC_RESTARTS, ACC_VF, ACC_VINV, ACC_VROOT, ACC_VLEN, ACC_VCHOICE = range(6)
ACC_VACTS = 6


@dataclasses.dataclass
class SimResult:
    steps: int = 0                  # states visited (one per walker-step)
    traces: int = 0                 # traces started (initial B + restarts)
    wall_seconds: float = 0.0
    violation_invariant: Optional[str] = None
    violation_state: Optional[PyState] = None
    violation_trace: Optional[List[Tuple[int, PyState]]] = None
    chunks: int = 0
    device: str = ""
    #: Host seconds: graph ``capture`` (off ``wall_seconds``), ``dispatch``,
    #: ``sync`` (the one read a chunk).
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def states_per_second(self) -> float:
        return self.steps / self.wall_seconds if self.wall_seconds else 0.0


def graph_steps(chunk: int) -> int:
    """The largest divisor of ``chunk`` that is at most ``GRAPH_STEPS``."""
    return max(d for d in range(1, min(chunk, GRAPH_STEPS) + 1)
               if chunk % d == 0)


def build_sim_steps(dims: RaftDims, inv_fns, constraint, D: int, device):
    """``steps_fn(w, roots, acc, gen, n)``: ``n`` walker steps on the
    walker tensors ``w`` (rows, tstep, cur_root, abuf; updated in place),
    drawing from ``gen``; ``acc`` (restarts, then the latch: ``ACC_*``)
    accumulates across calls until the caller resets it."""
    v2 = build_v2(dims, device)
    inv_id = build_inv_id(inv_fns)
    lanes_d = torch.arange(D, device=device)

    def steps_fn(w, roots, acc, gen, n: int):
        rows, tstep, cur_root, abuf = w["rows"], w["tstep"], \
            w["cur_root"], w["abuf"]
        B = rows.shape[0]
        restarts = acc[ACC_RESTARTS]
        vf = acc[ACC_VF] != 0
        latch = acc[ACC_VINV:]
        for _ in range(n):
            st = unflatten_state(rows, dims)
            en, ovf = v2.masks(st)
            bits = torch.randint(0, 1 << 32, (B,), generator=gen,
                                 device=device)
            choice = masked_choice(bits, en)
            can_step = en.any(1)
            _h, _l, nxt = v2.lane_out(st, None, choice, hashes=False)
            nrows = flatten_state(nxt, dims)
            if inv_fns:
                inv = inv_id(nxt)
            else:
                inv = torch.full((B,), -1, dtype=torch.int64, device=device)
            bad = can_step & (inv >= 0)
            vals = torch.stack([inv, cur_root, tstep, choice])
            latch, vf = latch_update(latch, vf, bad, vals, abuf)
            if constraint is not None:
                cons_ok = constraint(nxt)
            else:
                cons_ok = torch.ones(B, dtype=torch.bool, device=device)
            at = lanes_d == tstep.clamp(0, D - 1).unsqueeze(1)
            abuf = torch.where(at, torch.where(can_step, choice, -1)
                               .unsqueeze(1), abuf)
            restart = ~can_step | ovf.any(1) | ~cons_ok | (tstep + 1 >= D)
            root_idx = torch.randint(0, roots.shape[0], (B,), generator=gen,
                                     device=device)
            rows = torch.where(restart.unsqueeze(1),
                               roots.index_select(0, root_idx),
                               torch.where(can_step.unsqueeze(1), nrows,
                                           rows))
            cur_root = torch.where(restart, root_idx, cur_root)
            tstep = torch.where(restart, 0, tstep + 1)
            restarts = restarts + restart.sum()
        for name, t in (("rows", rows), ("tstep", tstep),
                        ("cur_root", cur_root), ("abuf", abuf)):
            w[name].copy_(t)
        acc.copy_(torch.cat([torch.stack([restarts, vf.to(torch.int64)]),
                             latch]))

    return steps_fn


class Simulator:
    """B random walkers of depth ``depth``, ``chunk`` steps a host round
    trip; the JAX simulator's arguments and ``device`` (the card unless
    ``"cpu"``)."""

    def __init__(self, dims: RaftDims,
                 invariants: Optional[Dict[str, Callable]] = None,
                 constraint: Optional[Callable] = None,
                 batch: int = 256, depth: int = 100, chunk: int = 128,
                 pipeline: str = "auto", device="cuda"):
        if batch < 1 or depth < 1 or chunk < 1:
            raise ValueError(f"batch, depth and chunk must be >= 1, got "
                             f"{batch}, {depth}, {chunk}")
        self.dims = dims
        self.device = resolve_device(device)
        self.inv_names = list((invariants or {}).keys())
        self._inv_fns = list((invariants or {}).values())
        self._inv_id = build_inv_id(self._inv_fns)
        self.batch, self.depth, self.chunk = batch, depth, chunk
        self.pipeline_name = resolve_walk_pipeline(pipeline)
        self._v2 = build_v2(dims, self.device)
        self._steps = build_sim_steps(dims, self._inv_fns, constraint, depth,
                                      self.device)
        self._gen = torch.Generator(device=self.device)
        self._acc0 = torch.tensor([0, 0, -1, 0, 0, -1] + [0] * depth,
                                  dtype=torch.int64, device=self.device)
        self._acc = self._acc0.clone()
        self._graph = None
        self._w = None
        self._roots = None

    def _buffers(self, rows):
        """The walker tensors and the roots, where the graph reads them;
        roots of another count drop the graph."""
        B, D, dev = self.batch, self.depth, self.device
        if self._roots is None or self._roots.shape != rows.shape:
            self._graph = None
            self._roots = rows.clone()
            z = torch.zeros(B, dtype=torch.int64, device=dev)
            self._w = {"rows": rows[:1].expand(B, -1).clone(), "tstep": z,
                       "cur_root": z.clone(),
                       "abuf": torch.zeros((B, D), dtype=torch.int64,
                                           device=dev)}
        else:
            self._roots.copy_(rows)

    def _capture(self, res: SimResult):
        """The graph of ``graph_steps(chunk)`` steps, between one eager
        warm-up call and one replay (a graph's first launch uploads it) on
        the walker buffers, which the run then refills; the replay is
        waited for, so its device time stays off the run's clock."""
        t = time.time()
        n = graph_steps(self.chunk)

        def body():
            self._steps(self._w, self._roots, self._acc, self._gen, n)

        body()
        g = torch.cuda.CUDAGraph()
        g.register_generator_state(self._gen)
        capture_graph(body, self.device, None, graph=g)
        g.replay()
        torch.cuda.synchronize(self.device)
        self._graph = (g, n)
        res.phases["capture"] += time.time() - t

    def start(self, roots: List[PyState], seed: int,
              res: SimResult) -> bool:
        """A run's start: the root check (False, with the violation in
        ``res``, when a root violates), the buffers and graph, the
        generator seeded from ``seed`` and each walker on a random root."""
        dev, B = self.device, self.batch
        bad, inv, encoded = check_roots(self.dims, roots, self._inv_id,
                                        self._inv_fns, dev)
        if bad is not None:
            res.violation_state = roots[bad]
            res.violation_trace = [(-1, roots[bad])]
            res.violation_invariant = self.inv_names[inv]
            return False
        self._buffers(root_rows(self.dims, encoded, dev))
        if dev.type == "cuda" and self._graph is None:
            self._capture(res)
        # Seeded after any capture, so a run draws the same whatever
        # this simulator ran before.
        self._gen.manual_seed(seed)
        start = torch.randint(0, len(roots), (B,), generator=self._gen,
                              device=dev)
        self._w["rows"].copy_(self._roots.index_select(0, start))
        self._w["cur_root"].copy_(start)
        self._w["tstep"].zero_()
        self._w["abuf"].zero_()
        res.traces += B
        return True

    def dispatch_chunk(self) -> None:
        """Queue one chunk of steps (no host wait)."""
        self._acc.copy_(self._acc0)
        if self._graph is None:
            self._steps(self._w, self._roots, self._acc, self._gen,
                        self.chunk)
        else:
            g, n = self._graph
            for _ in range(self.chunk // n):
                g.replay()

    def read_chunk(self) -> list:
        """The chunk's restarts and latch (``ACC_*``): its one sync."""
        return self._acc.tolist()

    def run(self, roots: List[PyState], num_steps: int, seed: int = 0,
            max_seconds: Optional[float] = None) -> SimResult:
        res = SimResult(device=str(self.device),
                        phases={"capture": 0.0, "dispatch": 0.0,
                                "sync": 0.0})
        t0 = time.time()
        if not self.start(roots, seed, res):
            res.wall_seconds = time.time() - t0
            return res
        phases = res.phases
        while res.steps < num_steps:
            t = time.time()
            self.dispatch_chunk()
            t_s = time.time()
            acc = self.read_chunk()
            phases["dispatch"] += t_s - t
            phases["sync"] += time.time() - t_s
            res.chunks += 1
            res.steps += self.batch * self.chunk
            res.traces += acc[ACC_RESTARTS]
            if acc[ACC_VF]:
                self._reconstruct(res, roots, acc)
                break
            if (max_seconds is not None
                    and time.time() - t0 - phases["capture"] > max_seconds):
                break
        res.wall_seconds = time.time() - t0 - phases["capture"]
        return res

    def _reconstruct(self, res: SimResult, roots, acc):
        """Replay the latched (root, actions, choice) into the trace."""
        vinv, vlen = acc[ACC_VINV], acc[ACC_VLEN]
        acts = acc[ACC_VACTS:ACC_VACTS + vlen] + [acc[ACC_VCHOICE]]
        trace = replay_actions(self._v2, self.dims, roots[acc[ACC_VROOT]],
                               acts, self.device)
        res.violation_state = trace[-1][1]
        res.violation_trace = trace
        res.violation_invariant = (self.inv_names[vinv]
                                   if 0 <= vinv < len(self.inv_names)
                                   else "?")
