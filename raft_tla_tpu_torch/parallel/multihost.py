"""Multi-controller support: one mesh of n global shards run as m
processes over ``torch.distributed``.

The JAX package's ``parallel/multihost.py``.  There every host runs the
same program over one global device mesh and XLA's collectives cross
the hosts; here every process runs the same mesh loop
(``parallel/mesh.py``, ``parallel/simulate.py``) over its own L shards,
and the crossings between shards of different processes are collectives
of a process group.  The global shard order is rank-major, as the JAX
global device list is: process r owns the shards r·L … r·L+L−1.

- ``initialize()`` forms the group from the launch contract the JAX CLI
  reads: ``RAFT_COORDINATOR`` (host:port), ``RAFT_NUM_PROCESSES`` and
  ``RAFT_PROCESS_ID``, the same command run on every host.  The group is
  gloo, with a finite timeout on every collective.  The transport for
  card shards is chosen once, there, from the layout of the cards: NCCL
  (a group of its own) where every rank has cards of its own, gloo where
  two ranks share a card (NCCL refuses a communicator with two ranks on
  one device), staging the exchanged tensors through pinned host
  buffers.  CPU shards ride gloo.  The transport is never switched
  after a failure: a collective that fails or times out raises.
- ``shutdown()`` leaves the group: a barrier (every controller has
  finished its collectives), then the NCCL group and the default group
  destroyed, so no controller drops the TCP store rank 0 hosts while
  another still tears down.  ``initialize`` registers it with
  ``atexit``; the CLI calls it before it returns its exit code.  A
  later ``initialize`` forms a new group.
- The agreement primitives (``build_any``, ``build_min``, ``build_sum``,
  ``build_budget_agree``), each one collective round trip over the gloo
  group, turn per-process host facts into one value every process reads.
- ``lowest_flagged`` is the host-side ``bcast_lowest_flagged``: the
  lowest global shard whose flag is set, and its values sent from the
  process that owns it.
- ``GroupExchange``: the four crossings of a mesh step (the cond's AND,
  the shared P's minimum, the owner blocks out and the novelty bits
  back) as ``all_reduce`` and ``all_to_all_single``.

Host-loop rules for multi-controller engines, the JAX module's:

1. every process executes the same sequence of collectives (trip counts
   must match: a process that skips one leaves the others waiting in it);
2. anything the host READS to decide is replicated: gathered or reduced
   over the group, so every process reads the same value (a process that
   steers on its own shard's count diverges);
3. anything the host WRITES into its shards is its own share, computed
   identically everywhere (roots, resumed frontiers);
4. control-flow decisions from host-local state (clocks, the local spill
   pool) go through an agreement before they steer a collective.
"""

from __future__ import annotations

import atexit
import datetime
import os
import socket
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

#: Seconds a collective (and the group's rendezvous) may take before it
#: raises.
TIMEOUT_SECONDS = 300.0

# The group this process joined: the NCCL group for card shards (None
# where the transport is gloo) and the transport's name.  Process-wide,
# as torch.distributed's default group itself is.
_state: Dict[str, object] = {"transport": None, "nccl": None,
                             "atexit": False}


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_seconds: float = TIMEOUT_SECONDS) -> str:
    """Join (or create) the process group; the arguments default to
    ``RAFT_COORDINATOR`` / ``RAFT_NUM_PROCESSES`` / ``RAFT_PROCESS_ID``.
    Returns the transport chosen for card shards ("gloo" or "nccl").  A
    process already in a group keeps it."""
    if dist.is_initialized():
        return _state["transport"]
    coordinator = coordinator or os.environ.get("RAFT_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("RAFT_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("RAFT_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if not coordinator or num_processes is None or process_id is None:
        raise ValueError(
            "a process group needs RAFT_COORDINATOR (host:port), "
            "RAFT_NUM_PROCESSES and RAFT_PROCESS_ID, or the same "
            "arguments")
    timeout = datetime.timedelta(seconds=timeout_seconds)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    if not _state["atexit"]:
        atexit.register(shutdown)
        _state["atexit"] = True
    cards = all_gather_objects(visible_cards())
    owners: Dict[str, int] = {}
    shared = False
    for rank, keys in enumerate(cards):
        for k in keys:
            shared = shared or owners.setdefault(k, rank) != rank
    if all(cards) and not shared:
        _state["nccl"] = dist.new_group(backend="nccl", timeout=timeout)
        _state["transport"] = "nccl"
    else:
        _state["transport"] = "gloo"
    return _state["transport"]


def shutdown() -> None:
    """Leave the group: a barrier under the group's timeout, then the
    NCCL group (where there is one) and the default group destroyed.  A
    no-op outside a group; the groups are destroyed even when the
    barrier fails (a controller that died), and the failure raises."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    try:
        dist.barrier()
    finally:
        nccl = _state["nccl"]
        _state["transport"] = _state["nccl"] = None
        if nccl is not None:
            dist.destroy_process_group(nccl)
        dist.destroy_process_group()


def is_multiprocess() -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def process_index() -> int:
    return dist.get_rank() if is_multiprocess() else 0


def process_count() -> int:
    return dist.get_world_size() if is_multiprocess() else 1


def transport() -> Optional[str]:
    """The card shards' transport chosen at ``initialize`` (None outside
    a group)."""
    return _state["transport"] if is_multiprocess() else None


def card_key(device: torch.device) -> str:
    """The identity of the memory a shard's device lives in: the card's
    UUID (two processes on one card name it alike), or this host's CPU."""
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        uuid = getattr(props, "uuid", None)
        if uuid is not None:
            return f"cuda:{uuid}"
        return f"{socket.gethostname()}:cuda:{device.index}"
    return f"{socket.gethostname()}:cpu"


def visible_cards() -> List[str]:
    """``card_key`` of every card this process sees."""
    if not torch.cuda.is_available():
        return []
    return [card_key(torch.device("cuda", i))
            for i in range(torch.cuda.device_count())]


def all_gather_objects(obj) -> list:
    """Every process's ``obj``, in rank order (pickled over the gloo
    group)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def gather_rows(local: torch.Tensor) -> torch.Tensor:
    """Every process's ``local`` [L, ...] CPU tensor stacked in rank
    order: [m·L, ...], the global shard order."""
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts)


def _reduce(values, op) -> torch.Tensor:
    t = torch.tensor(values, dtype=torch.int64)
    dist.all_reduce(t, op=op)
    return t


def build_any():
    """Per-process flags -> one replicated "did anyone flag?"."""

    def any_flag(value: bool) -> bool:
        return bool(_reduce([int(bool(value))], dist.ReduceOp.MAX)[0])

    return any_flag


def build_min():
    """Per-process ints -> their minimum on every process (a snapshot
    level, a capacity, a clock)."""

    def min_val(value: int) -> int:
        return int(_reduce([int(value)], dist.ReduceOp.MIN)[0])

    return min_val


def build_sum():
    """Per-PROCESS ints summed, each process counted once (e.g. the
    controllers' spill-pool rows).  Each contribution is capped at
    ``(2^31 - 1) // m``, the JAX primitive's int32 saturation, so a
    queue budget stops where the JAX package's stops: a saturated total
    can only over-report."""
    cap = ((1 << 31) - 1) // max(1, process_count())

    def sum_val(value: int) -> int:
        return int(_reduce([min(int(value), cap)], dist.ReduceOp.SUM)[0])

    return sum_val


def build_budget_agree():
    """The pair a budgeted chunk needs in ONE round trip: (any process
    over its deadline?, the least of the chunk-size budgets)."""

    def budget(over: bool, allowed: int):
        t = _reduce([int(bool(over)), -int(allowed)], dist.ReduceOp.MAX)
        return bool(t[0]), -int(t[1])

    return budget


def lowest_flagged(flag: Sequence[bool], *values):
    """``flag``: this process's L shards' flags; each of ``values``: L
    items, one a local shard.  Returns ``(g, *items)``: the lowest global
    shard g whose flag is set and its items (numpy arrays), sent from the
    process that owns g, identical on every process; ``(None, None, ...)``
    when no flag is set anywhere."""
    L = len(flag)
    flags = gather_rows(torch.tensor([bool(f) for f in flag],
                                     dtype=torch.int64))
    hit = flags.nonzero()
    if not hit.numel():
        return (None,) + (None,) * len(values)
    g = int(hit[0, 0])
    owner, j = divmod(g, L)
    objs = [None]
    if dist.get_rank() == owner:
        objs = [[np.asarray(torch.as_tensor(v[j]).cpu()) for v in values]]
    dist.broadcast_object_list(objs, src=owner)
    return (g,) + tuple(objs[0])


class GroupExchange:
    """The crossings of a mesh step between the shards of every process:
    ``devices`` are this process's L shards, ``n`` = m·L global shards in
    rank-major order.  The same four operations as the one-process
    exchange (``parallel/mesh.py ListExchange``), as collectives:
    ``all_reduce`` for the cond (logical AND) and the least P,
    ``all_to_all_single`` for the [n, K] owner blocks (sources in global
    order, so an owner's n·K arrivals stay source-major) and for the
    novelty bits back.  CPU shards exchange over the gloo group; card
    shards over the transport ``initialize`` chose: NCCL on the card, or
    gloo through pinned host buffers (the device's streams synchronised
    before each collective reads them).  Every call blocks the host, so
    a step under a group runs eagerly, never inside a CUDA graph."""

    def __init__(self, devices: List[torch.device], n: int):
        self.devices = list(devices)
        self.L = len(devices)
        self.n = n
        self.m = n // self.L
        self.d0 = devices[0]
        self._cards = sorted({d for d in devices if d.type == "cuda"},
                             key=str)
        self._nccl = (_state["nccl"] if self.d0.type == "cuda"
                      and _state["transport"] == "nccl" else None)
        self._staged = self.d0.type == "cuda" and self._nccl is None
        self._bufs: Dict[tuple, torch.Tensor] = {}
        self.transport = ("nccl" if self._nccl is not None
                          else "gloo, staged in pinned host memory"
                          if self._staged else "gloo")

    # -- staging -------------------------------------------------------
    def _buf(self, role: str, like: torch.Tensor) -> torch.Tensor:
        key = (role, tuple(like.shape), like.dtype)
        b = self._bufs.get(key)
        if b is None:
            b = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._bufs[key] = b
        return b

    def _wire(self, t: torch.Tensor):
        """``t`` where the collective reads it, and where it writes."""
        if not self._staged:
            return t.contiguous(), torch.empty_like(t)
        src = self._buf("in", t)
        src.copy_(t, non_blocking=True)
        # The copy above, and every earlier read of an output buffer,
        # must be done before gloo reads and writes host memory.
        for d in self._cards:
            torch.cuda.current_stream(d).synchronize()
        return src, self._buf("out", t)

    def _home(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.d0, non_blocking=True) if self._staged else t

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        src, _out = self._wire(t)
        dist.all_reduce(src, op=op, group=self._nccl)
        return self._home(src)

    def _a2a(self, x: torch.Tensor) -> torch.Tensor:
        src, out = self._wire(x)
        dist.all_to_all_single(out, src, group=self._nccl)
        return self._home(out)

    # -- the four crossings --------------------------------------------
    def all(self, flags: List[torch.Tensor]) -> List[torch.Tensor]:
        """[1] bool a shard -> the AND over every shard, on each."""
        local = torch.cat([f.to(self.d0) for f in flags]).all()
        ok = self._all_reduce(local.to(torch.int32).view(1),
                              dist.ReduceOp.MIN) > 0
        return [ok.to(d) for d in self.devices]

    def min(self, vals: List[torch.Tensor]) -> List[torch.Tensor]:
        """The first word of each shard's tensor -> the least over every
        shard, [1] int64 on each."""
        local = torch.cat([v.narrow(0, 0, 1).to(self.d0)
                           for v in vals]).min().view(1).to(torch.int64)
        P = self._all_reduce(local, dist.ReduceOp.MIN)
        return [P.to(d) for d in self.devices]

    def to_owners(self, blocks: List[torch.Tensor]) -> List[torch.Tensor]:
        """``blocks[j]`` [n, k]: local source j's block for each global
        owner -> for each local owner i its n·k arrivals, source-major in
        global order."""
        L, m, k = self.L, self.m, blocks[0].shape[1]
        x = torch.stack([b.to(self.d0) for b in blocks])      # [j, n, k]
        x = x.view(L, m, L, k).transpose(0, 1).contiguous()    # [q, j, i, k]
        y = self._a2a(x)                                       # [p, j, i, k]
        return [y[:, :, i].reshape(self.n * k).to(d)
                for i, d in enumerate(self.devices)]

    def to_sources(self, nov: List[torch.Tensor]) -> List[torch.Tensor]:
        """``nov[i]`` [n, k] bool: local owner i's novelty bits of each
        global source's block -> for each local source j its [n, k] bits,
        row d from global owner d."""
        L, m, k = self.L, self.m, nov[0].shape[1]
        x = torch.stack([v.to(self.d0) for v in nov])          # [i, n, k]
        x = x.to(torch.uint8).view(L, m, L, k)                 # [i, p, j, k]
        x = x.permute(1, 2, 0, 3).contiguous()                 # [p, j, i, k]
        y = self._a2a(x)                                       # [q, j, i, k]
        return [y[:, j].reshape(self.n, k).to(d, torch.bool)
                for j, d in enumerate(self.devices)]
