"""Front end: a resolved cfg -> an engine run (the ``tlc <cfg>`` path).

Invariant names resolve through ``models/invariants.py``'s registry
(TypeOK, NoLeaderElected and the safety suite of ``models/safety.py``), the
``BoundedSpace`` constraint reads MaxTerm/MaxLogLen/MaxMsgCount, and the
cfg's StopAfter budgets and ``\\* TPU:`` directives (BATCH,
QUEUE_CAPACITY, SEEN_CAPACITY, PIPELINE, CHECKPOINT_DIR, CHECKPOINT_EVERY,
CHECKPOINT_INTERVAL, KEEP_CHECKPOINTS, SPILL_DIR, PROGRESS_SECONDS,
POR_TABLE, REPORT, EVENTS_OUT, COUNTEREXAMPLE_DIR, TRACE_DIR) seed the
engine config.  Precedence: caller > cfg directive > built-in default.
PLATFORM picks the device (``device_for``).  The directives of modules
not ported yet (``UNPORTED_DIRECTIVES``) are refused, naming their
ROADMAP item, rather than accepted and ignored.  MODE picks the checking tier (``exhaustive``, or the
``swarm`` of ``engine/swarm.py`` with WALKS walks); ``make_swarm`` and
``make_simulator`` build the walk tiers with the JAX CLI's defaults.
``path_to_state`` finds a shortest action path to a given state.  Every
entry point takes ``device`` and runs on the card unless the caller
passes ``device="cpu"`` (or the cfg says ``PLATFORM = cpu``).
``engine_cls`` ("single", "mesh", "auto" or a class; ``ENGINES``) picks
the exhaustive engine, and ``make_simulator``'s ``engine`` the simulator:
the mesh (``parallel/``) shards over every visible card, or over one
shard on a device named with an index or on the CPU; "auto" takes the
mesh when more than one card is visible, and under a process group
(``parallel/multihost.py``), where the single engine is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from ..models import smoke
from ..models.dims import RaftDims
from ..models.invariants import build_constraint, invariant_registry
from ..models.pystate import PyState, init_state
from ..models.schema import encode_state, stack_states
from ..ops.fingerprint import build_fingerprint
from ..parallel import multihost as mh
from ..parallel.mesh import MeshBFSEngine
from ..parallel.simulate import MeshSimulator
from ..utils.cfg import CheckSetup, load_config
from .bfs import BFSEngine, EngineConfig, EngineResult
from .simulate import Simulator
from .swarm import SwarmEngine, SwarmResult

MODES = ("exhaustive", "swarm")

#: ``--engine``: the single-device engine, the mesh, or the mesh when
#: more than one card is visible (the JAX CLI's choices and default).
ENGINES = ("single", "mesh", "auto")

#: Directives of modules not ported yet -> the ROADMAP.md item that ports
#: them.  A cfg that sets one (to anything but off: 0 or FALSE) is refused.
#: Every directive of the JAX package's obs/ is honoured now (TRACE_OUT,
#: PROFILE_CHUNKS, XLA_PROFILE and PERF here, METRICS_PORT and HISTORY by
#: the CLI), so none is left.
UNPORTED_DIRECTIVES: Dict[str, str] = {}

#: PLATFORM directive -> device.
PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def check_directives(setup: CheckSetup) -> None:
    """Refuse a cfg that asks for what the port does not do yet."""
    for key, item in UNPORTED_DIRECTIVES.items():
        if setup.backend.get(key, False) not in (False, 0):
            raise ValueError(
                f"the {key} directive is not ported yet (ROADMAP.md "
                f"{item}); remove it from the cfg")


def platform_device(platform) -> str:
    """A platform name (the PLATFORM directive, or the JAX CLI's
    ``--platform``) -> its device: ``cpu``, or ``gpu``/``cuda`` for the
    card; any other (``tpu``) is refused."""
    name = str(platform).lower()
    if name not in PLATFORMS:
        raise ValueError(
            f"PLATFORM = {platform} is not a platform of this package: "
            "cpu, or gpu/cuda for the card (tpu is the JAX package's)")
    return PLATFORMS[name]


def resolve_device_flags(device: Optional[str],
                         platform: Optional[str]) -> Optional[str]:
    """``--device`` with ``--platform`` (the JAX spelling, mapped by
    ``platform_device``) -> the device, None where neither was given;
    ValueError on a refused platform or when the two disagree."""
    if platform is None:
        return device
    mapped = platform_device(platform)
    if device is not None and device != mapped:
        raise ValueError(f"--device {device} and --platform {platform} "
                         "disagree")
    return mapped


def device_for(setup: CheckSetup, device=None) -> str:
    """The caller's device, else the PLATFORM directive's (``cpu``, or
    ``gpu``/``cuda`` for the card), else the card."""
    if device is not None:
        return device
    platform = setup.backend.get("PLATFORM")
    if platform is None:
        return "cuda"
    return platform_device(platform)

CONSTRAINT_REGISTRY = {"BoundedSpace": build_constraint}


def resolve_invariants(setup: CheckSetup) -> Dict[str, Callable]:
    registry = invariant_registry()
    invs = {}
    for name in setup.invariants:
        if name not in registry:
            raise ValueError(f"unknown INVARIANT {name!r}; registered: "
                             f"{sorted(registry)}")
        invs[name] = registry[name](setup.dims)
    return invs


def resolve_constraint(setup: CheckSetup) -> Optional[Callable]:
    constraint = None
    for name in setup.constraints:
        if name not in CONSTRAINT_REGISTRY:
            raise ValueError(f"unknown CONSTRAINT {name!r}; registered: "
                             f"{sorted(CONSTRAINT_REGISTRY)}")
        if constraint is not None:
            raise ValueError("multiple constraints not yet supported")
        constraint = CONSTRAINT_REGISTRY[name](setup.dims, setup.bounds)
    return constraint


def engine_config_from_backend(setup: CheckSetup) -> EngineConfig:
    check_directives(setup)
    be = setup.backend
    return EngineConfig(
        batch=be.get("BATCH", EngineConfig.batch),
        queue_capacity=be.get("QUEUE_CAPACITY", EngineConfig.queue_capacity),
        seen_capacity=be.get("SEEN_CAPACITY", EngineConfig.seen_capacity),
        pipeline=be.get("PIPELINE", EngineConfig.pipeline),
        checkpoint_dir=be.get("CHECKPOINT_DIR"),
        checkpoint_every=be.get("CHECKPOINT_EVERY",
                                EngineConfig.checkpoint_every),
        checkpoint_interval_seconds=float(
            be.get("CHECKPOINT_INTERVAL",
                   EngineConfig.checkpoint_interval_seconds)),
        keep_checkpoints=be.get("KEEP_CHECKPOINTS"),
        spill_dir=be.get("SPILL_DIR"),
        progress_interval_seconds=float(
            be.get("PROGRESS_SECONDS",
                   EngineConfig.progress_interval_seconds)),
        por=bool(be.get("POR", False)),
        por_table=be.get("POR_TABLE"),
        statespace_report=bool(be.get("REPORT", True)),
        events_out=be.get("EVENTS_OUT"),
        counterexample_dir=be.get("COUNTEREXAMPLE_DIR"),
        trace_dir=be.get("TRACE_DIR"),
        trace_out=be.get("TRACE_OUT"),
        profile_chunks_every=be.get("PROFILE_CHUNKS"),
        xla_profile_chunks=be.get("XLA_PROFILE") or None,
        perf=bool(be.get("PERF", False)))


def use_mesh(engine: Optional[str], device: str) -> bool:
    """Whether ``engine`` (``ENGINES``, None for "single") on ``device``
    is the mesh: "auto" is under a process group, and where more than one
    card is visible and the run is on the card."""
    if engine not in (None,) + ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if engine == "auto":
        if mh.is_multiprocess():
            return True
        return (torch.device(device).type == "cuda"
                and torch.cuda.is_available()
                and torch.cuda.device_count() > 1)
    return engine == "mesh"


def mesh_devices(device: str):
    """The mesh's shards for ``device``: every visible card for "cuda",
    else that one device."""
    return None if device == "cuda" else [device]


def refuse_single_in_group(mesh: bool) -> None:
    """A single-device engine or simulator in each process of a group
    would run N duplicate full checks, all writing one counterexample:
    under a process group only the mesh runs (the JAX CLI's rule)."""
    if not mesh and mh.is_multiprocess():
        raise ValueError("multi-host mode (RAFT_COORDINATOR) requires "
                         "--engine mesh or auto")


def make_engine(setup: CheckSetup,
                engine_config: Optional[EngineConfig] = None,
                device=None, engine_cls=None, devices=None) -> BFSEngine:
    """An engine with the cfg fallbacks applied (CHECK_DEADLOCK, StopAfter
    budgets) on ``device_for(setup, device)``; the caller's config is
    never mutated.  ``engine_cls``: None or "single" for ``BFSEngine``,
    "mesh" or ``MeshBFSEngine`` for the mesh (over ``devices`` when
    given), "auto" for the mesh where more than one card is visible."""
    check_directives(setup)
    base = engine_config or engine_config_from_backend(setup)
    cfg = dataclasses.replace(
        base,
        check_deadlock=(base.check_deadlock
                        if base.check_deadlock is not None
                        else setup.check_deadlock),
        max_seconds=(base.max_seconds if base.max_seconds is not None
                     else setup.max_seconds),
        max_diameter=(base.max_diameter if base.max_diameter is not None
                      else setup.max_diameter),
        exit_conditions=(base.exit_conditions or setup.exit_conditions))
    dev = device_for(setup, device)
    kw = dict(invariants=resolve_invariants(setup),
              constraint=resolve_constraint(setup), config=cfg)
    if isinstance(engine_cls, type):
        mesh = issubclass(engine_cls, MeshBFSEngine)
    else:
        mesh = use_mesh(engine_cls, dev)
    refuse_single_in_group(mesh)
    if mesh:
        return MeshBFSEngine(setup.dims, devices=(
            devices if devices is not None else mesh_devices(dev)), **kw)
    return BFSEngine(setup.dims, device=dev, **kw)


def resolve_mode(setup: CheckSetup, mode: Optional[str] = None) -> str:
    """The checking tier: the caller's, else the MODE directive, else
    ``exhaustive``."""
    mode = mode if mode is not None else setup.backend.get("MODE",
                                                           "exhaustive")
    if mode not in MODES:
        raise ValueError(f"MODE must be exhaustive or swarm, got {mode!r}")
    return mode


#: The swarm's default lanes a dispatch.  A walk step is ~1,400 small
#: device ops whatever the lanes, so a dispatch of 1,024 (the JAX CLI's
#: default) is launch-bound; results do not depend on the slicing, and
#: 65,536 lanes take ~3.8 GB of device memory at MCraft_bounded.
SWARM_BATCH = 65536


def make_swarm(setup: CheckSetup, walks: Optional[int] = None,
               max_depth: Optional[int] = None,
               batch: Optional[int] = None, device=None,
               **kw) -> SwarmEngine:
    """The swarm of a cfg: walks from the caller, WALKS or 1024; the depth
    bound from the caller, the cfg's diameter budget or 128; lanes a
    dispatch from the caller, BATCH or ``SWARM_BATCH`` (at most the
    walks); events and counterexample files from the caller, else
    EVENTS_OUT and COUNTEREXAMPLE_DIR."""
    check_directives(setup)
    be = setup.backend
    if kw.get("events_out") is None:
        kw["events_out"] = be.get("EVENTS_OUT")
    if kw.get("counterexample_dir") is None:
        kw["counterexample_dir"] = be.get("COUNTEREXAMPLE_DIR")
    for key, directive in (("trace_out", "TRACE_OUT"),
                           ("profile_chunks_every", "PROFILE_CHUNKS"),
                           ("xla_profile_chunks", "XLA_PROFILE")):
        if kw.get(key) is None:
            kw[key] = be.get(directive)
    if not kw.get("perf"):
        kw["perf"] = bool(be.get("PERF", False))
    walks = int(walks if walks is not None else be.get("WALKS", 1024))
    batch = int(batch if batch is not None
                else be.get("BATCH", SWARM_BATCH))
    return SwarmEngine(
        setup.dims, invariants=resolve_invariants(setup),
        constraint=resolve_constraint(setup), walks=walks,
        max_depth=max_depth or setup.max_diameter or 128,
        batch=min(batch, walks), device=device_for(setup, device), **kw)


def make_simulator(setup: CheckSetup, batch: Optional[int] = None,
                   depth: int = 100, device=None, engine=None,
                   pipeline: Optional[str] = None, metrics=None):
    """The simulator of a cfg: walkers from the caller, BATCH or 1024
    (a fleet, on the mesh); the walk expansion from the caller, PIPELINE
    or ``auto``; ``engine`` as ``make_engine``'s."""
    check_directives(setup)
    be = setup.backend
    dev = device_for(setup, device)
    kw = dict(invariants=resolve_invariants(setup),
              constraint=resolve_constraint(setup),
              batch=int(batch if batch is not None else be.get("BATCH", 1024)),
              depth=depth,
              pipeline=(pipeline if pipeline is not None
                        else be.get("PIPELINE", "auto")),
              metrics=metrics)
    mesh = use_mesh(engine, dev)
    refuse_single_in_group(mesh)
    if mesh:
        return MeshSimulator(setup.dims, devices=mesh_devices(dev), **kw)
    return Simulator(setup.dims, device=dev, **kw)


def format_swarm(res: SwarmResult, max_depth: int) -> str:
    """The JAX CLI's swarm summary line."""
    return (f"swarm: {res.walks} walks x depth {max_depth} | "
            f"{res.steps} steps ({res.steps_per_second:,.0f} steps/s, "
            f"{res.walks_per_second:,.0f} walks/s) | visited "
            f"{res.visited} | traces {res.traces} | deepest "
            f"{res.diameter} | stop: {res.stop_reason} | "
            f"{res.wall_seconds:.2f}s")


def initial_states(setup: CheckSetup, seed: int = 0) -> List[PyState]:
    """The roots: ``Init``'s one state, or under ``Init <- SmokeInit`` the
    ``k^9`` smoke roots drawn from ``seed`` (``models/smoke.py``)."""
    if setup.smoke:
        return smoke.smoke_init_states(setup.dims, k=setup.smoke_k,
                                       seed=seed)
    return [init_state(setup.dims)]


def path_to_state(dims: RaftDims, target: PyState,
                  constraint: Optional[Callable] = None,
                  init_states: Optional[List[PyState]] = None,
                  config: Optional[EngineConfig] = None, device="cuda"):
    """A shortest action path from the roots to ``target``: a BFS whose
    one invariant is "not ``target``" (by fingerprint), replayed from the
    hit.  ``[(grid index, PyState)]`` root first (-1 for the root);
    raises if ``target`` is out of reach within the constraint.  The
    search runs the v3 plan: the invariant has no device code in the v4
    front."""
    fingerprint = build_fingerprint(dims, device)
    thi, tlo = (int(x[0]) for x in fingerprint(
        stack_states([encode_state(target, dims)], device)))
    roots = init_states or [init_state(dims)]
    if target in roots:
        return [(-1, target)]

    def not_target(st):
        h, l = fingerprint(st)
        return ~((h == thi) & (l == tlo))

    # Its own trace whatever the caller's config, and reachability only:
    # a dead end on the way must not stop the search.
    cfg = dataclasses.replace(config or EngineConfig(), record_trace=True,
                              check_deadlock=False, pipeline="v3")
    eng = BFSEngine(dims, invariants={"__NotTarget": not_target},
                    constraint=constraint, config=cfg, device=device)
    res = eng.run(roots)
    if res.violation is None:
        raise ValueError(
            f"target state unreachable within the explored space "
            f"({res.distinct} states, stop: {res.stop_reason})")
    if res.violation.state != target:
        raise RuntimeError("fingerprint collision: the state found differs "
                           "from the target")
    return eng.replay(res.violation.fingerprint)


def run_check(cfg_path: str, engine_config: Optional[EngineConfig] = None,
              device=None, resume=None, seed: int = 0, engine_cls=None,
              devices=None) -> EngineResult:
    """Parse the cfg, build the engine, run it (from the cfg's initial
    states, the smoke roots drawn from ``seed``, or from ``resume``: a
    snapshot's path or a ``Checkpoint``); the engine rides on the result
    as ``res.engine`` (for ``replay``), its graphs and run buffers given
    back (``release``): a one-shot check keeps nothing warm."""
    setup = load_config(cfg_path)
    engine = make_engine(setup, engine_config, device=device,
                         engine_cls=engine_cls, devices=devices)
    if resume is None:
        res = engine.run(initial_states(setup, seed=seed))
    else:
        res = engine.run(resume=resume)
    engine.release()
    res.engine = engine
    return res


def format_result(res: EngineResult) -> str:
    lines = [
        f"distinct states    {res.distinct}",
        f"states generated   {res.generated}",
        f"diameter           {res.diameter}",
        f"levels             {res.levels}",
        f"stop reason        {res.stop_reason}",
        f"wall seconds       {res.wall_seconds:.2f}",
        f"states/sec         {res.states_per_second:.0f}",
    ]
    if res.report:
        col = res.report["collision"]
        lines.append(
            f"fp collision prob  {col['calculated']:.2e} calculated "
            f"(optimistic); {col['observed_dual_key']} observed")
        peak = res.report.get("frontier_peak")
        if peak:
            lines.append(f"widest level       {peak['level']} "
                         f"({peak['frontier']:,} states)")
    lines += [
        f"device             {res.device}",
        f"pipeline           {res.pipeline} (" + " ".join(
            f"{s}={impl}" for s, impl in res.fused_stages.items()) + ")",
    ]
    if res.action_counts:
        lines.append("generated by action family:")
        for name, c in sorted(res.action_counts.items(),
                              key=lambda kv: -kv[1]):
            lines.append(f"  {name:22s} {c}")
    if res.por_instances:
        lines.append(f"POR                {res.por_instances} certified "
                     f"instances, {sum(res.action_pruned.values())} "
                     "enabled lanes pruned")
    if res.growth_stalls:
        lines.append("seen-set growths   " + ", ".join(
            f"{c}@{s}s" for c, s in res.growth_stalls))
    if res.violation is not None:
        lines.append(f"VIOLATION          {res.violation.invariant} "
                     f"(fp {res.violation.fingerprint:#018x})")
    if res.deadlock is not None:
        lines.append("DEADLOCK reached")
    return "\n".join(lines)
