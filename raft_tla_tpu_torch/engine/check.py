"""Front end: a resolved cfg -> an engine run (the ``tlc <cfg>`` path).

Invariant names resolve through ``models/invariants.py``'s registry, the
``BoundedSpace`` constraint reads MaxTerm/MaxLogLen/MaxMsgCount, and the
cfg's StopAfter budgets and ``\\* TPU:`` directives (BATCH,
QUEUE_CAPACITY, SEEN_CAPACITY, PIPELINE) seed the engine config.
Precedence: caller > cfg directive > built-in default.  Every entry
point takes ``device`` and runs on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from ..models.invariants import build_constraint, invariant_registry
from ..models.pystate import PyState, init_state
from ..utils.cfg import CheckSetup, load_config
from .bfs import BFSEngine, EngineConfig, EngineResult

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
    be = setup.backend
    return EngineConfig(
        batch=be.get("BATCH", EngineConfig.batch),
        queue_capacity=be.get("QUEUE_CAPACITY", EngineConfig.queue_capacity),
        seen_capacity=be.get("SEEN_CAPACITY", EngineConfig.seen_capacity),
        pipeline=be.get("PIPELINE", EngineConfig.pipeline))


def make_engine(setup: CheckSetup,
                engine_config: Optional[EngineConfig] = None,
                device="cuda") -> BFSEngine:
    """An engine with the cfg fallbacks applied (CHECK_DEADLOCK, StopAfter
    budgets); the caller's config is never mutated."""
    if setup.exit_conditions:
        raise NotImplementedError(
            f"TLCGet exit budgets {setup.exit_conditions} are not ported yet")
    base = engine_config or engine_config_from_backend(setup)
    cfg = dataclasses.replace(
        base,
        check_deadlock=(base.check_deadlock
                        if base.check_deadlock is not None
                        else setup.check_deadlock),
        max_seconds=(base.max_seconds if base.max_seconds is not None
                     else setup.max_seconds),
        max_diameter=(base.max_diameter if base.max_diameter is not None
                      else setup.max_diameter))
    return BFSEngine(setup.dims, invariants=resolve_invariants(setup),
                     constraint=resolve_constraint(setup), config=cfg,
                     device=device)


def initial_states(setup: CheckSetup) -> List[PyState]:
    if setup.smoke:
        raise NotImplementedError("Init <- SmokeInit is not ported yet")
    return [init_state(setup.dims)]


def run_check(cfg_path: str, engine_config: Optional[EngineConfig] = None,
              device="cuda") -> EngineResult:
    """Parse the cfg, build the engine, run it; the engine rides on the
    result as ``res.engine`` (for ``replay``)."""
    setup = load_config(cfg_path)
    engine = make_engine(setup, engine_config, device=device)
    res = engine.run(initial_states(setup))
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
        f"device             {res.device}",
        f"pipeline           {res.pipeline} (" + " ".join(
            f"{s}={impl}" for s, impl in res.fused_stages.items()) + ")",
    ]
    if res.action_counts:
        lines.append("generated by action family:")
        for name, c in sorted(res.action_counts.items(),
                              key=lambda kv: -kv[1]):
            lines.append(f"  {name:22s} {c}")
    if res.growth_stalls:
        lines.append("seen-set growths   " + ", ".join(
            f"{c}@{s}s" for c, s in res.growth_stalls))
    if res.violation is not None:
        lines.append(f"VIOLATION          {res.violation.invariant} "
                     f"(fp {res.violation.fingerprint:#018x})")
    if res.deadlock is not None:
        lines.append("DEADLOCK reached")
    return "\n".join(lines)
