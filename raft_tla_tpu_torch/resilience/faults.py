"""Deterministic fault injection — named sites, a parsed plan, fire-once.

The JAX package's ``resilience/faults.py``, kept as the port's own copy:
the same grammar, sites, fire-once markers and exit code, with the
sites threaded through the port's engines.  ``oom`` raises
:class:`SimulatedResourceExhausted` (its message carries
``RESOURCE_EXHAUSTED``, as the JAX one does), and
:func:`is_resource_exhausted` accepts it and
``torch.cuda.OutOfMemoryError``.

Grammar (``--fault-plan`` flag / ``FAULT_PLAN`` env)::

    plan  := fault ("," fault)*
    fault := site ["@" param (";" param)*]
    param := key "=" value          # int values parsed as int

    ckpt_torn_write@level=3,kill@level=5,oom@grow=1

Sites and their actions:

========================  ====================================================
``kill``                  die mid-run (``engine/bfs.py`` /
                          ``parallel/mesh.py`` chunk loops; params:
                          ``level``, ``chunk``)
``ckpt_torn_write``       die between the checkpoint tmp-write and its
                          rename (``engine/checkpoint.save``; param
                          ``level``) — the torn ``.tmp`` file stays behind
``ckpt_piece_missing``    skip writing this snapshot/piece entirely
                          (``engine/checkpoint.save``; params ``level``,
                          ``piece``) — simulates a controller that died
                          before its piece landed
``oom``                   raise a simulated ``RESOURCE_EXHAUSTED``
                          (chunk dispatch: params ``level``, ``chunk``;
                          seen-set growth: param ``grow``)
``spill_write``           raise ``OSError`` from the disk spill write
                          (``engine/spillpool.py``)
``trace_piece_delay``     sleep ``seconds`` before writing this
                          controller's trace piece (``parallel/mesh.py``)
========================  ====================================================

A fault fires when every one of its params is present in the call site's
context with an equal value, and each fault fires AT MOST ONCE — fired
markers persist in ``state_dir`` (``FAULT_STATE_DIR`` env) so a
supervisor-restarted child does not re-kill itself at the same level
forever.  Without a ``state_dir`` the markers are process-local (fine for
in-process tests, wrong across restarts — the supervisor always sets one).

``hard`` selects how die-class sites die: ``os._exit(EXIT_FAULT)`` (the
real crash, for subprocess harnesses; default when installed from the
environment) or :class:`FaultInjected` (for in-process unit tests — a
raise still leaves exactly the same file state behind).

Zero overhead when no plan is installed: sites guard on the module-level
``ACTIVE`` bool and never call in here.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Dict, List, Optional

#: Exit code of a hard injected crash — distinct from the engine's real
#: exit codes (0 ok, 1 violation/deadlock, 2 usage) so the supervisor and
#: the chaos harness can tell an injected death from a genuine bug.
EXIT_FAULT = 86


class FaultInjected(RuntimeError):
    """Soft-mode stand-in for an injected process death."""


class SimulatedResourceExhausted(RuntimeError):
    """Injected stand-in for running out of device memory (the message
    carries ``RESOURCE_EXHAUSTED``, as the JAX package's does)."""


def is_resource_exhausted(exc: BaseException) -> bool:
    """True for the caching allocator's ``torch.cuda.OutOfMemoryError``,
    the injected stand-in, or an error naming ``RESOURCE_EXHAUSTED`` (the
    JAX package's test)."""
    import torch
    return (isinstance(exc, (SimulatedResourceExhausted,
                             torch.cuda.OutOfMemoryError))
            or "RESOURCE_EXHAUSTED" in str(exc))


@dataclasses.dataclass
class Fault:
    site: str
    params: Dict[str, object]
    idx: int                      # position in the plan: the marker key

    @property
    def marker(self) -> str:
        return f"fired_{self.idx:02d}_{self.site}"

    def __str__(self) -> str:
        ps = ";".join(f"{k}={v}" for k, v in self.params.items())
        return f"{self.site}@{ps}" if ps else self.site


_SITE_RE = re.compile(r"^[a-z][a-z0-9_]*$")
KNOWN_SITES = ("kill", "ckpt_torn_write", "ckpt_piece_missing", "oom",
               "spill_write", "trace_piece_delay")
#: Plan params that configure the fault's ACTION rather than select when
#: it fires — match() must not require them in the call site's context
#: (``trace_piece_delay@seconds=2`` would otherwise never fire: no site
#: passes ``seconds``).
ACTION_PARAMS = {"trace_piece_delay": {"seconds"}}


class FaultPlan:
    """Parsed plan + fired-marker store."""

    def __init__(self, faults: List[Fault], state_dir: Optional[str] = None,
                 hard: bool = True):
        self.faults = faults
        self.state_dir = state_dir
        self.hard = hard
        self._fired_local = set()
        if state_dir is not None:
            os.makedirs(state_dir, exist_ok=True)

    @classmethod
    def parse(cls, text: str, state_dir: Optional[str] = None,
              hard: bool = True) -> "FaultPlan":
        faults = []
        for idx, part in enumerate(p for p in text.split(",") if p.strip()):
            part = part.strip()
            site, _, rest = part.partition("@")
            if not _SITE_RE.match(site) or site not in KNOWN_SITES:
                raise ValueError(
                    f"unknown fault site {site!r} in {part!r}; known: "
                    f"{KNOWN_SITES} (grammar: site@key=val;key=val,...)")
            params: Dict[str, object] = {}
            for kv in (p for p in rest.split(";") if p):
                key, sep, val = kv.partition("=")
                if not sep:
                    raise ValueError(
                        f"fault param {kv!r} in {part!r} is not key=value")
                try:
                    params[key.strip()] = int(val)
                except ValueError:
                    params[key.strip()] = val.strip()
            faults.append(Fault(site=site, params=params, idx=idx))
        if not faults:
            raise ValueError(f"empty fault plan {text!r}")
        return cls(faults, state_dir=state_dir, hard=hard)

    # -- fired markers --------------------------------------------------
    def _has_fired(self, fault: Fault) -> bool:
        if fault.marker in self._fired_local:
            return True
        return (self.state_dir is not None
                and os.path.exists(os.path.join(self.state_dir,
                                                fault.marker)))

    def _mark_fired(self, fault: Fault) -> None:
        """Persist BEFORE acting: a die-class fault must never re-fire on
        the supervised restart (the marker, not the death, is the record)."""
        self._fired_local.add(fault.marker)
        if self.state_dir is not None:
            path = os.path.join(self.state_dir, fault.marker)
            with open(path, "w") as f:
                f.write(f"{fault}\n{time.time()}\n")
                f.flush()
                os.fsync(f.fileno())

    # -- firing ---------------------------------------------------------
    def match(self, site: str, ctx: Dict[str, object]) -> Optional[Fault]:
        skip = ACTION_PARAMS.get(site, ())
        for fault in self.faults:
            if fault.site != site or self._has_fired(fault):
                continue
            if all(k in ctx and ctx[k] == v
                   for k, v in fault.params.items() if k not in skip):
                return fault
        return None

    def _die(self, fault: Fault) -> None:
        if self.hard:
            # Flight-recorder postmortem first (obs/flight.py): a real
            # SIGKILL would get nothing, but the POINT of the injected
            # kill is to rehearse crash recovery — and the recorder's
            # contract is that crashes yield their last N seconds of
            # telemetry.  Best-effort: the dump never blocks the death,
            # and it reads host records only, so device work still
            # queued is left to die with the process (no synchronize).
            try:
                from ..obs.flight import RECORDER
                RECORDER.dump(f"fault_kill: {fault}")
            except Exception:
                pass
            # Real crash semantics: no atexit hooks, no finally blocks —
            # exactly what a SIGKILL / machine loss leaves behind.
            os._exit(EXIT_FAULT)
        raise FaultInjected(f"injected fault: {fault}")

    def fire(self, site: str, **ctx) -> bool:
        """Fire the first matching un-fired fault for ``site``.  Die-class
        and raise-class sites act here; returns True for sites whose
        action is the CALLER's (``ckpt_piece_missing`` => skip the write),
        False when nothing fired."""
        fault = self.match(site, ctx)
        if fault is None:
            return False
        self._mark_fired(fault)
        if site in ("kill", "ckpt_torn_write"):
            self._die(fault)
        elif site == "oom":
            raise SimulatedResourceExhausted(
                f"RESOURCE_EXHAUSTED: injected fault: {fault}")
        elif site == "spill_write":
            raise OSError(f"injected spill write failure: {fault}")
        elif site == "trace_piece_delay":
            time.sleep(float(fault.params.get("seconds", 1)))
        return True


# -- module-level singleton (the injection-site interface) ---------------
#: Sites guard with ``if faults.ACTIVE: faults.fire(...)`` — one global
#: bool read is the entire cost of an un-faulted run.
ACTIVE = False
_PLAN: Optional[FaultPlan] = None


def install(text: str, state_dir: Optional[str] = None,
            hard: bool = True) -> FaultPlan:
    global ACTIVE, _PLAN
    _PLAN = FaultPlan.parse(text, state_dir=state_dir, hard=hard)
    ACTIVE = True
    return _PLAN


def install_from_env(default_state_dir: Optional[str] = None,
                     text: Optional[str] = None) -> bool:
    """Install ``text`` (the ``--fault-plan`` flag) or, when None, the
    ``FAULT_PLAN`` env — either way with the env-resolved marker dir
    (``FAULT_STATE_DIR``, falling back to ``default_state_dir``) and
    hard mode unless ``FAULT_HARD=0``.  Returns True when a plan was
    installed.  The one resolution point for flag- and env-installed
    plans, so supervised children (which inherit the env) and direct
    CLI invocations can never diverge on state-dir/hard semantics."""
    text = text or os.environ.get("FAULT_PLAN")
    if not text:
        return False
    install(text,
            state_dir=os.environ.get("FAULT_STATE_DIR",
                                     default_state_dir),
            hard=os.environ.get("FAULT_HARD", "1") != "0")
    return True


def clear() -> None:
    global ACTIVE, _PLAN
    ACTIVE = False
    _PLAN = None


def fire(site: str, **ctx) -> bool:
    if _PLAN is None:
        return False
    return _PLAN.fire(site, **ctx)
