"""TLC ``.cfg`` parsing and model resolution.

The grammar subset the reference harness configs use: CONSTANT(S) blocks
(``name = modelvalue``, ``name = {set}``, ``name = number``,
``name <- definition``), SPECIFICATION, INVARIANT(S), CONSTRAINT(S),
CHECK_DEADLOCK and ``\\*`` comments.  The companion ``.tla`` module next
to the cfg is scanned for model-value set definitions and for StopAfter
budgets (``TLCSet("exit", TLCGet("diameter") > n)``).

Engine parameters ride in the cfg as ``\\* TPU: KEY = VALUE`` comment
directives, so an annotated cfg still runs under stock TLC.  Precedence:
caller > cfg directive > built-in default.

This is the JAX package's ``utils/cfg.py``, kept as the port's own copy:
``TargetConfigs`` selects the reconfiguration variant
(``models/reconfig.py`` ``ReconfigDims``), and ``Init <- SmokeInit`` sets
``smoke`` (roots from ``models/smoke.py``).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional, Tuple

from ..models.dims import RaftDims
from ..models.invariants import Bounds
from ..models.reconfig import ReconfigDims

_KEYWORDS = {
    "CONSTANT", "CONSTANTS", "SPECIFICATION", "INVARIANT", "INVARIANTS",
    "CONSTRAINT", "CONSTRAINTS", "ACTION_CONSTRAINT", "INIT", "NEXT",
    "SYMMETRY", "VIEW", "CHECK_DEADLOCK", "PROPERTY", "PROPERTIES",
}

_BACKEND_KEYS = {
    "BATCH", "QUEUE_CAPACITY", "SEEN_CAPACITY", "N_MSG_SLOTS", "MAX_LOG",
    "PLATFORM", "CHECKPOINT_DIR", "CHECKPOINT_EVERY", "CHECKPOINT_INTERVAL",
    "SPILL_DIR", "TRACE_DIR", "PROGRESS_SECONDS", "EVENTS_OUT",
    "KEEP_CHECKPOINTS", "TRACE_OUT", "PROFILE_CHUNKS", "POR", "POR_TABLE",
    "PIPELINE", "XLA_PROFILE", "METRICS_PORT", "REPORT",
    "COUNTEREXAMPLE_DIR", "HISTORY", "PERF", "MODE", "WALKS",
}

EXIT_COUNTERS = ("duration", "diameter", "distinct", "generated", "queue")
_TLCSET_EXIT = r'TLCSet\(\s*"exit"\s*,\s*TLCGet\("(\w+)"\)\s*>\s*(\d+)\s*\)'


@dataclasses.dataclass
class ParsedCfg:
    assignments: Dict[str, object] = dataclasses.field(default_factory=dict)
    substitutions: Dict[str, str] = dataclasses.field(default_factory=dict)
    specification: Optional[str] = None
    init: Optional[str] = None
    next: Optional[str] = None
    invariants: List[str] = dataclasses.field(default_factory=list)
    constraints: List[str] = dataclasses.field(default_factory=list)
    action_constraints: List[str] = dataclasses.field(default_factory=list)
    properties: List[str] = dataclasses.field(default_factory=list)
    symmetry: Optional[str] = None
    view: Optional[str] = None
    check_deadlock: bool = True
    backend: Dict[str, object] = dataclasses.field(default_factory=dict)


def _tokenize(text: str) -> List[str]:
    text = re.sub(r"\\\*[^\n]*", " ", text)
    text = re.sub(r"\(\*.*?\*\)", " ", text, flags=re.S)
    return re.findall(r"<-|=|\{|\}|,|[^\s{},=]+", text)


def parse_backend_directives(text: str) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for m in re.finditer(r"^\s*\\\*\s*TPU:\s*(\w+)\s*=\s*(\S+)",
                         text, flags=re.M | re.I):
        key, raw = m.group(1).upper(), m.group(2)
        if key not in _BACKEND_KEYS:
            raise ValueError(f"unknown TPU backend key {key!r}; "
                             f"recognized: {sorted(_BACKEND_KEYS)}")
        if re.fullmatch(r"-?\d+", raw):
            out[key] = int(raw)
        elif re.fullmatch(r"-?\d+\.\d*", raw):
            out[key] = float(raw)
        elif raw.upper() in ("TRUE", "FALSE"):
            out[key] = raw.upper() == "TRUE"
        else:
            out[key] = raw
    return out


def parse_cfg(text: str) -> ParsedCfg:
    toks = _tokenize(text)
    cfg = ParsedCfg()
    cfg.backend = parse_backend_directives(text)
    i, n = 0, len(toks)

    def parse_value(j: int) -> Tuple[object, int]:
        if toks[j] == "{":
            vals, j = [], j + 1
            while toks[j] != "}":
                if toks[j] != ",":
                    vals.append(toks[j])
                j += 1
            return tuple(vals), j + 1
        v = toks[j]
        if re.fullmatch(r"-?\d+", v):
            return int(v), j + 1
        if v in ("TRUE", "FALSE"):
            return v == "TRUE", j + 1
        return v, j + 1

    mode = None
    while i < n:
        t = toks[i]
        if t in _KEYWORDS:
            mode = t
            i += 1
            if t == "CHECK_DEADLOCK":
                cfg.check_deadlock = toks[i] == "TRUE"
                i += 1
                mode = None
            continue
        if mode in ("CONSTANT", "CONSTANTS", "INIT", "NEXT"):
            name = t
            if i + 1 < n and toks[i + 1] == "=":
                val, i = parse_value(i + 2)
                cfg.assignments[name] = val
            elif i + 1 < n and toks[i + 1] == "<-":
                cfg.substitutions[name] = toks[i + 2]
                i += 3
            elif mode in ("INIT", "NEXT"):
                setattr(cfg, mode.lower(), name)
                i += 1
                mode = None
            else:
                i += 1
        elif mode == "SPECIFICATION":
            cfg.specification = t
            i += 1
            mode = None
        elif mode in ("INVARIANT", "INVARIANTS"):
            cfg.invariants.append(t)
            i += 1
        elif mode in ("CONSTRAINT", "CONSTRAINTS"):
            cfg.constraints.append(t)
            i += 1
        elif mode == "ACTION_CONSTRAINT":
            cfg.action_constraints.append(t)
            i += 1
        elif mode in ("PROPERTY", "PROPERTIES"):
            cfg.properties.append(t)
            i += 1
        elif mode in ("SYMMETRY", "VIEW"):
            setattr(cfg, mode.lower(), t)
            i += 1
            mode = None
        else:
            i += 1
    return cfg


def scan_module_definitions(text: str) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for m in re.finditer(
            r"^\s*(\w+)\s*==\s*\n?\s*(\{[^}]*\}|-?\d+)\s*$",
            re.sub(r"\\\*[^\n]*", "", text), flags=re.M):
        name, body = m.group(1), m.group(2).strip()
        if body.startswith("{"):
            out[name] = tuple(x.strip() for x in body[1:-1].split(",")
                              if x.strip())
        else:
            out[name] = int(body)
    return out


@dataclasses.dataclass(frozen=True)
class ExitOp:
    conds: Tuple[Tuple[str, float], ...]
    pure: bool


def scan_exit_operators(text: str) -> Dict[str, ExitOp]:
    out: Dict[str, ExitOp] = {}
    clean = re.sub(r"\(\*.*?\*\)", "", text, flags=re.S)
    clean = re.sub(r"\\\*[^\n]*", "", clean)
    defs = list(re.finditer(r"^\s*(\w+)\s*(\([^)]*\))?\s*==", clean,
                            flags=re.M))
    for k, m in enumerate(defs):
        end = defs[k + 1].start() if k + 1 < len(defs) else len(clean)
        body = clean[m.end():end]
        conds = re.findall(_TLCSET_EXIT, body)
        if not conds:
            continue
        residue = re.sub(_TLCSET_EXIT, "", body)
        out[m.group(1)] = ExitOp(
            conds=tuple((c, float(v)) for c, v in conds),
            pure=re.fullmatch(r"[\s/\\=-]*", residue) is not None)
    return out


@dataclasses.dataclass
class CheckSetup:
    """Everything the engine needs, resolved from one cfg."""

    dims: RaftDims
    bounds: Bounds
    invariants: List[str]
    constraints: List[str]
    check_deadlock: bool
    smoke: bool = False
    smoke_k: int = 2
    max_seconds: Optional[float] = None
    max_diameter: Optional[int] = None
    exit_conditions: Tuple[Tuple[str, float], ...] = ()
    server_names: Tuple[str, ...] = ()
    value_names: Tuple[str, ...] = ()
    cfg: Optional[ParsedCfg] = None
    backend: Dict[str, object] = dataclasses.field(default_factory=dict)


def load_config(cfg_path: str, max_log: Optional[int] = None,
                n_msg_slots: Optional[int] = None) -> CheckSetup:
    """Parse cfg + companion module, intern model values, derive dims."""
    with open(cfg_path) as f:
        cfg = parse_cfg(f.read())
    if max_log is None:
        max_log = cfg.backend.get("MAX_LOG")
    if n_msg_slots is None:
        n_msg_slots = cfg.backend.get("N_MSG_SLOTS", 32)
    moddefs: Dict[str, object] = {}
    exit_ops: Dict[str, ExitOp] = {}
    mod_dir = os.path.dirname(os.path.abspath(cfg_path))
    pending = [os.path.splitext(os.path.basename(cfg_path))[0]]
    seen_mods = set()
    while pending:
        mod = pending.pop()
        if mod in seen_mods:
            continue
        seen_mods.add(mod)
        cand = os.path.join(mod_dir, mod + ".tla")
        if not os.path.exists(cand):
            continue
        with open(cand) as f:
            text = f.read()
        moddefs.update(scan_module_definitions(text))
        for name, op in scan_exit_operators(text).items():
            exit_ops.setdefault(name, op)
        ext = re.search(r"^\s*EXTENDS\s+([^\n]+)", text, flags=re.M)
        if ext:
            pending.extend(x.strip() for x in ext.group(1).split(","))

    def resolve_set(name: str) -> Tuple[str, ...]:
        if name in cfg.assignments and isinstance(cfg.assignments[name],
                                                  tuple):
            return cfg.assignments[name]
        if name in cfg.substitutions:
            target = cfg.substitutions[name]
            if target in moddefs and isinstance(moddefs[target], tuple):
                return moddefs[target]
            raise ValueError(f"cannot resolve {name} <- {target}: definition "
                             f"not found in companion module of {cfg_path}")
        raise ValueError(f"no binding for constant {name} in {cfg_path}")

    servers = resolve_set("Server")
    values = resolve_set("Value")

    def int_const(name: str) -> Optional[int]:
        v = cfg.assignments.get(name)
        return v if isinstance(v, int) else None

    bounds = Bounds(max_term=int_const("MaxTerm"),
                    max_log_len=int_const("MaxLogLen"),
                    max_msg_count=int_const("MaxMsgCount"),
                    max_in_flight=int_const("MaxInFlight"))
    if cfg.action_constraints:
        raise NotImplementedError(
            f"ACTION_CONSTRAINT {cfg.action_constraints} not supported")
    if cfg.symmetry is not None:
        raise NotImplementedError(f"SYMMETRY {cfg.symmetry} not supported: "
                                  "it would change distinct-state counts")
    if cfg.view is not None:
        raise NotImplementedError(f"VIEW {cfg.view} not supported")
    if cfg.properties:
        raise NotImplementedError(
            f"PROPERTY {cfg.properties} not supported: only INVARIANT "
            "(safety) properties are checked")
    smoke = (cfg.substitutions.get("Init") == "SmokeInit"
             or cfg.init == "SmokeInit")
    smoke_k = moddefs.get("k", 2) if smoke else 2
    if max_log is None:
        if bounds.max_log_len is not None:
            # Expanded states have len <= MaxLogLen; a successor can exceed
            # it by one appended entry (counted, never expanded).
            max_log = bounds.max_log_len + 1
        elif smoke:
            max_log = 12
        else:
            max_log = 8

    max_seconds = max_diameter = None
    exit_conditions: List[Tuple[str, float]] = []
    budget_names = [c for c in cfg.constraints if c in exit_ops]
    for name in budget_names:
        op = exit_ops[name]
        if not op.pure:
            raise NotImplementedError(
                f"CONSTRAINT {name} mixes TLCSet exit budgets with other "
                "conjuncts")
        for counter, threshold in op.conds:
            if counter not in EXIT_COUNTERS:
                raise NotImplementedError(
                    f'TLCGet("{counter}") in CONSTRAINT {name} not supported')
            if counter == "duration":
                max_seconds = threshold if max_seconds is None \
                    else min(max_seconds, threshold)
            elif counter == "diameter":
                max_diameter = int(threshold) if max_diameter is None \
                    else min(max_diameter, int(threshold))
            else:
                exit_conditions.append((counter, threshold))

    # TargetConfigs (membership bitmasks over the interned server order)
    # selects the joint-consensus reconfiguration variant.
    if "TargetConfigs" in cfg.assignments:
        raw = cfg.assignments["TargetConfigs"]
        if not isinstance(raw, tuple):
            raw = (raw,)
        targets = tuple(sorted(int(x) for x in raw))
        dims = ReconfigDims(n_servers=len(servers), n_values=len(values),
                            max_log=max_log, n_msg_slots=n_msg_slots,
                            targets=targets)
    else:
        dims = RaftDims(n_servers=len(servers), n_values=len(values),
                        max_log=max_log, n_msg_slots=n_msg_slots)
    return CheckSetup(
        dims=dims, bounds=bounds, invariants=list(cfg.invariants),
        constraints=[c for c in cfg.constraints if c not in budget_names],
        check_deadlock=cfg.check_deadlock, smoke=smoke, smoke_k=smoke_k,
        max_seconds=max_seconds, max_diameter=max_diameter,
        exit_conditions=tuple(exit_conditions), server_names=servers,
        value_names=values, cfg=cfg, backend=dict(cfg.backend))
