"""Checkpoint and resume: level-boundary snapshots of a BFS run.

The BFS is level-synchronous, so between two levels the whole engine
state is

    (frontier rows, seen-set keys, counters, trace records, trace roots)

and all of it is flat numpy arrays on the host.  One compressed ``.npz``
per snapshot, ``level_<diameter>.npz``, written atomically (tmp + fsync +
rename), so a crash during a write never damages the newest good
snapshot.

This is the JAX package's ``engine/checkpoint.py`` format, version 4,
array for array and key for key (seen keys lex-sorted ``(hi, lo)`` uint32
pairs as ``ops/fpset.py to_host_keys`` gives them), so a snapshot written
by either package is read by the other, ``RaftDims`` and ``ReconfigDims``
snapshots alike (the metadata names the dims class).  What the port
leaves out: the fault-injection hooks.  The piece files a
multi-controller mesh run writes (``piece_path``:
``level_00012.p0of2.npz``, ...; ``parallel/mesh.py`` under a process
group) load and merge here, so such a run resumes on one card or on any
number of controllers.  ``latest`` and ``gc`` count a piece group only
when every piece is there and the pieces agree.

``roots`` is a pickle, as in the JAX package: load only snapshots that
this program or the JAX package wrote.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import pickle
import re
from typing import Dict, Optional, Tuple

import numpy as np

from ..models.dims import RaftDims
from ..models.pystate import PyState
from ..models.reconfig import ReconfigDims
from ..models.schema import state_width

FORMAT_VERSION = 4

_PIECE_RE = re.compile(r"^(level_\d+)\.p(\d+)of(\d+)\.npz$")
_SNAP_FILE_RE = re.compile(r"^level_(\d+)(?:\.p\d+of\d+)?\.npz(?:\.tmp)?$")
_JAX_PYSTATE = "raft_tla_tpu.models.pystate"


@dataclasses.dataclass
class Checkpoint:
    """Host-side image of a BFS engine paused at a level boundary."""

    dims: RaftDims
    frontier: np.ndarray           # [cur_count, state_width] uint8 rows
    seen_hi: np.ndarray            # [size] uint32, lex-sorted with seen_lo
    seen_lo: np.ndarray            # [size] uint32
    distinct: int
    generated: int
    diameter: int
    levels: Tuple[int, ...]
    action_counts: Dict[str, int]  # {} in snapshots older than the field
    wall_seconds: float            # checking time before the snapshot
    trace_fps: np.ndarray          # [T] uint64
    trace_parents: np.ndarray      # [T] uint64
    trace_actions: np.ndarray      # [T] int32
    roots: Dict[int, PyState]


# The dims classes a snapshot may name: an allowlist, not pickle, since the
# class name comes from the snapshot's JSON metadata.
DIMS_CLASSES = {"RaftDims": RaftDims, "ReconfigDims": ReconfigDims}


def check_dims_checkpointable(dims) -> None:
    """Raise when the engine is built, not at the first snapshot, if
    ``dims`` could not be saved and restored."""
    name = type(dims).__name__
    if DIMS_CLASSES.get(name) is not type(dims):
        raise TypeError(
            f"dims class {name!r} is not checkpoint-restorable; add it to "
            "engine/checkpoint.DIMS_CLASSES or run without checkpoint_dir")


class _RootsPickler(pickle._Pickler):
    """Names ``PyState`` by the JAX package's module path, without
    importing it, so ``roots`` unpickles in either package
    (``_RootsUnpickler`` maps the name back here).  The pure-Python
    pickler, because only it lets a class be written under another
    module's name; roots are few."""

    def save_global(self, obj, name=None):
        if obj is PyState:
            self.write(pickle.GLOBAL + _JAX_PYSTATE.encode() + b"\nPyState\n")
            self.memoize(obj)
        else:
            super().save_global(obj, name)


class _RootsUnpickler(pickle.Unpickler):
    """Resolves nothing but ``PyState`` (of either package) and the
    builtin ``frozenset`` its messages field is made of."""

    def find_class(self, module, name):
        if name == "PyState" and module in (_JAX_PYSTATE, PyState.__module__):
            return PyState
        if (module, name) == ("builtins", "frozenset"):
            return frozenset
        raise pickle.UnpicklingError(
            f"checkpoint roots hold {module}.{name}, not a PyState")


def _dump_roots(roots: Dict[int, PyState]) -> bytes:
    buf = io.BytesIO()
    _RootsPickler(buf, protocol=2, fix_imports=False).dump(dict(roots))
    return buf.getvalue()


def save(path: str, ckpt: Checkpoint) -> None:
    """Atomically write ``ckpt`` to ``path`` (a ``.npz`` file)."""
    check_dims_checkpointable(ckpt.dims)
    meta = {
        "version": FORMAT_VERSION,
        "dims_class": type(ckpt.dims).__name__,
        "state_width": state_width(ckpt.dims),
        "dims": dataclasses.asdict(ckpt.dims),
        "distinct": ckpt.distinct,
        "generated": ckpt.generated,
        "diameter": ckpt.diameter,
        "levels": list(ckpt.levels),
        "action_counts": dict(ckpt.action_counts),
        "wall_seconds": ckpt.wall_seconds,
    }
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f,
            meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
            frontier=np.ascontiguousarray(ckpt.frontier).astype(
                np.uint8, casting="safe"),
            seen_hi=np.ascontiguousarray(ckpt.seen_hi, np.uint32),
            seen_lo=np.ascontiguousarray(ckpt.seen_lo, np.uint32),
            trace_fps=np.ascontiguousarray(ckpt.trace_fps, np.uint64),
            trace_parents=np.ascontiguousarray(ckpt.trace_parents, np.uint64),
            trace_actions=np.ascontiguousarray(ckpt.trace_actions, np.int32),
            roots=np.frombuffer(_dump_roots(ckpt.roots), np.uint8))
        f.flush()
        os.fsync(f.fileno())     # the rename must never land a torn file
    os.replace(tmp, path)
    dfd = os.open(folder, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def piece_path(checkpoint_dir: str, diameter: int, pid: int,
               nproc: int) -> str:
    """Controller ``pid`` of ``nproc``'s piece of the level's snapshot."""
    return os.path.join(checkpoint_dir,
                        f"level_{diameter:05d}.p{pid}of{nproc}.npz")


def _merge(pieces) -> Checkpoint:
    base = pieces[0]
    for p in pieces[1:]:
        if p.dims != base.dims:
            raise ValueError("checkpoint pieces disagree on dims")
        # Every piece of one generation carries the same counters; a
        # mismatch means the group mixes pieces of two runs.
        if (p.distinct, p.generated, p.diameter, p.levels) != \
                (base.distinct, base.generated, base.diameter, base.levels):
            raise ValueError(
                "checkpoint piece group mixes run generations "
                f"(counters disagree: {p.diameter}/{p.distinct} vs "
                f"{base.diameter}/{base.distinct}); delete the stale "
                "pieces or resume an older complete snapshot")
    hi = np.concatenate([p.seen_hi for p in pieces])
    lo = np.concatenate([p.seen_lo for p in pieces])
    order = np.lexsort((lo, hi))
    return dataclasses.replace(
        base,
        frontier=np.concatenate([p.frontier for p in pieces]),
        seen_hi=hi[order], seen_lo=lo[order],
        trace_fps=np.concatenate([p.trace_fps for p in pieces]),
        trace_parents=np.concatenate([p.trace_parents for p in pieces]),
        trace_actions=np.concatenate([p.trace_actions for p in pieces]),
        roots={k: v for p in pieces for k, v in p.roots.items()})


def load(path: str) -> Checkpoint:
    """The snapshot at ``path``; a piece path loads its whole group."""
    m = _PIECE_RE.match(os.path.basename(path))
    if m:
        base, nproc = m.group(1), int(m.group(3))
        d = os.path.dirname(os.path.abspath(path))
        paths = [os.path.join(d, f"{base}.p{i}of{nproc}.npz")
                 for i in range(nproc)]
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(
                f"incomplete checkpoint piece group: missing {missing}")
        return _merge([_load_one(p) for p in paths])
    return _load_one(path)


def _load_one(path: str) -> Checkpoint:
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["version"] not in (3, FORMAT_VERSION):
            raise ValueError(
                f"checkpoint format v{meta['version']} not in "
                f"(v3, v{FORMAT_VERSION})")
        fields = set(f.name for f in dataclasses.fields(RaftDims))
        cls_name = meta.get("dims_class")
        if cls_name is None:
            # v3 metadata does not record the class.
            extra = set(meta["dims"]) - fields
            if extra:
                raise ValueError(
                    "v3 checkpoint was written by a dims VARIANT "
                    f"(unexpected dims keys {sorted(extra)}); re-run the "
                    "variant from scratch to produce a v4 snapshot")
            cls_name = "RaftDims"
        if cls_name not in DIMS_CLASSES:
            raise ValueError(
                f"checkpoint dims class {cls_name!r} is not in this "
                f"build's registry ({sorted(DIMS_CLASSES)}); it was written "
                "by a build with more dims variants")
        cls = DIMS_CLASSES[cls_name]
        dims = cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in meta["dims"].items()})
        if "state_width" in meta and state_width(dims) != meta["state_width"]:
            raise ValueError(
                f"checkpoint row width {meta['state_width']} != "
                f"{state_width(dims)} for {cls_name}: the packed layout "
                "changed since this snapshot was written")
        return Checkpoint(
            dims=dims,
            frontier=z["frontier"],
            seen_hi=z["seen_hi"],
            seen_lo=z["seen_lo"],
            distinct=meta["distinct"],
            generated=meta["generated"],
            diameter=meta["diameter"],
            levels=tuple(meta["levels"]),
            action_counts=dict(meta.get("action_counts", {})),
            wall_seconds=float(meta.get("wall_seconds", 0.0)),
            trace_fps=z["trace_fps"],
            trace_parents=z["trace_parents"],
            trace_actions=z["trace_actions"],
            roots=_RootsUnpickler(io.BytesIO(bytes(z["roots"]))).load())


def _list_snapshots(checkpoint_dir: str):
    """``[(level, [names])]`` of single snapshots and COMPLETE piece
    groups in ``checkpoint_dir`` (no health check)."""
    singles, groups = [], {}
    for name in os.listdir(checkpoint_dir):
        m = _PIECE_RE.match(name)
        if m:
            lvl = int(m.group(1)[len("level_"):])
            groups.setdefault((lvl, int(m.group(3))), []).append(name)
            continue
        if name.startswith("level_") and name.endswith(".npz"):
            try:
                singles.append((int(name[len("level_"):-len(".npz")]),
                                [name]))
            except ValueError:
                continue
    return singles + [(lvl, sorted(names))
                      for (lvl, nproc), names in groups.items()
                      if len(names) == nproc]


def _group_is_intact(checkpoint_dir: str, names) -> bool:
    """Every file readable, and one run generation (equal counters)."""
    counters = set()
    try:
        for name in names:
            with np.load(os.path.join(checkpoint_dir, name)) as z:
                meta = json.loads(bytes(z["meta"]).decode())
            counters.add((meta["distinct"], meta["generated"],
                          meta["diameter"], tuple(meta["levels"])))
    except Exception:       # any unreadable file is a torn snapshot
        return False
    return len(counters) == 1


def latest(checkpoint_dir: str) -> Optional[str]:
    """Path of the newest resumable snapshot in ``checkpoint_dir`` (a
    single file, or any piece of a complete group), skipping unreadable
    files, incomplete groups and groups of mixed generations; None when
    there is none."""
    if not os.path.isdir(checkpoint_dir):
        return None
    for _lvl, names in sorted(_list_snapshots(checkpoint_dir),
                              reverse=True):
        if _group_is_intact(checkpoint_dir, names):
            return os.path.join(checkpoint_dir, names[0])
    return None


def gc(checkpoint_dir: str, keep: Optional[int]) -> int:
    """Retention: once ``keep`` intact snapshots exist, delete every
    snapshot file (good, torn, ``.tmp`` leftovers alike) strictly older
    than the oldest kept one.  Torn entries never count toward ``keep``;
    None, 0 or a negative ``keep`` keeps all.  Returns the files removed."""
    if not keep or keep < 0 or not os.path.isdir(checkpoint_dir):
        return 0
    intact = [lvl for lvl, names in sorted(_list_snapshots(checkpoint_dir),
                                           reverse=True)
              if _group_is_intact(checkpoint_dir, names)]
    if len(intact) < keep:
        return 0
    cutoff = intact[keep - 1]
    removed = 0
    for name in os.listdir(checkpoint_dir):
        m = _SNAP_FILE_RE.match(name)
        if m is None or int(m.group(1)) >= cutoff:
            continue
        try:
            os.unlink(os.path.join(checkpoint_dir, name))
            removed += 1
        except OSError:
            pass
    return removed
