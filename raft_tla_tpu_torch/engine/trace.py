"""Predecessor-trace store for counterexample reconstruction.

The engine records one ``(fingerprint, parent fingerprint, action id)``
per newly discovered state; walking the records back from a violating
fingerprint gives the chain that ``BFSEngine.replay`` re-runs.  Action id
-1 marks roots, whose full ``PyState`` is kept in ``roots``.  The JAX
package's ``PyTraceStore`` semantics (the first record of a fingerprint
wins), kept as numpy columns: a flush appends three arrays, and lookups
go through a sorted index built when the store is next read, so a run of
tens of millions of states costs 20 bytes a record and no Python object
per record.  ``NativeTraceStore`` is the JAX package's C++ hash store
(``native/trace_store.cpp``): each batch is inserted at once, and
``export`` returns the records in hash-slot order, not insertion order
(compare exports as sets).  ``make_trace_store(kind)`` picks one:
``"columnar"`` or ``"native"``; a native store that cannot be built
prints why and gives the columnar one (``store.kind`` names what runs).
"""

from __future__ import annotations

import ctypes
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.pystate import PyState


#: ``make_trace_store`` kinds.
TRACE_STORES = ("columnar", "native")


class PyTraceStore:
    """fp64 -> (parent fp64, action id)."""

    kind = "columnar"

    def __init__(self):
        self._parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._cols = None          # (fps, parents, actions), first wins
        self._order = None         # argsort of fps
        self.roots: Dict[int, PyState] = {}

    def add_batch(self, fps, parent_fps, actions):
        """Records of three equal-length columns, copied (a caller's
        buffer may be reused)."""
        if len(fps):
            self._parts.append((np.array(fps, np.uint64),
                                np.array(parent_fps, np.uint64),
                                np.array(actions, np.int32)))

    def _columns(self):
        """The records, first of each fingerprint, in insertion order."""
        if self._parts:
            cols = ([self._cols] if self._cols is not None else []) \
                + self._parts
            fps, par, act = (np.concatenate(c) for c in zip(*cols))
            _u, first = np.unique(fps, return_index=True)
            if len(first) < len(fps):
                keep = np.sort(first)
                fps, par, act = fps[keep], par[keep], act[keep]
            self._cols = (fps, par, act)
            self._order = np.argsort(fps, kind="stable")
            self._parts = []
        if self._cols is None:
            empty = np.empty(0, np.uint64)
            self._cols = (empty, empty, np.empty(0, np.int32))
            self._order = np.empty(0, np.int64)
        return self._cols

    def __len__(self) -> int:
        return len(self._columns()[0])

    def get(self, fp: int) -> Optional[Tuple[int, int]]:
        fps, par, act = self._columns()
        key = np.uint64(fp)
        i = np.searchsorted(fps, key, sorter=self._order)
        if i == len(fps) or fps[self._order[i]] != key:
            return None
        j = self._order[i]
        return int(par[j]), int(act[j])

    def export(self):
        fps, par, act = self._columns()
        return fps.copy(), par.copy(), act.copy()

    def chain(self, fp: int) -> List[Tuple[int, int]]:
        """Walk back to a root: ``[(fp, action into fp)]`` root first."""
        out = []
        seen = set()
        while fp not in seen:
            rec = self.get(fp)
            if rec is None:
                break
            seen.add(fp)
            p, g = rec
            out.append((fp, g))
            if g < 0:
                break
            fp = p
        return list(reversed(out))


class NativeTraceStore(PyTraceStore):
    """The C++ store (``native/``); ``chain`` is the columnar store's walk
    over ``get``."""

    kind = "native"

    def __init__(self, lib=None, initial_capacity: int = 1 << 16):
        if lib is None:
            from .. import native
            lib = native.load()
        self._lib = lib
        self._h = lib.ts_create(initial_capacity)
        self.roots: Dict[int, PyState] = {}

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.ts_destroy(h)

    def __len__(self) -> int:
        return int(self._lib.ts_size(self._h))

    def add_batch(self, fps, parent_fps, actions):
        fps = np.ascontiguousarray(fps, np.uint64)
        parents = np.ascontiguousarray(parent_fps, np.uint64)
        acts = np.ascontiguousarray(actions, np.int32)
        n = fps.shape[0]
        if n == 0:
            return
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._lib.ts_add_batch(
            self._h, fps.ctypes.data_as(u64p), parents.ctypes.data_as(u64p),
            acts.ctypes.data_as(i32p), n)

    def get(self, fp: int) -> Optional[Tuple[int, int]]:
        parent = ctypes.c_uint64()
        action = ctypes.c_int32()
        found = self._lib.ts_get(self._h, int(fp) & (2 ** 64 - 1),
                                 ctypes.byref(parent), ctypes.byref(action))
        return (parent.value, action.value) if found else None

    def export(self):
        """The records in hash-slot order."""
        n = len(self)
        fps = np.empty(n, np.uint64)
        parents = np.empty(n, np.uint64)
        actions = np.empty(n, np.int32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        got = self._lib.ts_export(
            self._h, fps.ctypes.data_as(u64p), parents.ctypes.data_as(u64p),
            actions.ctypes.data_as(i32p), n)
        if got != n:
            raise RuntimeError(f"trace export wrote {got} of {n} records")
        return fps, parents, actions


def make_trace_store(kind: str = "columnar") -> PyTraceStore:
    """A store of ``kind`` (``TRACE_STORES``).  A native store that cannot
    be built prints the reason on stderr and the columnar store runs in
    its place: the store's ``kind`` says which."""
    if kind not in TRACE_STORES:
        raise ValueError(f"trace_store must be one of {TRACE_STORES}, "
                         f"got {kind!r}")
    if kind == "native":
        from .. import native
        try:
            return NativeTraceStore(native.load())
        except native.NativeUnavailable as e:
            print(f"trace store: native store unavailable ({e}); using "
                  f"the columnar store", file=sys.stderr)
    return PyTraceStore()
