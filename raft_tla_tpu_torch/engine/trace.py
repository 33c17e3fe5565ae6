"""Predecessor-trace store for counterexample reconstruction.

The engine records one ``(fingerprint, parent fingerprint, action id)``
per newly discovered state; walking the records back from a violating
fingerprint gives the chain that ``BFSEngine.replay`` re-runs.  Action id
-1 marks roots, whose full ``PyState`` is kept in ``roots``.  The JAX
package's ``PyTraceStore`` semantics (the first record of a fingerprint
wins), kept as numpy columns: a flush appends three arrays, and lookups
go through a sorted index built when the store is next read, so a run of
tens of millions of states costs 20 bytes a record and no Python object
per record.  The JAX package's native C++ store is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.pystate import PyState


class PyTraceStore:
    """fp64 -> (parent fp64, action id)."""

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
