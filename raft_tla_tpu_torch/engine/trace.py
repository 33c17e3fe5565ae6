"""Predecessor-trace store for counterexample reconstruction.

The engine records one ``(fingerprint, parent fingerprint, action id)``
per newly discovered state; walking the records back from a violating
fingerprint gives the chain that ``BFSEngine.replay`` re-runs.  Action id
-1 marks roots, whose full ``PyState`` is kept in ``roots``.  The JAX
package's ``PyTraceStore``; its native C++ store is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.pystate import PyState


class PyTraceStore:
    """fp64 -> (parent fp64, action id)."""

    def __init__(self):
        self._d: Dict[int, Tuple[int, int]] = {}
        self.roots: Dict[int, PyState] = {}

    def add_batch(self, fps, parent_fps, actions):
        d = self._d
        for f, p, g in zip(fps.tolist(), parent_fps.tolist(),
                           actions.tolist()):
            if f not in d:
                d[f] = (p, g)

    def get(self, fp: int) -> Optional[Tuple[int, int]]:
        return self._d.get(fp)

    def export(self):
        n = len(self._d)
        fps = np.fromiter(self._d.keys(), np.uint64, n)
        parents = np.fromiter((p for p, _g in self._d.values()), np.uint64,
                              n)
        actions = np.fromiter((g for _p, g in self._d.values()), np.int32, n)
        return fps, parents, actions

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
