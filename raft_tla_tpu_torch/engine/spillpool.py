"""Host spill pool: TLC's disk-backed state queue for level segments.

The level loop drains an over-watermark next-level queue to a host
segment and uploads it again when the level is expanded
(``engine/bfs.py``).  Segments in RAM serve until the frontier outgrows
host memory; given a directory, each segment is written to its own raw
file and read back through ``np.memmap``, so the OS page cache, not the
Python heap, holds what fits.

The JAX package's ``engine/spillpool.py`` ``SpillPool`` with the same
API (append, ``pop(0)``, ``len``, total rows, iteration for checkpoints,
truthiness, clear), without its fault-injection hooks.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional

import numpy as np


class SpillPool:
    """FIFO of row-array segments, RAM- or disk-backed."""

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory
        self._ram: List[np.ndarray] = []
        self._files: List[tuple] = []     # (path, shape, dtype)
        self._seq = 0
        if directory is not None:
            os.makedirs(directory, exist_ok=True)

    def append(self, rows: np.ndarray, copy: bool = False) -> None:
        """Queue a segment.  ``copy=True`` detaches a RAM segment from the
        caller's buffer (the drains reuse theirs); a disk segment is
        always a copy."""
        if len(rows) == 0:
            return
        if self.directory is None:
            self._ram.append(np.array(rows, copy=True) if copy else rows)
            return
        fd, path = tempfile.mkstemp(prefix=f"seg_{self._seq:06d}_",
                                    suffix=".rows", dir=self.directory)
        os.close(fd)
        self._seq += 1
        try:
            mm = np.memmap(path, dtype=rows.dtype, mode="w+",
                           shape=rows.shape)
            mm[:] = rows
            mm.flush()
            del mm
        except BaseException:
            os.unlink(path)                # never leave a torn segment
            raise
        self._files.append((path, rows.shape, rows.dtype))

    def pop(self, index: int = 0) -> np.ndarray:
        """Remove and return a segment (a read-only memmap when
        disk-backed; the file is unlinked at once, the mapping keeps it
        readable until the array is collected)."""
        if self.directory is None:
            return self._ram.pop(index)
        path, shape, dtype = self._files.pop(index)
        arr = np.memmap(path, dtype=dtype, mode="r", shape=shape)
        os.unlink(path)
        return arr

    def __len__(self) -> int:
        return len(self._ram) if self.directory is None else len(self._files)

    def __bool__(self) -> bool:
        return len(self) > 0

    def segments(self):
        """The segments, without consuming them (checkpoint writer)."""
        if self.directory is None:
            yield from self._ram
            return
        for path, shape, dtype in self._files:
            yield np.memmap(path, dtype=dtype, mode="r", shape=shape)

    def total_rows(self) -> int:
        if self.directory is None:
            return sum(len(s) for s in self._ram)
        return sum(shape[0] for _p, shape, _d in self._files)

    def clear(self) -> None:
        self._ram.clear()
        for path, _s, _d in self._files:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._files.clear()

    def __del__(self):
        # A run stopped early drops its pools with segments still queued;
        # their files must not outlive it.
        try:
            self.clear()
        except Exception:
            pass
