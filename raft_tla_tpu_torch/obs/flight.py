"""Flight recorder: always-on black-box telemetry and postmortem dumps.

The JAX package's ``obs/flight.py``, kept as the port's own copy.  A
bounded ring a kind of recent records: every run event (mirrored from
each ``RunEventLog``, with or without a file), rate-limited progress
snapshots from the engines' chunk loops, the chunk profiler's stage
samples, the run's context.  A deque append under a lock a record, a few
records a second at most.  Armed for a run, the recorder writes the ring
and a final metrics snapshot to ``<workdir>/postmortem.json`` when the
run dies abnormally:

- an exception escaping ``engine.run()`` (the engines dump and stamp
  ``postmortem_path`` on ``run_end``);
- ``SIGTERM`` (a handler installed while armed dumps, then re-delivers
  the signal with the previous disposition restored);
- any other interpreter exit while armed (the ``atexit`` backstop).

A run that ends (exhausted, violation, deadlock, a budget) disarms
without a dump: a postmortem file always means a run that did not
complete.  The ring is also what the ``--metrics-port`` listener serves
at ``/flight`` (``obs/expose.py``).

``host_fingerprint`` names the host and the card a measurement ran on,
from what PyTorch sees: the card's name and UUID, the driver, CUDA
(``torch.version.cuda``) and ``nvcc --version`` where there is one.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import shutil
import signal
import subprocess
import threading
import time
from collections import deque
from typing import Dict, Optional

#: Records kept a kind.  Rings a kind, so a high-rate kind (progress)
#: never evicts the rare ones (run events, the run's context).
DEFAULT_CAPACITY = 256

#: Least seconds between progress records: the chunk loops call
#: ``FlightRecorder.progress`` at every stats read, and this floor keeps
#: the always-on cost at a few records a second.  The first record of a
#: run always lands (the limiter resets on ``arm``).
PROGRESS_EVERY_S = 0.5

_HOST = None


def _run(cmd) -> Optional[str]:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def host_fingerprint() -> dict:
    """Identity of the host and the card a measurement ran on: the CPU
    model, PyTorch and its CUDA, the card's name (``device_kind``), UUID
    and count, the driver, ``nvcc``'s release.  Best-effort: what cannot
    be read is None, never a raise.  Read once a process."""
    global _HOST
    if _HOST is not None:
        return dict(_HOST)
    out = {"cpu_model": None, "torch": None, "cuda": None,
           "device_kind": None, "device_count": None, "platform": None,
           "device_uuid": None, "driver": None, "nvcc": None,
           "hostname": None}
    try:
        import platform as _platform
        out["hostname"] = _platform.node() or None
        out["cpu_model"] = _platform.processor() or None
    except Exception:
        pass
    try:                       # Linux: processor() is often ""
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    out["cpu_model"] = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    try:
        import torch
        out["torch"] = torch.__version__
        out["cuda"] = torch.version.cuda
        if torch.cuda.is_available():
            out["platform"] = "gpu"
            out["device_count"] = torch.cuda.device_count()
            props = torch.cuda.get_device_properties(0)
            out["device_kind"] = props.name
            uuid = getattr(props, "uuid", None)
            out["device_uuid"] = str(uuid) if uuid is not None else None
        else:
            out["platform"] = "cpu"
            out["device_count"] = 0
    except Exception:
        pass
    if out["platform"] == "gpu" and shutil.which("nvidia-smi"):
        drv = _run(["nvidia-smi", "--query-gpu=driver_version",
                    "--format=csv,noheader"])
        out["driver"] = drv.splitlines()[0].strip() if drv else None
    try:
        from ..utils.build import nvcc
        ver = _run([nvcc(), "--version"])
        m = re.search(r"release ([0-9.]+)", ver or "")
        out["nvcc"] = m.group(1) if m else None
    except Exception:
        pass
    _HOST = out
    return dict(out)


class FlightRecorder:
    """Bounded per-kind ring of recent telemetry records.

    Thread-safe: the engine's host loop and the HTTP listener touch one
    process-global instance
    (:data:`RECORDER`).  Each record is a small dict stamped with a
    process-monotone ``seq`` (so consumers can order across kinds and
    detect new data) and ``ts``.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        # RLock, not Lock: the SIGTERM/atexit dump runs snapshot() in
        # the main thread, and the signal handler can interrupt the main
        # thread inside a record() that holds the lock; a plain Lock
        # would deadlock the dying process where it writes its dump.
        self._lock = threading.RLock()
        self._rings: Dict[str, deque] = {}
        self._seq = 0
        # -- postmortem arming (one run at a time, like the device) ----
        self._live = False            # a run is in flight (watch liveness)
        self._armed_path: Optional[str] = None   # where a dump would land
        self._armed_context: Optional[dict] = None
        self._metrics = None           # registry to snapshot into dumps
        self._live_evlog = None        # run's RunEventLog for watch_attach
        self._hooks_installed = False
        self._prev_sigterm = None
        self._last_progress = float("-inf")

    # -- recording -----------------------------------------------------
    def record(self, kind: str, **fields) -> int:
        """Append one record; returns its ``seq``."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            ring = self._rings.get(kind)
            if ring is None:
                ring = self._rings[kind] = deque(maxlen=self.capacity)
            rec = {"seq": seq, "ts": round(time.time(), 6)}
            rec.update(fields)
            ring.append(rec)
        return seq

    def progress(self, **fields) -> Optional[int]:
        """Rate-limited progress record (the engines' per-chunk call):
        at most one per :data:`PROGRESS_EVERY_S`; the first call after
        ``arm()`` always records.  Returns the seq when recorded."""
        now = time.monotonic()
        if now - self._last_progress < PROGRESS_EVERY_S:
            return None
        self._last_progress = now
        return self.record("progress", **fields)

    # -- reading -------------------------------------------------------
    def seq(self) -> int:
        with self._lock:
            return self._seq

    def snapshot(self, kinds=None, last: Optional[int] = None) -> dict:
        """{kind: [records oldest->newest]}; ``last`` trims each kind to
        its newest N records."""
        with self._lock:
            out = {}
            for kind, ring in self._rings.items():
                if kinds is not None and kind not in kinds:
                    continue
                recs = list(ring)
                if last is not None:
                    recs = recs[-last:]
                out[kind] = recs
            return out

    def last_record(self, kind: str) -> Optional[dict]:
        with self._lock:
            ring = self._rings.get(kind)
            return ring[-1] if ring else None

    def last_event(self, event_type: str) -> Optional[dict]:
        """Newest mirrored run event of one type (the ``event`` ring
        holds every RunEventLog emit) — how the watch op finds the last
        ``level_complete`` / ``coverage`` / ``run_end``."""
        with self._lock:
            ring = self._rings.get("event")
            if not ring:
                return None
            for rec in reversed(ring):
                if rec.get("event") == event_type:
                    return rec
        return None

    def clear(self) -> None:
        """Testing hook: drop every ring (the seq counter keeps
        advancing — consumers rely on it being process-monotone)."""
        with self._lock:
            self._rings.clear()

    # -- run attach ----------------------------------------------------
    def set_live_evlog(self, evlog) -> None:
        """Register the current run's event log (the engines' ``run``)
        so a watcher attaching mid-run can leave a ``watch_attach`` event
        in the run's durable record."""
        self._live_evlog = evlog

    def note_attach(self, **client) -> int:
        """A watcher attached (an HTTP ``/flight`` consumer): record it
        in the ring and, when a run is live, in its JSONL event log
        (payload object ``client``)."""
        seq = self.record("watch_attach", client=dict(client))
        evlog = self._live_evlog
        if evlog is not None:
            try:
                evlog.emit("watch_attach", client=dict(client))
            except Exception:
                pass               # attach bookkeeping must never kill a run
        return seq

    # -- postmortem ----------------------------------------------------
    def arm(self, path: Optional[str], metrics=None,
            context: Optional[dict] = None) -> None:
        """Arm for one run: liveness on (watchers see a run in flight)
        and the postmortem dump targeted at ``path``.  ``path`` None
        arms the bookkeeping (context/metrics still feed watch
        snapshots, ``armed`` still reports the live run) but disables
        the dump — there is nowhere to write it."""
        self._live = True
        self._armed_path = path
        self._armed_context = dict(context or {})
        self._metrics = metrics
        self._last_progress = float("-inf")   # first progress always lands
        if context:
            self.record("run_context", **dict(context))
        self._install_hooks()

    def disarm(self) -> None:
        """The run completed (any stop_reason) — no dump on exit."""
        self._live = False
        self._armed_path = None
        self._armed_context = None
        self._metrics = None

    def context(self) -> dict:
        """The armed run's context snapshot (engine, pipeline, batch);
        {} when no run is live."""
        with self._lock:
            return dict(self._armed_context or {})

    @property
    def armed(self) -> bool:
        """A run is in flight.  Liveness, NOT dump-path-configured: a
        run without a checkpoint/postmortem dir is still live for the
        watch consumers (its dump is simply disabled — ``dump()``
        no-ops on the missing path)."""
        return self._live

    def dump(self, reason: str, path: Optional[str] = None
             ) -> Optional[str]:
        """Write the postmortem JSON (atomic tmp + rename) and return
        its path, or None when there is nowhere to write (not armed and
        no explicit path).  Never raises: this runs from signal handlers
        and ``atexit``, where a secondary failure must not mask the
        primary one."""
        path = path or self._armed_path
        if path is None:
            return None
        try:
            doc = {
                "postmortem": True,
                "reason": reason,
                "written_ts": round(time.time(), 6),
                "pid": os.getpid(),
                "context": dict(self._armed_context or {}),
                "host": host_fingerprint(),
                "records": self.snapshot(),
            }
            mt = self._metrics
            if mt is not None:
                try:
                    doc["metrics"] = mt.snapshot()
                except Exception:
                    pass
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, default=str)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            return path
        except Exception:
            return None

    # -- process hooks -------------------------------------------------
    def _install_hooks(self) -> None:
        """atexit backstop + SIGTERM handler, installed once a process.
        The SIGTERM handler dumps, restores the previous disposition and
        re-delivers, so a caller that expects SIGTERM to kill still sees
        it kill."""
        if self._hooks_installed:
            return
        self._hooks_installed = True
        atexit.register(self._atexit_dump)
        try:
            self._prev_sigterm = signal.signal(
                signal.SIGTERM, self._on_sigterm)
        except (ValueError, OSError):
            # Not the main thread, or no signals here: the atexit and
            # error paths still cover everything but a hard kill.
            self._prev_sigterm = None

    def _atexit_dump(self) -> None:
        if self.armed:
            self.dump("atexit_while_armed")

    def _on_sigterm(self, signum, frame) -> None:
        self.dump("sigterm")
        # Restore the EXACT previous disposition (SIG_IGN / SIG_DFL /
        # handler — signal.signal accepts all three) and re-deliver:
        # the host's choice is respected, including a deliberate
        # SIG_IGN, which the recorder must not convert into a death.
        prev = self._prev_sigterm
        try:
            signal.signal(signum, prev if prev is not None
                          else signal.SIG_DFL)
        except (ValueError, OSError, TypeError):
            pass
        try:
            os.kill(os.getpid(), signum)    # re-deliver
        except OSError:
            os._exit(143)


#: The process-global black box every layer feeds (engines, event logs,
#: the chunk profiler) and every consumer reads (the HTTP listener,
#: postmortem dumps).  One a process.
RECORDER = FlightRecorder()
