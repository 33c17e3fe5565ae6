"""Crash-resume supervisor — bounded restarts around a child check run.

The JAX package's ``resilience/supervisor.py``, kept as the port's own
copy: the same attempts, events and exit-code rules around a child
``python -m raft_tla_tpu_torch check ...``.  The parent never touches the
device: it builds no engine and makes no CUDA call, so it creates no CUDA
context and holds no card memory while its child runs.

``cli check --supervise[=N]`` re-runs itself through here: the check
executes in a CHILD process, and when that child dies with a crash exit
the supervisor resumes it from ``checkpoint.latest(checkpoint_dir)``
with exponential backoff, up to N restarts.  Exit codes 0 (clean) and 1
(violation/deadlock found) are COMPLETED checks — a found counterexample
is a result, not a crash — and stop the loop immediately; anything else
(a raised engine error, an injected ``os._exit``, a signal death) is
retriable.

Exit code 1 is ambiguous on its own: the CLI returns 1 for a found
violation/deadlock, but an uncaught Python exception ALSO exits 1.  The
supervisor disambiguates through the run's event log: the engines write
a ``run_end`` event with ``stop_reason`` ``violation``/``deadlock`` on
a completed counterexample run, and ``error`` (or nothing at all, for a
hard death) on a crash — so a 1-exit WITHOUT a fresh completed
``run_end`` is retried like any other crash.  When no event log is
readable the 1-exit is conservatively treated as completed (retrying a
deterministic violation would just re-find it N times).

Each restart appends a ``restart`` event to the run's JSONL event log
(the same file the child engines append to — ``RunEventLog`` opens in
append mode and writes one flushed line per event, so supervisor and
child lines interleave cleanly).  The chaos drills
(``tests/test_torch_resilience.py``, ``chip_smoke.py``) hold a supervised
faulted run to the uninterrupted one's counts.

The child resumes via ``--resume auto`` only when an intact snapshot
actually exists — a crash before the first checkpoint restarts the run
from scratch rather than dying on ``--resume auto``'s no-checkpoint
error.  ``checkpoint.latest`` already skips torn/truncated files and
mixed-generation piece groups, so the supervisor never needs to judge
snapshot health itself.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Dict, List, Optional


def run_supervised(child_argv: List[str], checkpoint_dir: str,
                   max_restarts: int = 3,
                   events_out: Optional[str] = None,
                   backoff_seconds: float = 1.0,
                   backoff_factor: float = 2.0,
                   backoff_cap_seconds: float = 60.0,
                   initial_resume: Optional[str] = None,
                   env: Optional[dict] = None,
                   trace_out: Optional[str] = None) -> int:
    """Run ``child_argv`` under crash-resume supervision; returns the
    final child exit code.  ``child_argv`` is the complete child command
    (e.g. ``[sys.executable, "-m", "raft_tla_tpu_torch", "check", ...]``)
    WITHOUT any ``--supervise`` or ``--resume`` flags — the supervisor
    decides the resume point per attempt: ``initial_resume`` (the
    user's own ``--resume`` value, honored on the FIRST attempt too)
    and ``--resume auto`` on restarts.

    Restart resumes are guarded against a REUSED checkpoint dir: unless
    the user asked to resume, ``--resume auto`` is only passed once
    ``latest()`` differs from what the dir held before the first
    attempt — a child that crashed before its first snapshot must
    restart from scratch, not from a previous run's stale image (whose
    cfg may not even match; load() validates only dims).

    ``trace_out`` (the run's ``--trace-out`` value, when set): the CHILD
    keeps writing its engine trace to that path — the last completed
    attempt's trace wins, which is the one a user wants to open — while
    the supervisor records its own timeline (one ``attempt`` span per
    child run, ``restart`` instants with exit codes) to
    ``<trace_out>.supervisor.json``."""
    # Deferred: engine.checkpoint imports resilience.faults for its
    # injection sites, and this module rides in resilience/__init__ —
    # top-level imports here would close that cycle during package init.
    from ..engine import checkpoint as ckpt_mod
    from ..obs.events import RunEventLog, events_path
    from ..obs.tracing import SpanTracer
    evpath = events_path(events_out, checkpoint_dir)
    evlog = RunEventLog(evpath)
    tracer = SpanTracer(f"{trace_out}.supervisor.json" if trace_out
                        else None, process_name="supervisor")
    preexisting = ckpt_mod.latest(checkpoint_dir)
    attempt = 0
    try:
        while True:
            argv = list(child_argv)
            if attempt == 0:
                if initial_resume:
                    argv += ["--resume", initial_resume]
            elif initial_resume or \
                    ckpt_mod.latest(checkpoint_dir) != preexisting:
                argv += ["--resume", "auto"]
            ends_before = _count_run_ends(evpath)
            attempt_t0 = time.perf_counter()
            attempt_wall_t0 = time.time()
            rc = subprocess.call(argv, env=env)
            tracer.complete("attempt", attempt_t0, attempt=attempt,
                            exit_code=rc)
            if rc not in (0, 1):
                # A crashed child's flight recorder dumps its black box
                # next to the checkpoints (obs/flight.py; the injected
                # hard kill dumps from faults._die).  Surface it in the
                # supervision timeline so the postmortem is
                # discoverable from the event log alone.
                for pm in _find_postmortems(checkpoint_dir,
                                            attempt_wall_t0):
                    evlog.emit("postmortem", attempt=attempt,
                               exit_code=rc, dump=pm)
            if rc == 0 or (rc == 1
                           and _completed_counterexample(evpath,
                                                         ends_before)):
                if attempt:
                    evlog.emit("supervised_done", attempts=attempt,
                               exit_code=rc)
                return rc
            if rc == 2:
                # Usage/config error (argparse): deterministic — the
                # identical command would fail N more times.
                evlog.emit("supervise_giveup", attempts=attempt,
                           exit_code=rc)
                print("supervisor: child exited 2 (usage error); not "
                      "retriable", file=sys.stderr)
                return rc
            if attempt >= max_restarts:
                evlog.emit("supervise_giveup", attempts=attempt,
                           exit_code=rc)
                print(f"supervisor: child exited {rc}; restart budget "
                      f"({max_restarts}) exhausted", file=sys.stderr)
                return rc
            delay = min(backoff_seconds * backoff_factor ** attempt,
                        backoff_cap_seconds)
            attempt += 1
            nxt = ckpt_mod.latest(checkpoint_dir)
            if not initial_resume and nxt == preexisting:
                nxt = None       # stale-dir guard: see docstring
            evlog.emit("restart", attempt=attempt, exit_code=rc,
                       resume_from=nxt, backoff_seconds=round(delay, 3))
            tracer.instant("restart", attempt=attempt, exit_code=rc,
                           resume_from=nxt)
            print(f"supervisor: child exited {rc}; restart {attempt}/"
                  f"{max_restarts} in {delay:.1f}s "
                  + (f"resuming {nxt}" if nxt else "from scratch"),
                  file=sys.stderr)
            time.sleep(delay)
    finally:
        evlog.close()
        if tracer.enabled:
            tracer.write()


def _find_postmortems(checkpoint_dir: str, since_ts: float) -> List[dict]:
    """Postmortem dumps a child wrote during the attempt that just
    crashed: ``postmortem.json`` plus any per-controller pieces
    (``postmortem.p<i>of<m>.json``) under the checkpoint dir, filtered
    by mtime so a previous attempt's dump is not re-reported.  Each
    entry is the ``dump`` payload of one ``postmortem`` event: path,
    reason, and a compact shape summary (record counts per kind) —
    never the full ring, which belongs in the file."""
    import glob
    import json
    import os
    out = []
    for path in sorted(
            glob.glob(os.path.join(checkpoint_dir, "postmortem.json"))
            + glob.glob(os.path.join(checkpoint_dir,
                                     "postmortem.p*of*.json"))):
        try:
            if os.path.getmtime(path) < since_ts - 1.0:
                continue
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            out.append({
                "path": path,
                "reason": doc.get("reason"),
                "pid": doc.get("pid"),
                "records": {k: len(v) for k, v
                            in (doc.get("records") or {}).items()},
                "last_progress": ((doc.get("records") or {})
                                  .get("progress") or [None])[-1]})
        except (OSError, ValueError):
            continue
    return out


def _run_end_reasons(evpath: Optional[str]) -> Optional[Dict[str, List[str]]]:
    """``{file: [stop_reason, ...]}`` of every ``run_end`` record, per
    event-log file — the base path AND any per-controller piece files
    next to it (``events.p<i>of<m>.jsonl``; obs/events.py events_path):
    multi-host children write run_end only into their pieces, so
    reading the base file alone would misread a completed fleet as a
    crash.  None when nothing is readable (best-effort: the log is
    evidence, not a dependency)."""
    import glob
    import json
    import os
    if not evpath:
        return None
    root, ext = os.path.splitext(evpath)
    out: Dict[str, List[str]] = {}
    for path in [evpath] + sorted(glob.glob(f"{root}.p*of*{ext}")):
        try:
            with open(path, encoding="utf-8") as f:
                out[path] = [str(rec.get("stop_reason"))
                             for line in f if line.strip()
                             for rec in (json.loads(line),)
                             if rec.get("event") == "run_end"]
        except (OSError, ValueError):
            continue
    return out or None


def _count_run_ends(evpath: Optional[str]) -> Dict[str, int]:
    reasons = _run_end_reasons(evpath)
    return ({f: len(r) for f, r in reasons.items()}
            if reasons is not None else {})


def _completed_counterexample(evpath: Optional[str],
                              ends_before: Dict[str, int]) -> bool:
    """Did the child that just exited 1 actually COMPLETE (found a
    violation/deadlock), or did it die on an uncaught exception (also
    exit 1)?  Fresh ``run_end`` records with a counterexample
    stop_reason — one per controller file — are the completion receipt;
    a crash writes ``error`` or nothing.  An unreadable log defaults to
    completed — retrying a deterministic violation would only re-find
    it."""
    reasons = _run_end_reasons(evpath)
    if reasons is None:
        return True
    fresh = [r for path, rs in reasons.items()
             for r in rs[ends_before.get(path, 0):]]
    return bool(fresh) and all(r in ("violation", "deadlock")
                               for r in fresh)


def strip_supervisor_flags(argv: List[str]) -> List[str]:
    """Child argv from the supervisor's own: drop ``--supervise[=N]``
    (the child must run the check, not recurse into supervision) and any
    ``--resume`` (the supervisor decides the resume point per attempt)."""
    out, skip = [], False
    for i, tok in enumerate(argv):
        if skip:
            skip = False
            continue
        if tok == "--supervise" or tok == "--resume":
            nxt = argv[i + 1] if i + 1 < len(argv) else ""
            # Both flags take an optional/required value: swallow it
            # unless it is clearly the next flag.
            skip = bool(nxt) and not nxt.startswith("-")
            continue
        if tok.startswith("--supervise=") or tok.startswith("--resume="):
            continue
        out.append(tok)
    return out
