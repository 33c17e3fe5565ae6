"""Job records and the persistent job journal.

The JAX package's ``serving/jobs.py``, kept as the port's own copy: the
journal's format is the same byte for byte, so a job directory written by
either package's server replays in the other.

A **job** is one queued unit of server work (a ``check`` or ``simulate``
request) with an identity, a tenant, and a fully observable lifecycle:

    queued -> admitted -> running -> done | failed
    queued -> admitted -> cancelled

``queued``     accepted past admission control, waiting in the bounded
               queue;
``admitted``   selected by the fair scheduler, handed to the executor
               (transient — the window in which a cancel can still win);
``running``    executing on the device (non-preemptible: one engine run
               owns the device, so a running job cannot be cancelled);
``done``       completed with an ``{"ok": true}`` response;
``failed``     completed with an error (engine exception, ``ok: false``
               response, or lost to repeated server restarts);
``cancelled``  terminal before any device work — a cancelled job NEVER
               ran and never has a result (the invariant the races test
               pins).

Durability: every submit and every state transition appends one line to
the **job journal** (``<base_dir>/jobs.jsonl``, the same append-only
JSONL idiom as the run-history ledger).  :func:`replay` folds the
journal back into the final job table, which is how a restarted server
resumes its queue — see ``serving/manager.py`` for the resume policy
(queued jobs re-enqueue; a job caught ``running`` by the crash is
re-run once, then marked failed with a postmortem pointer).

Zero-dependency and device-free, like ``obs/`` — the journal must be
readable from tooling that never touches a device.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Tuple

#: Every state a job can be in, in lifecycle order.
JOB_STATES = ("queued", "admitted", "running", "done", "failed",
              "cancelled")

#: States a job never leaves.
TERMINAL_STATES = ("done", "failed", "cancelled")

#: Live (non-terminal) states — what "the job is alive" means for the
#: watch-idle interplay (server._serve_watch must not reap a watcher
#: while its job is in one of these).
LIVE_STATES = ("queued", "admitted", "running")


class QueueFullError(RuntimeError):
    """Admission reject: the bounded queue is at capacity.  The server
    renders this as a clean ``{"ok": false}`` line; the manager has
    already counted ``server/rejected/queue_full``."""


def new_job(job_id: str, tenant: str, request: dict, *,
            label: Optional[str] = None,
            cache_key: Optional[str] = None,
            slo_seconds: Optional[float] = None,
            ts: Optional[float] = None) -> dict:
    """A fresh job record (plain dict — journal lines and op responses
    serialize it directly).  Result payloads are kept OUT of the record
    (the manager stores them separately) so ``jobs``-op listings stay
    small no matter how big a check response is."""
    return {
        "id": job_id,
        "tenant": tenant,
        "label": label,
        "state": "queued",
        "request": request,
        "cache_key": cache_key,
        "slo_seconds": slo_seconds,
        "created_ts": round(time.time() if ts is None else ts, 6),
        # When the job last entered the queue: submit time, reset by a
        # restart's re-enqueue — the queue-wait base (a crash's
        # downtime is turnaround, never queueing).
        "enqueued_ts": round(time.time() if ts is None else ts, 6),
        "admitted_ts": None,
        "started_ts": None,
        "finished_ts": None,
        "queue_wait_seconds": None,
        "run_seconds": None,
        "turnaround_seconds": None,
        "restarts": 0,
        "cached": False,
        "events_out": None,      # per-job scoped JSONL event log
        "job_dir": None,         # per-job artifact dir (postmortem.json)
        "postmortem": None,      # pointer to a crash dump, when one exists
        "error": None,
        "note": None,
    }


#: Fields the ``jobs``/``status`` ops (and the HTTP /jobs endpoint)
#: expose — everything except the raw request (which can carry a whole
#: cfg_text) and the result (served by the ``result`` op only).
SUMMARY_FIELDS = ("id", "tenant", "label", "state", "created_ts",
                  "admitted_ts", "started_ts", "finished_ts",
                  "queue_wait_seconds", "run_seconds",
                  "turnaround_seconds", "restarts", "cached",
                  "events_out", "postmortem", "error", "note")


def summarize(job: dict, has_result: bool = False) -> dict:
    out = {k: job.get(k) for k in SUMMARY_FIELDS}
    out["has_result"] = has_result
    return out


# -- journal ---------------------------------------------------------------

def append_record(path: str, rec: dict) -> None:
    """One JSONL line, through the history ledger's single append
    idiom (``default=str``: job requests may carry caller objects)."""
    from ..obs.history import append_entry
    append_entry(path, rec, default=str)


def submit_record(job: dict) -> dict:
    return {"rec": "submit", "ts": round(time.time(), 6),
            "job": {k: v for k, v in job.items()}}


def state_record(job: dict, patch: Optional[dict] = None,
                 result: Optional[dict] = None) -> dict:
    rec = {"rec": "state", "ts": round(time.time(), 6),
           "id": job["id"], "state": job["state"]}
    if patch:
        rec["patch"] = dict(patch)
    if result is not None:
        # Terminal ``done`` lines carry the result so a restarted server
        # can still serve the ``result`` op for pre-restart jobs.
        rec["result"] = result
    return rec


def replay(path: str) -> Tuple[Dict[str, dict], Dict[str, dict],
                               list]:
    """Fold the journal into ``(jobs by id, results by id, problems)``
    — each job's record is its submit line with every subsequent state
    line's ``state``/``patch`` applied in order.

    Replay is TOLERANT by design: the journal is written best-effort
    (a full disk degrades to lost durability, never a dead server), so
    a torn trailing line from a crash or an orphan state record whose
    submit line was dropped are expected degradations, not reasons to
    refuse every future restart on this job dir.  Unusable lines are
    skipped and reported as ``problems`` — ``[(lineno, reason), ...]``
    — which the manager surfaces loudly (stderr + counter); a missing
    file is an empty table."""
    jobs: Dict[str, dict] = {}
    results: Dict[str, dict] = {}
    problems: list = []
    if not os.path.exists(path):
        return jobs, results, problems
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                problems.append((ln, f"malformed line ({e})"))
                continue
            kind = rec.get("rec") if isinstance(rec, dict) else None
            if kind == "submit":
                job = rec.get("job")
                if not isinstance(job, dict) or "id" not in job:
                    problems.append((ln, "submit record without a job "
                                         "object"))
                    continue
                jobs[job["id"]] = dict(job)
            elif kind == "state":
                job = jobs.get(rec.get("id"))
                if job is None:
                    problems.append(
                        (ln, f"state record for unknown job "
                             f"{rec.get('id')!r} (its submit line was "
                             f"lost)"))
                    continue
                if rec.get("state") not in JOB_STATES:
                    problems.append(
                        (ln, f"unknown state {rec.get('state')!r}"))
                    continue
                job["state"] = rec["state"]
                patch = rec.get("patch")
                if isinstance(patch, dict):
                    job.update(patch)
                if "result" in rec:
                    results[job["id"]] = rec["result"]
            else:
                problems.append((ln, f"not a journal record: "
                                     f"{line[:80]}"))
    return jobs, results, problems
