"""Async job manager — the observable admission/scheduling/execution
spine of check-as-a-service.

The JAX package's ``serving/manager.py``, kept as the port's own copy
(the same states, scheduling, cache, journal replay and metric names).

One :class:`JobManager` owns:

- a **persistent job registry** (serving/jobs.py): every submit and
  state transition journals to ``<base_dir>/jobs.jsonl``; a restarted
  manager replays the journal — terminal jobs keep their results,
  queued/admitted jobs re-enqueue, and a job caught ``running`` by the
  crash is re-queued once (``requeued_after_restart``) then, on a
  second loss, marked failed with a pointer to its postmortem dump;
- a **bounded admission queue** with per-tenant fair scheduling:
  round-robin across tenants (Index-Based Scheduling's fairness signal:
  a queue-flooding tenant cannot starve the others;
  FIFO within a tenant), rejecting past ``queue_capacity`` with
  ``server/rejected/queue_full`` + per-tenant reject counters;
- a **single executor thread** that runs one job at a time through the
  caller-supplied ``executor(request, job)`` callable — the server
  wraps its existing ``_do_check``/``_do_simulate`` under the device
  lock, so engine semantics (one run owns the device) are untouched;
- a bounded **result cache** keyed by the submit op's content
  fingerprint (the history ledger's cfg-fingerprint idiom): a hit
  completes the job without a device run (``cached: true``), counted
  in ``jobs/result_cache/hits|misses``.

Observability is the product — every seam lands in the shared
MetricsRegistry:

counters    ``jobs/submitted/<tenant>``, ``jobs/done/<tenant>``,
            ``jobs/failed/<tenant>``, ``jobs/cancelled/<tenant>``,
            ``jobs/rejected/<tenant>``, ``jobs/slo_ok/<tenant>``,
            ``jobs/slo_miss/<tenant>``, ``server/rejected/queue_full``,
            ``jobs/result_cache/hits|misses``,
            ``jobs/requeued_after_restart``
gauges      ``jobs/queue_depth``, ``jobs/running``,
            ``jobs/state/<state>`` (one per lifecycle state)
histograms  ``jobs/queue_wait_seconds``, ``jobs/run_seconds``,
            ``jobs/turnaround_seconds`` (+ per-tenant queue-wait and
            turnaround) — the SLO surface: the registry's cumulative
            ``le`` buckets render as Prometheus histogram series, so
            "p99 turnaround under X s" is a stock PromQL query; the
            explicit ``slo_ok``/``slo_miss`` counters track the per-job
            ``slo_seconds`` target (manager default, overridable per
            submit).

Tenant metric names are client-controlled strings, which must never
grow the process-global registry without bound (the server's
metric-label rule): tenant labels are sanitized and capped — after
``tenant_cap`` distinct tenants, new ones fold into ``other``.

Device-free: the manager only schedules; everything device-shaped lives in
the executor callable.
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

from . import jobs as jobs_mod
from .jobs import (LIVE_STATES, QueueFullError, TERMINAL_STATES,
                   new_job, state_record, submit_record, summarize)

_TENANT_RE = re.compile(r"[^a-zA-Z0-9_.-]+")


class JobManager:
    def __init__(self, base_dir: str, *,
                 executor: Callable[[dict, dict], dict],
                 metrics=None,
                 queue_capacity: int = 64,
                 max_restarts: int = 1,
                 slo_seconds: float = 60.0,
                 history_path: Optional[str] = None,
                 tenant_cap: int = 32,
                 result_cache_cap: int = 128,
                 max_terminal_jobs: int = 10000,
                 start: bool = True):
        if metrics is None:
            from ..obs.metrics import MetricsRegistry
            metrics = MetricsRegistry()
        self.base_dir = os.path.abspath(base_dir)
        self.journal_path = os.path.join(self.base_dir, "jobs.jsonl")
        self.queue_capacity = int(queue_capacity)
        self.max_restarts = int(max_restarts)
        # Terminal-job retention: the in-memory registry (and result
        # store) keeps at most this many done/failed/cancelled jobs,
        # evicting oldest-first — the journal on disk keeps the full
        # history, but a long-lived server must not grow without bound.
        self.max_terminal_jobs = int(max_terminal_jobs)
        self.slo_seconds = float(slo_seconds)
        self.history_path = history_path
        self.tenant_cap = int(tenant_cap)
        self.metrics = metrics
        self._executor = executor
        self._cond = threading.Condition()
        self._jobs: Dict[str, dict] = {}   # insertion-ordered (oldest first)
        self._results: Dict[str, dict] = {}
        # Incrementally maintained state census: admission depth checks
        # and the gauge refresh must stay O(1) per operation, not
        # O(total jobs ever submitted) — this is the long-lived-service
        # hot path.
        self._state_counts: Dict[str, int] = {
            s: 0 for s in jobs_mod.JOB_STATES}
        # Terminal jobs in completion order — the retention pruner's
        # eviction queue (O(excess) per eviction, no registry scan).
        self._terminal_order: deque = deque()
        # Fair scheduler state: FIFO per tenant, picked least-recently-
        # served first (ties broken by tenant join order) — exact
        # round-robin that stays fair when a tenant joins mid-stream,
        # which a rotating ring does not (the just-served tenant would
        # sit in front of the newcomer).
        self._queues: Dict[str, deque] = {}
        self._served_seq = 0
        self._join_seq = 0
        self._tenant_rank: Dict[str, tuple] = {}  # t -> (served, join)
        self._running_id: Optional[str] = None
        self._counter = 0
        self._tenants_seen: Dict[str, str] = {}   # tenant -> metric label
        self._cache: "OrderedDict[str, dict]" = OrderedDict()
        self._cache_cap = int(result_cache_cap)
        self._stop = False
        self._thread = None
        os.makedirs(self.base_dir, exist_ok=True)
        self._replay()
        self._update_gauges_locked()
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="job-executor", daemon=True)
            self._thread.start()

    # -- admission -----------------------------------------------------
    def submit(self, request: dict, tenant: Optional[str] = None,
               *, label: Optional[str] = None,
               cache_key: Optional[str] = None,
               slo_seconds: Optional[float] = None) -> dict:
        """Admit one job (or raise :class:`QueueFullError`); returns the
        queued job's summary.  ``request`` is the inner check/simulate
        request the executor will run verbatim."""
        tenant = str(tenant or "default")
        tlabel = self._tenant_label(tenant)
        with self._cond:
            depth = self._state_counts["queued"]
            if depth >= self.queue_capacity:
                self.metrics.counter("server/rejected/queue_full")
                self.metrics.counter(f"jobs/rejected/{tlabel}")
                raise QueueFullError(
                    f"admission queue full ({depth} queued, capacity "
                    f"{self.queue_capacity}); retry later")
            self._counter += 1
            job_id = f"j{self._counter:06d}-{os.urandom(3).hex()}"
            job = new_job(job_id, tenant, dict(request), label=label,
                          cache_key=cache_key,
                          slo_seconds=(float(slo_seconds)
                                       if slo_seconds is not None
                                       else self.slo_seconds))
            job["job_dir"] = os.path.join(self.base_dir, job_id)
            if request.get("op") != "simulate":
                # Scoped event log for engine-backed jobs only: the
                # simulator has no run-event log, so the summary must
                # not advertise a file that will never exist.
                job["events_out"] = os.path.join(job["job_dir"],
                                                 "events.jsonl")
            self._register_locked(job)
            self._enqueue_locked(job)
            self._journal(submit_record(job))
            self.metrics.counter(f"jobs/submitted/{tlabel}")
            self._update_gauges_locked()
            self._cond.notify_all()
            return summarize(job)

    def cancel(self, job_id: str) -> dict:
        """queued/admitted -> cancelled.  Running jobs are NOT
        cancellable (a single-device engine run is non-preemptible) and
        terminal jobs stay terminal — both raise, which the server
        renders as a clean ``{"ok": false}``.  The cancelled-job
        invariant: it never reaches the executor, never has a result,
        and its state never changes again."""
        with self._cond:
            job = self._require(job_id)
            st = job["state"]
            if st in TERMINAL_STATES:
                raise ValueError(f"job {job_id} already {st}")
            if st == "running":
                raise ValueError(
                    f"job {job_id} is running; a single-device engine "
                    f"run is not preemptible")
            self._transition_locked(
                job, "cancelled",
                patch={"finished_ts": round(time.time(), 6)})
            self.metrics.counter(
                f"jobs/cancelled/{self._tenant_label(job['tenant'])}")
            self._update_gauges_locked()
            return summarize(job)

    # -- queries -------------------------------------------------------
    def get(self, job_id: str) -> dict:
        with self._cond:
            job = self._require(job_id)
            return summarize(job, has_result=job_id in self._results)

    def result_doc(self, job_id: str) -> dict:
        """``{"state": ..., "result": ...}`` read under ONE lock — the
        result op must never fetch a result and then lose the state
        read to a terminal-retention eviction between two locks."""
        with self._cond:
            job = self._require(job_id)
            if job["state"] not in TERMINAL_STATES:
                raise ValueError(f"job {job_id} is {job['state']}; "
                                 f"no result yet")
            res = self._results.get(job_id)
            if res is None:
                raise ValueError(f"job {job_id} {job['state']}"
                                 + (f": {job['error']}" if job["error"]
                                    else " with no result"))
            return {"state": job["state"], "result": dict(res)}

    def result(self, job_id: str) -> dict:
        return self.result_doc(job_id)["result"]

    def jobs_doc(self, tenant: Optional[str] = None,
                 state: Optional[str] = None,
                 limit: Optional[int] = None) -> dict:
        """The ``jobs`` op / HTTP ``/jobs`` document: summaries (oldest
        first) + the same queue-depth/running/by-state numbers the
        gauges carry, read in one locked snapshot so the two surfaces
        agree.  The registry is insertion-ordered by construction
        (submit appends, replay rebuilds sorted), so no per-call sort;
        ``limit`` keeps the NEWEST N rows — a periodic scraper against
        a 10k-job retention must not serialize megabytes under the
        manager lock per poll."""
        with self._cond:
            out: List[dict] = []
            for job in self._jobs.values():
                if tenant is not None and job["tenant"] != tenant:
                    continue
                if state is not None and job["state"] != state:
                    continue
                out.append(summarize(job,
                                     has_result=job["id"] in
                                     self._results))
            if limit is not None and limit > 0:
                out = out[-limit:]
            by_state = dict(self._state_counts)
            return {"jobs": out,
                    "queue_depth": by_state["queued"],
                    "running": by_state["running"],
                    "by_state": by_state,
                    "queue_capacity": self.queue_capacity}

    def running_job_id(self) -> Optional[str]:
        with self._cond:
            return self._running_id

    def has_live_jobs(self) -> bool:
        """Any job queued/admitted/running — the watch-idle liveness
        signal (server._serve_watch: a watcher is not idle while the
        manager still owes work)."""
        with self._cond:
            return any(self._state_counts[s] > 0 for s in LIVE_STATES)

    def close(self, wait: bool = True,
              wait_timeout: float = 600.0) -> bool:
        """Stop the executor thread (the in-flight job, if any, runs to
        completion).  Queued jobs stay queued — journaled, so the next
        manager on this base_dir resumes them.

        Returns True when the executor is known to be stopped (or was
        never started); False when ``wait`` timed out or was skipped
        while a job may still be running — the caller must NOT treat
        the journal as settled (starting a successor manager on this
        base_dir before the executor finishes would replay the
        'running' tail and execute that job twice)."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        t = self._thread
        if t is None or not t.is_alive():
            return True
        if not wait:
            return False
        t.join(timeout=wait_timeout)
        return not t.is_alive()

    # -- internals -----------------------------------------------------
    def _require(self, job_id: str) -> dict:
        job = self._jobs.get(job_id)
        if job is None:
            raise KeyError(f"unknown job {job_id!r}")
        return job

    def _tenant_label(self, tenant: str) -> str:
        """Sanitized, bounded metric label for a tenant (see module
        docstring): the registry must never grow one series per
        arbitrary client string.  Distinct tenants must also never
        MERGE: when two raw ids sanitize to the same label ('acme corp'
        vs 'acme_corp'), the later one gets a short content-hash
        suffix so per-tenant accounting stays per-tenant."""
        with self._cond:
            lbl = self._tenants_seen.get(tenant)
            if lbl is not None:
                return lbl
            if len(self._tenants_seen) >= self.tenant_cap:
                return "other"
            lbl = _TENANT_RE.sub("_", tenant)[:32] or "default"
            # "other" is RESERVED for the cap-overflow fold: a real
            # tenant whose id sanitizes to it must not absorb every
            # post-cap tenant's series.
            if lbl == "other" or lbl in self._tenants_seen.values():
                import hashlib
                lbl = (lbl[:25] + "-"
                       + hashlib.sha256(tenant.encode())
                       .hexdigest()[:6])
            self._tenants_seen[tenant] = lbl
            return lbl

    #: Fairness-memory bound: ranks for at most this many tenants are
    #: retained.  Tenant ids are raw client strings on an
    #: unauthenticated service, so every per-tenant structure must be
    #: bounded (the same rule as the metric-label cap) — evicting an
    #: idle tenant's rank only resets its fairness memory.
    TENANT_RANK_CAP = 4096

    def _enqueue_locked(self, job: dict) -> None:
        t = job["tenant"]
        q = self._queues.get(t)
        if q is None:
            q = self._queues[t] = deque()
        q.append(job["id"])
        if t not in self._tenant_rank:
            self._join_seq += 1
            self._tenant_rank[t] = (0, self._join_seq)
            if len(self._tenant_rank) > self.TENANT_RANK_CAP:
                idle = [(rank, name) for name, rank
                        in self._tenant_rank.items()
                        if name != t and not self._queues.get(name)]
                for _rank, name in sorted(idle)[:len(idle) // 2 + 1]:
                    del self._tenant_rank[name]

    def _pick_locked(self) -> Optional[dict]:
        """Fair pick: the least-recently-served tenant with a genuinely
        queued job (cancelled entries are dropped lazily), FIFO within
        the tenant."""
        while True:
            candidates = [t for t, q in self._queues.items() if q]
            if not candidates:
                return None
            t = min(candidates, key=lambda t: self._tenant_rank[t])
            q = self._queues[t]
            job = None
            while q:
                job = self._jobs.get(q.popleft())
                if job is not None and job["state"] == "queued":
                    break
                job = None
            if not q:
                del self._queues[t]
            if job is not None:
                self._served_seq += 1
                self._tenant_rank[t] = (self._served_seq,
                                        self._tenant_rank[t][1])
                return job

    def _journal(self, rec: dict) -> None:
        """Best-effort journal append: a full disk must degrade to a
        loudly-counted loss of restart durability, never kill the
        executor thread or strand the in-memory registry (the scheduler
        keeps the truth; the journal is its shadow)."""
        try:
            jobs_mod.append_record(self.journal_path, rec)
        except OSError as e:
            self.metrics.counter("jobs/journal_errors")
            import sys
            print(f"job journal append failed ({e}); registry stays "
                  f"in-memory-consistent, restart durability degraded",
                  file=sys.stderr)

    def _register_locked(self, job: dict) -> None:
        """Add a job to the registry + state census (submit/replay)."""
        self._jobs[job["id"]] = job
        self._state_counts[job["state"]] += 1

    def _transition_locked(self, job: dict, state: str,
                           patch: Optional[dict] = None,
                           result: Optional[dict] = None) -> None:
        self._state_counts[job["state"]] -= 1
        job["state"] = state
        self._state_counts[state] += 1
        if patch:
            job.update(patch)
        if result is not None:
            self._results[job["id"]] = result
        self._journal(state_record(job, patch=patch, result=result))
        if state in TERMINAL_STATES:
            self._terminal_order.append(job["id"])
            self._prune_terminal_locked()

    def _prune_terminal_locked(self) -> None:
        """Evict oldest terminal jobs past the retention cap (their
        journal history survives on disk; the ``result``/``status`` ops
        just stop answering for them).  Walks the completion-order
        deque, not the registry — O(excess) per call."""
        excess = (sum(self._state_counts[s] for s in TERMINAL_STATES)
                  - self.max_terminal_jobs)
        while excess > 0 and self._terminal_order:
            jid = self._terminal_order.popleft()
            job = self._jobs.get(jid)
            if job is None or job["state"] not in TERMINAL_STATES:
                continue
            self._state_counts[job["state"]] -= 1
            del self._jobs[jid]
            self._results.pop(jid, None)
            self.metrics.counter("jobs/evicted")
            excess -= 1

    def _update_gauges_locked(self) -> None:
        mt = self.metrics
        mt.gauge("jobs/queue_depth", self._state_counts["queued"])
        mt.gauge("jobs/running", self._state_counts["running"])
        for s, n in self._state_counts.items():
            mt.gauge(f"jobs/state/{s}", n)

    def _history_entry(self, job: dict, verdict: str) -> None:
        """Restart-resume bookkeeping in the run-history ledger (the
        per-run ``kind=server`` entries ride the executor path in
        server.py; these cover the jobs a restart touched without
        running them)."""
        if not self.history_path:
            return
        try:
            from ..obs import history as history_mod
            history_mod.append_entry(
                self.history_path,
                history_mod.make_entry(
                    "server", label=job.get("label") or job["id"],
                    verdict=verdict,
                    extra={"job_id": job["id"],
                           "tenant": job["tenant"]}))
        except Exception:
            pass         # ledger bookkeeping must never kill scheduling

    def _replay(self) -> None:
        """Journal replay (restart durability): rebuild the job table,
        re-enqueue the still-live jobs, and settle the job the crash
        caught ``running`` — re-queued up to ``max_restarts`` times
        (counted, noted), then failed with a pointer to its postmortem
        dump when one exists."""
        jobs, results, problems = jobs_mod.replay(self.journal_path)
        if problems:
            # Degraded journal (torn line, dropped record): recover
            # what parsed, say what was lost — loudly, but never
            # refuse to start (the brick-on-restart failure mode).
            self.metrics.counter("jobs/journal_skipped", len(problems))
            import sys
            for ln, reason in problems[:10]:
                print(f"job journal {self.journal_path}:{ln}: {reason} "
                      f"(skipped)", file=sys.stderr)
            if len(problems) > 10:
                print(f"job journal: ... and {len(problems) - 10} more "
                      f"skipped lines", file=sys.stderr)
        # Rebuild in created-order so the insertion-ordered registry
        # (the retention pruner's eviction order) matches history.
        self._jobs = dict(sorted(jobs.items(),
                                 key=lambda kv: (kv[1]["created_ts"],
                                                 kv[0])))
        self._results = results
        self._counter = len(jobs)
        for job in self._jobs.values():
            self._state_counts[job["state"]] += 1
        for job in list(self._jobs.values()):
            st = job["state"]
            if st in TERMINAL_STATES:
                self._terminal_order.append(job["id"])
                key = job.get("cache_key")
                if st == "done" and key and job["id"] in results:
                    self._cache[key] = results[job["id"]]
                    self._cache.move_to_end(key)
                    while len(self._cache) > self._cache_cap:
                        # Same bound as the live store path: a journal
                        # with years of cached jobs must not rebuild an
                        # unbounded result cache (newest entries win).
                        self._cache.popitem(last=False)
                continue
            if st in ("queued", "admitted"):
                self._transition_locked(
                    job, "queued",
                    # enqueued_ts resets: the queue-wait histogram must
                    # price THIS server's queue, not the downtime.
                    patch={"note": "resumed_after_restart",
                           "enqueued_ts": round(time.time(), 6)})
                self._enqueue_locked(job)
                continue
            # st == "running": the crash took this one mid-run.
            if job.get("restarts", 0) < self.max_restarts:
                self._transition_locked(
                    job, "queued",
                    patch={"restarts": job.get("restarts", 0) + 1,
                           "note": "requeued_after_restart",
                           "started_ts": None,
                           "enqueued_ts": round(time.time(), 6)})
                self.metrics.counter("jobs/requeued_after_restart")
                self._history_entry(job, "requeued-after-restart")
                self._enqueue_locked(job)
            else:
                pm = (os.path.join(job["job_dir"], "postmortem.json")
                      if job.get("job_dir") else None)
                if pm is not None and not os.path.exists(pm):
                    pm = None
                self._transition_locked(
                    job, "failed",
                    patch={"finished_ts": round(time.time(), 6),
                           "error": f"lost to {job['restarts'] + 1} "
                                    f"server restart(s) while running",
                           "postmortem": pm})
                self.metrics.counter(
                    f"jobs/failed/{self._tenant_label(job['tenant'])}")
                self._history_entry(job, "lost-after-restart")
        # The retention cap applies to the REPLAYED registry too: a
        # journal holding years of terminal history must not rebuild
        # into an unbounded in-memory table.
        self._prune_terminal_locked()

    # -- executor ------------------------------------------------------
    def _loop(self) -> None:
        """Executor thread main: one job at a time through
        ``_run_one``.  The outer guard exists so NOTHING — journal
        I/O, metrics, a pathological job record — can silently kill
        the thread and strand the queue; an iteration that blows up is
        counted, reported, and the loop continues."""
        while True:
            try:
                if not self._run_one():
                    return
            except Exception as e:
                self.metrics.counter("jobs/executor_errors")
                import sys
                print(f"job executor iteration failed "
                      f"({type(e).__name__}: {e}); continuing",
                      file=sys.stderr)
                time.sleep(0.25)     # never a tight crash loop

    def _run_one(self) -> bool:
        """Pick + run one job; returns False when stop was requested."""
        with self._cond:
            job = None
            while not self._stop:
                job = self._pick_locked()
                if job is not None:
                    break
                self._cond.wait(0.25)
            if self._stop and job is None:
                return False
            now = round(time.time(), 6)
            self._transition_locked(job, "admitted",
                                    patch={"admitted_ts": now})
            self._update_gauges_locked()
        # Per-job artifact dir outside the lock (filesystem work).
        try:
            os.makedirs(job["job_dir"], exist_ok=True)
        except OSError:
            pass
        with self._cond:
            if job["state"] != "queued" and job["state"] != "admitted":
                # A cancel won the admitted window: the job is
                # terminal and must never reach the executor.
                self._update_gauges_locked()
                return True
            now = round(time.time(), 6)
            # Queue wait is measured from the LAST enqueue (submit, or
            # a restart's re-enqueue) — a crash's downtime is turnaround,
            # not queueing, and must not pollute the queue-wait SLO.
            wait = now - (job.get("enqueued_ts") or job["created_ts"])
            self._transition_locked(
                job, "running",
                patch={"started_ts": now,
                       "queue_wait_seconds": round(wait, 6)})
            self._running_id = job["id"]
            self._update_gauges_locked()
        tlabel = self._tenant_label(job["tenant"])
        mt = self.metrics
        mt.observe("jobs/queue_wait_seconds", wait)
        mt.observe(f"jobs/queue_wait_seconds/{tlabel}", wait)
        resp, cached, err = None, False, None
        try:
            resp, cached = self._execute(job)
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
        now = round(time.time(), 6)
        run_s = now - job["started_ts"]
        turnaround = now - job["created_ts"]
        ok = err is None and isinstance(resp, dict) \
            and resp.get("ok") is True
        with self._cond:
            patch = {"finished_ts": now,
                     "run_seconds": round(run_s, 6),
                     "turnaround_seconds": round(turnaround, 6),
                     "cached": cached}
            if cached:
                # No engine ran, so no scoped event log was written —
                # the summary must not advertise a file that does not
                # exist (same contract as simulate jobs).
                patch["events_out"] = None
            if not ok:
                patch["error"] = err or (resp or {}).get("error") \
                    or "executor returned no response"
                pm = os.path.join(job["job_dir"], "postmortem.json")
                patch["postmortem"] = pm if os.path.exists(pm) \
                    else None
            self._transition_locked(
                job, "done" if ok else "failed", patch=patch,
                result=resp if isinstance(resp, dict) else None)
            self._running_id = None
            self._update_gauges_locked()
            self._cond.notify_all()
        mt.counter(f"jobs/{'done' if ok else 'failed'}/{tlabel}")
        mt.observe("jobs/run_seconds", run_s)
        mt.observe("jobs/turnaround_seconds", turnaround)
        mt.observe(f"jobs/turnaround_seconds/{tlabel}", turnaround)
        slo = job.get("slo_seconds")
        if slo:
            mt.counter(f"jobs/slo_{'ok' if turnaround <= slo else 'miss'}"
                       f"/{tlabel}")
        return True

    def _execute(self, job: dict):
        """Result-cache check, then the real executor.  Returns
        ``(response, cached)``."""
        key = job.get("cache_key")
        if key is not None:
            with self._cond:
                hit = self._cache.get(key)
                if hit is not None:
                    self._cache.move_to_end(key)
            if hit is not None:
                self.metrics.counter("jobs/result_cache/hits")
                return dict(hit), True
            self.metrics.counter("jobs/result_cache/misses")
        resp = self._executor(job["request"], job)
        if key is not None and isinstance(resp, dict) and resp.get("ok"):
            with self._cond:
                self._cache[key] = dict(resp)
                self._cache.move_to_end(key)
                while len(self._cache) > self._cache_cap:
                    self._cache.popitem(last=False)
        return resp, False
