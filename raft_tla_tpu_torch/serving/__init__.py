"""Check-as-a-service job layer, the JAX package's ``serving/``.

- :mod:`.jobs` — job records (states ``queued -> admitted -> running ->
  done|failed|cancelled``) and the append-only JSONL **job journal**
  that makes the registry survive a server restart (the JAX package's
  format, so either package's server replays the other's job directory);
- :mod:`.manager` — :class:`~.manager.JobManager`: bounded admission,
  least-recently-served tenant scheduling, a single executor thread (one
  run owns the device), journal replay (queued jobs resume; the job a
  crash caught running is re-run once, then failed with a postmortem
  pointer), a result cache keyed by cfg content, and per-tenant counters
  + queue-wait/turnaround/SLO histograms + by-state gauges in the shared
  MetricsRegistry.

``server.py`` exposes it as the ``submit`` / ``status`` / ``result`` /
``cancel`` / ``jobs`` ops, per-job ``watch`` and the HTTP ``/jobs``
endpoint; the CLI's clients are ``python -m raft_tla_tpu_torch
submit|jobs|watch``.  Device-free at import, like ``obs/``.
"""

from .jobs import (JOB_STATES, LIVE_STATES, QueueFullError,  # noqa: F401
                   TERMINAL_STATES)
from .manager import JobManager                              # noqa: F401
