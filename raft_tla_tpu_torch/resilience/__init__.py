"""Resilience, the JAX package's ``resilience/``: fault injection and
crash-resume.

- :mod:`.faults` — a deterministic fault plan (``--fault-plan`` /
  ``FAULT_PLAN`` env) with named injection sites in
  ``engine/checkpoint.py`` (torn write, missing piece),
  ``engine/bfs.py`` and ``parallel/mesh.py`` (mid-level kill, simulated
  out-of-memory at a chunk or a seen-set growth),
  ``engine/spillpool.py`` (failed spill write) and ``parallel/mesh.py``
  (delayed trace piece).  The sites cost one module bool read when no
  plan is installed.
- :mod:`.supervisor` — ``check --supervise[=N]``: the check in a child
  process, resumed from ``checkpoint.latest()`` after a crash exit with
  bounded restarts and exponential backoff, ``restart`` events in the
  run's JSONL log.

Graceful degradation lives in the engines (``engine/bfs.py``): running
out of device memory in the chunk loop halves the batch (down to
``EngineConfig.min_batch``) and resumes from the run's newest snapshot;
a seen-set growth that runs out retries once from the host keys after
releasing the old table — each a ``degraded`` event, not an abort.
"""

# NOTE: faults.ACTIVE is deliberately NOT re-exported — a ``from ...
# import ACTIVE`` would freeze the bool at import time; injection sites
# must read the live ``faults.ACTIVE`` module attribute.
from .faults import (EXIT_FAULT, FaultInjected,              # noqa: F401
                     FaultPlan, SimulatedResourceExhausted, clear, fire,
                     install, install_from_env, is_resource_exhausted)
from .supervisor import run_supervised                        # noqa: F401
