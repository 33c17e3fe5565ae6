"""``loop.host_s`` (s/check): the level loop's host work a check, the
mean over the window's checks of ``EngineResult.phases["dispatch"] +
phases["host"]`` (queueing the chunks' steps, and the loop's own
bookkeeping: root ingest, budgets, growth)."""


def read(run):
    if not run.checks:
        return None
    return sum(c["phases"].get("dispatch", 0.0) + c["phases"].get("host", 0.0)
               for c in run.checks) / len(run.checks)
