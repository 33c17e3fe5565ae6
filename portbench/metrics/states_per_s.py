"""``states_per_s`` (states/s): the distinct states of all the window's
checks over the window's whole wall time, the first check's start to
the last check's end (graph capture, each run's own set-up and the gaps
between checks included).  Host clock."""

from portbench import harness


def read(run):
    if not run.checks:
        return None
    start, end = harness.window_bounds(run.checks)
    return harness.rate(sum(c["distinct"] for c in run.checks), start, end)
