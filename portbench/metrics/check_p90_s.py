"""``check_p90_s`` (s): the 90th percentile, by nearest rank, of the
seconds of every check in the window, each from its ``run()`` call to
its return on the host clock.  At 100 checks or more a window, ten or
more lie beyond it."""

from portbench import harness

QUANTILE = 0.9


def read(run):
    return harness.nearest_rank([c["seconds"] for c in run.checks], QUANTILE)
