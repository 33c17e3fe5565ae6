"""``loop.unattributed_s`` (s/check): the time of a check that no phase
holds, the mean over the window's checks of its seconds (``run()`` and
the sync after it, on the harness's clock) less the sum of
``EngineResult.phases``."""


def read(run):
    if not run.checks:
        return None
    return sum(c["seconds"] - sum(c["phases"].values())
               for c in run.checks) / len(run.checks)
