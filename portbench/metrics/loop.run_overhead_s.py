"""``loop.run_overhead_s`` (s/check): the run's own set-up and end a check,
the mean over the window's checks of ``EngineResult.phases["setup"] +
phases["finish"]`` (``engine/bfs.py``: ``run()``'s entry to the first
chunk less the phases nested in it, and the run's end: the report, the
graphs dropped, the span file).  None where the program times neither
phase."""


def read(run):
    checks = [c for c in run.checks if "setup" in c["phases"]]
    if not checks or len(checks) != len(run.checks):
        return None
    return sum(c["phases"]["setup"] + c["phases"].get("finish", 0.0)
               for c in checks) / len(checks)
