"""``loop.capture_s`` (s/check): CUDA graph capture a check, the mean
over the window's checks of ``EngineResult.phases["capture"]`` (the
level loop's own host timer, ``engine/bfs.py``)."""


def read(run):
    if not run.checks:
        return None
    return sum(c["phases"].get("capture", 0.0)
               for c in run.checks) / len(run.checks)
