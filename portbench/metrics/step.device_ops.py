"""``step.device_ops`` (ops/batch): the device operations (kernels,
copies, fills) of the traced sub-window over the batches its checks
expanded (``EngineResult.batches``)."""


def read(run):
    prof = run.profile
    if prof is None or not prof.dev:
        return None
    batches = sum(c["batches"] for c in prof.checks)
    return len(prof.dev) / batches if batches else None
