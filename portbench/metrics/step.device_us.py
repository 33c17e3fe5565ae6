"""``step.device_us`` (us/batch): the chunks' device time a batch, from
the program's own CUDA events (no profiler): the sum of ``device_us``
over the sum of ``batches`` of the ``chunk`` spans in the engine's span
file of the last traced check (``.portbench/run/spans.json``).  It holds
the step's kernels, its PyTorch glue and the gaps between graph replays.
None where the spans carry no device time."""

import json
import os


def read(run):
    path = os.path.join(run.out_dir, "spans.json")
    if run.profile is None or not os.path.exists(path):
        return None
    with open(path) as f:
        events = json.load(f)
    chunks = [ev.get("args", {}) for ev in events
              if ev.get("ph") == "X" and ev.get("name") == "chunk"]
    chunks = [a for a in chunks if "device_us" in a and "batches" in a]
    batches = sum(a["batches"] for a in chunks)
    if not batches:
        return None
    return sum(a["device_us"] for a in chunks) / batches
