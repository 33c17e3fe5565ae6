"""``step.glue_us`` (us/batch): device microseconds a batch of the
operations that are not the port's own kernels (``PORT_KERNELS``, the
``__global__`` functions of ``raft_tla_tpu_torch/csrc``): PyTorch's
elementwise, copy, fill and reduction kernels around them."""

from portbench.devtrace import short_name

PORT_KERNELS = frozenset((
    "masks_kernel", "compact_scan_kernel", "lanes_kernel", "count_kernel",
    "probe_claim_kernel", "own_kernel", "resolve_kernel",
    "enqueue_count_kernel", "enqueue_tiles_kernel"))


def read(run):
    prof = run.profile
    if prof is None or not prof.dev:
        return None
    batches = sum(c["batches"] for c in prof.checks)
    glue = sum(e - s for name, s, e in prof.dev
               if short_name(name) not in PORT_KERNELS)
    return glue / batches if batches else None
