"""``fused_tail_roofline`` (%): B2, the fused tail (probe, insert and
enqueue; ``ops/fused_tail_cuda.py``, ``csrc/fused_tail.cu``), against the
card's memory bandwidth: the least bytes its work needs over (its device
time x the card's bytes a second), in percent.

The least bytes come from the traced checks' own counts, never from the
table slots or queue rows the port allocates: each successor generated
has its 64-bit fingerprint and its verdict byte read once; each novel
state has its key written once into the seen set; each novel state that
passes the constraint has its row read once and written once into the
next level's queue.  The roots, which the level loop ingests itself, are
not the tail's.  The device time is the sum of the tail's launches
(``KERNELS``, names from a trace on the card); a trace without every
one of them gives no share."""

from portbench.devtrace import short_name

KERNELS = frozenset(("probe_claim_kernel", "own_kernel", "resolve_kernel",
                     "enqueue_tiles_kernel"))
KEY_BYTES, VERDICT_BYTES = 8, 1


def novel(check: dict, n_roots: int) -> int:
    return check["distinct"] - n_roots


def enqueued(check: dict) -> int:
    """Rows the tail wrote: the frontier of every level above the roots."""
    return sum(check["levels"][1:])


def least_bytes(checks, row_bytes: int, n_roots: int) -> int:
    return sum(c["generated"] * (KEY_BYTES + VERDICT_BYTES)
               + novel(c, n_roots) * KEY_BYTES
               + 2 * enqueued(c) * row_bytes for c in checks)


def share(nbytes: float, seconds: float, bytes_per_s: float):
    if seconds <= 0:
        return None
    return 100.0 * nbytes / (seconds * bytes_per_s)


def read(run):
    prof = run.profile
    peak = run.peaks.get(run.device_kind or "")
    if prof is None or peak is None or not run.row_bytes:
        return None
    mine = [(short_name(name), s, e) for name, s, e in prof.dev]
    found = {n for n, _s, _e in mine if n in KERNELS}
    if found != KERNELS:
        # A launch of the stage is missing or renamed: its time would be
        # short, and the share too high.
        return None
    seconds = sum(e - s for n, s, e in mine if n in KERNELS) / 1e6
    return share(least_bytes(prof.checks, run.row_bytes, run.n_roots),
                 seconds, peak["hbm_bytes_per_s"])
