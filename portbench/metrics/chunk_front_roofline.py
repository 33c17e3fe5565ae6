"""``chunk_front_roofline`` (%): B4, the v4 chunk front
(``ops/chunk_front_cuda.py``, ``csrc/chunk_front.cu``), against the card's
memory bandwidth: the least bytes the front's work needs over (its
device time x the card's bytes a second), in percent.

The least bytes come from the traced checks' own counts, never from the
buffers the port allocates: each parent expanded has its row read once
(the row bytes of the program's layout), and each successor generated
has its 64-bit fingerprint and one byte of verdicts (constraint,
invariant) written once.  Any implementation of the expansion moves at
least that; the successor rows themselves are counted where the novel
ones are written, in the tail.  The device time is the sum of the
front's launches (``KERNELS``, names from a trace on the card); a
trace without every one of them gives no share."""

from portbench.devtrace import short_name

KERNELS = frozenset(("masks_kernel", "compact_scan_kernel", "lanes_kernel"))
FINGERPRINT_BYTES, VERDICT_BYTES = 8, 1


def expanded(check: dict) -> int:
    """Parents expanded: the frontier of every level below the last."""
    return sum(check["levels"][:check["diameter"]])


def least_bytes(checks, row_bytes: int) -> int:
    return sum(expanded(c) * row_bytes
               + c["generated"] * (FINGERPRINT_BYTES + VERDICT_BYTES)
               for c in checks)


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
    return share(least_bytes(prof.checks, run.row_bytes), seconds,
                 peak["hbm_bytes_per_s"])
