"""``reconfig_front_roofline`` (%): B4, the v4 chunk front
(``ops/chunk_front_cuda.py``, ``csrc/chunk_front.cu``) in the
reconfiguration variant's builds (``kReconfig``: 474-byte rows with the
value high-byte planes, twelve families, the ``reconfig_suite`` build
launch), against the card's memory bandwidth: the least bytes the
front's work needs over (its device time x the card's bytes a second),
in percent.

The least bytes, counted from the traced checks' own counts and never
from the buffers the port allocates (``least_bytes``): each parent
expanded has its row read once (``run.row_bytes``, the program's row
width: 474 B at reconfig3's dims), and each successor generated has its
64-bit fingerprint and one byte of verdicts (constraint, invariant)
written once.  Any implementation of the expansion moves at least that,
so the share reads under 100% by construction; the successor rows are
counted where the novel ones are written, in the tail.  The device time
is the sum of the front's launches (``KERNELS``: the masks, the
compaction and both halves of the lanes launch, names from a trace on
the card); a trace without every one of them gives no share."""

from portbench.devtrace import short_name

KERNELS = frozenset(("masks_kernel", "compact_scan_kernel", "lanes_kernel"))
FINGERPRINT_BYTES, VERDICT_BYTES = 8, 1


def expanded(check: dict) -> int:
    """Parents expanded: the frontier of every level below the last."""
    return sum(check["levels"][:check["diameter"]])


def least_bytes(checks, row_bytes: int) -> int:
    """Rows read once a parent expanded, a fingerprint and a verdict byte
    written once a successor generated."""
    return sum(expanded(c) * row_bytes
               + c["generated"] * (FINGERPRINT_BYTES + VERDICT_BYTES)
               for c in checks)


def read(run):
    prof = run.profile
    peak = run.peaks.get(run.device_kind or "")
    if prof is None or peak is None or not run.row_bytes:
        return None
    mine = [(short_name(name), s, e) for name, s, e in prof.dev]
    if {n for n, _s, _e in mine if n in KERNELS} != KERNELS:
        # A launch of the stage is missing or renamed: its time would be
        # short, and the share too high.
        return None
    seconds = sum(e - s for n, s, e in mine if n in KERNELS) / 1e6
    if seconds <= 0:
        return None
    return 100.0 * least_bytes(prof.checks, run.row_bytes) / (
        seconds * peak["hbm_bytes_per_s"])
