"""The reduction of a device trace: what ran on the card, and when.

A traced run holds ``torch.profiler`` open over a steady sub-window of
whole checks, each inside a ``record_function`` range named
``portbench.check``.  ``collect`` takes the profile's device operations
(kernels, copies, fills) and those ranges on one clock, in microseconds;
the rest works on plain tuples, so the tests feed it hand-made events:

- ``busy_us``: the union of the device intervals clipped to a window;
- ``idle_gaps``: the stretches of a window in which nothing ran;
- ``top_ops``: device time by operation name;
- ``short_name``: a kernel's own name out of its demangled signature.
"""

from __future__ import annotations

import collections
import re
from typing import Dict, List, Optional, Sequence, Tuple

#: (name, start us, end us)
Interval = Tuple[str, float, float]

MARK = "portbench.check"


def short_name(name: str) -> str:
    """``void (anonymous namespace)::lanes_kernel<false, false>(rtt::Dims,
    ...)`` -> ``lanes_kernel``; ``void at::native::elementwise_kernel<128,
    ...>(...)`` -> ``elementwise_kernel``; a name that is not a signature
    (``Memcpy DtoD (Device -> Device)``) is kept, an empty one is
    ``(unnamed)``."""
    plain = name.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:void\s+)?([A-Za-z_][\w:]*)(?=[<(])", plain)
    if m:
        return m.group(1).split("::")[-1][:64]
    return name[:64] if name.strip() else "(unnamed)"


def collect(prof) -> Tuple[List[Interval], List[Interval]]:
    """``(device operations, portbench ranges)`` of a finished profile,
    each ``(name, start us, end us)``, sorted by start."""
    from torch.autograd import DeviceType
    dev: List[Interval] = []
    marks: List[Interval] = []
    try:
        events = prof.profiler.kineto_results.events()
        rows = [(e.name(), e.device_type(), e.start_ns() / 1e3,
                 (e.start_ns() + e.duration_ns()) / 1e3,
                 e.is_user_annotation()) for e in events]
    except AttributeError:
        rows = [(e.name, e.device_type, e.time_range.start,
                 e.time_range.end, False) for e in prof.events()]
    for name, dtype, start, end, annotation in rows:
        if name == MARK:
            # The range is also mirrored onto the device's timeline as
            # an annotation, which is no device operation.
            if dtype != DeviceType.CUDA:
                marks.append((name, start, end))
        elif dtype == DeviceType.CUDA and not annotation:
            dev.append((name, start, end))
    dev.sort(key=lambda r: r[1])
    marks.sort(key=lambda r: r[1])
    return dev, marks


def clip(events: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The events that start inside ``[lo, hi)``, cut to end by ``hi``."""
    return [(n, s, min(e, hi)) for n, s, e in events if lo <= s < hi]


def merged(events: Sequence[Interval]) -> List[Tuple[float, float]]:
    """The union of the intervals, as disjoint sorted ``(start, end)``."""
    out: List[List[float]] = []
    for _n, s, e in sorted(events, key=lambda r: r[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(events: Sequence[Interval], lo: float, hi: float) -> float:
    return sum(e - s for s, e in merged(clip(events, lo, hi)))


def idle_gaps(events: Sequence[Interval], lo: float,
              hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` in which no device operation ran."""
    gaps, at = [], lo
    for s, e in merged(clip(events, lo, hi)):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def top_ops(events: Sequence[Interval], n: int = 10) -> List[list]:
    """``[[short name, device seconds], ...]``, the most time first."""
    by: Dict[str, float] = collections.defaultdict(float)
    for name, s, e in events:
        by[short_name(name)] += (e - s) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def span_at(spans: Sequence[Interval], t: float) -> Optional[str]:
    """The innermost span (the shortest) that holds time ``t``."""
    best = None
    for name, s, e in spans:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else None


def gaps_by_span(gaps: Sequence[Tuple[float, float]],
                 spans: Sequence[Interval], n: int = 10) -> List[list]:
    """Idle seconds summed by the host span open at each gap's middle
    (``between_spans`` where none was), the most first."""
    by: Dict[str, float] = collections.defaultdict(float)
    for s, e in gaps:
        by[span_at(spans, (s + e) / 2) or "between_spans"] += (e - s) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
