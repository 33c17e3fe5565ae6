"""``front.lanes_ns_per_state`` (ns/state): the device time of the v4
front's lanes launch (``lanes_kernel``, where the successors are built
and the invariants run, on every lane it expands) over the states it
expanded: the sum of its launches' device nanoseconds in the traced
sub-window over the sum of ``generated`` of the profiled checks.  None
where the trace holds no such launch."""

from portbench.devtrace import short_name

KERNEL = "lanes_kernel"


def read(run):
    prof = run.profile
    if prof is None or not prof.dev or not prof.checks:
        return None
    states = sum(c["generated"] for c in prof.checks)
    ns = sum(e - s for name, s, e in prof.dev
             if short_name(name) == KERNEL) * 1e3
    if not states or not ns:
        return None
    return ns / states
