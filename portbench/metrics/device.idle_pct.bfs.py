"""``device.idle_pct.bfs`` (%): the share of the traced checks' time in
which no device operation ran: 100 * (1 - the union of the device
intervals / the checks' ranges)."""


def read(run):
    prof = run.profile
    if prof is None or not prof.marks or not prof.dev:
        return None
    return 100.0 * (1.0 - prof.busy_us / prof.window_us)
