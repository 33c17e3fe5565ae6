"""``front.generated_per_distinct`` (states/state): the states the
program generated over the distinct states it found, the sums of
``generated`` and ``distinct`` over the window's checks.  The v4 front's
lanes launch evaluates the invariant list on every lane it expands, one
a generated state, so while the list is evaluated there this is its
evaluations a distinct state; TLC evaluates it once a distinct state,
1.0.  A change to where the list is evaluated needs a counted metric of
its own.  None without checks."""


def read(run):
    distinct = sum(c["distinct"] for c in run.checks)
    if not distinct:
        return None
    return sum(c["generated"] for c in run.checks) / distinct
