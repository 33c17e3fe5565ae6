"""``front.joint_per_distinct`` (states/state): the distinct states the
program built under a joint configuration over the distinct states it
found, the sums of ``joint`` and ``distinct`` over the window's checks.
``joint`` (``EngineResult.joint``) is counted by the reconfiguration
variant's build launch: the built successors in which some server's
latest config entry is joint (C_old,new), where BecomeLeader and
AdvanceCommitIndex take majorities of both configurations.  None where
the checks carry no ``joint`` (a program without the counter) or found
no state."""


def read(run):
    checks = run.checks
    distinct = sum(c["distinct"] for c in checks)
    if not distinct or any("joint" not in c for c in checks):
        return None
    return sum(c["joint"] for c in checks) / distinct
