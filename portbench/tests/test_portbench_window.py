"""The window's arithmetic on hand examples."""

import time
import types

import pytest

from conftest import REPO
from portbench import harness

BASE = REPO + "/portbench"


def checks_of(spans, distinct=10):
    return [{"t_start": s, "t_end": e, "seconds": e - s,
             "distinct": distinct} for s, e in spans]


def test_rate_counts_all_the_window_time_gaps_included():
    checks = checks_of([(0.0, 1.0), (1.5, 2.0), (2.0, 4.0)])
    start, end = harness.window_bounds(checks)
    assert (start, end) == (0.0, 4.0)
    assert harness.rate(30, start, end) == 7.5
    run = types.SimpleNamespace(checks=checks)
    assert harness.metric_reader("states_per_s", BASE).read(run) == 7.5
    assert harness.rate(1, 2.0, 2.0) is None


@pytest.mark.parametrize("n,expect", [(1, 1), (9, 9), (10, 9), (11, 10),
                                      (100, 90), (101, 91), (119, 108)])
def test_p90_is_the_nearest_rank_over_all_checks(n, expect):
    values = [float(i) for i in range(n, 0, -1)]
    assert harness.nearest_rank(values, 0.9) == expect
    run = types.SimpleNamespace(checks=checks_of(
        [(0.0, v) for v in values]))
    assert harness.metric_reader("check_p90_s", BASE).read(run) == expect


def test_p90_of_nothing_is_nothing():
    assert harness.nearest_rank([], 0.9) is None


def test_a_check_past_the_deadline_runs_whole_and_counts():
    """The window's loop: a check that starts before the deadline runs to
    its end, and its states and seconds are the window's."""
    kind = harness.traffic_kind("exhaustive_repeat", BASE)

    class Engine:
        calls = 0

        def run(self, roots):
            Engine.calls += 1
            time.sleep(0.3)
            return types.SimpleNamespace(
                distinct=100, generated=200, diameter=3, levels=[1, 2, 3, 4],
                stop_reason="diameter_budget", violation=None,
                deadlock=None, action_counts={"Timeout": 200},
                phases={"capture": 0.0}, batches=1, steps=1, chunks=1)

    run = types.SimpleNamespace(device="cpu")
    state = kind.State(Engine(), [None])
    t = time.perf_counter()
    checks = kind.window(state, run, 0.5)
    assert len(checks) == Engine.calls == 2
    assert checks[-1]["t_end"] - t >= 0.6 - 0.01
    start, end = harness.window_bounds(checks)
    r = harness.metric_reader("states_per_s", BASE).read(
        types.SimpleNamespace(checks=checks))
    assert r == pytest.approx(200 / (end - start))
    assert harness.metric_reader("loop.capture_s", BASE).read(
        types.SimpleNamespace(checks=checks)) == 0.0
