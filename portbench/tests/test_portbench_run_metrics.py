"""The readers of the run's own phases and chunk device time, on
hand-made checks and span files."""

import json
import types

import pytest

from conftest import REPO
from portbench import harness

BASE = REPO + "/portbench"


def reader(name):
    return harness.metric_reader(name, BASE).read


def check(seconds, **phases):
    return {"seconds": seconds, "phases": phases}


def test_run_overhead_is_the_mean_of_setup_and_finish():
    run = types.SimpleNamespace(checks=[
        check(0.2, setup=0.010, dispatch=0.1, finish=0.002),
        check(0.3, setup=0.004, dispatch=0.2, finish=0.004)])
    assert reader("loop.run_overhead_s")(run) == pytest.approx(0.010)


def test_run_overhead_needs_the_phases():
    """A program that times no set-up phase gives nothing to read."""
    assert reader("loop.run_overhead_s")(
        types.SimpleNamespace(checks=[check(0.2, dispatch=0.1)])) is None
    assert reader("loop.run_overhead_s")(
        types.SimpleNamespace(checks=[])) is None


def test_unattributed_is_the_mean_of_seconds_less_the_phases():
    run = types.SimpleNamespace(checks=[
        check(0.2, setup=0.01, dispatch=0.15, finish=0.03),
        check(0.3, setup=0.01, sync=0.25, finish=0.02)])
    assert reader("loop.unattributed_s")(run) == pytest.approx(0.015)
    assert reader("loop.unattributed_s")(
        types.SimpleNamespace(checks=[])) is None


def span(name, **args):
    ev = {"name": name, "ph": "X", "ts": 1.0, "dur": 1.0, "pid": 1,
          "tid": 1}
    if args:
        ev["args"] = args
    return ev


def traced_run(tmp_path, events, profile=True):
    (tmp_path / "spans.json").write_text(json.dumps(events))
    return types.SimpleNamespace(out_dir=str(tmp_path),
                                 profile=object() if profile else None)


def test_device_us_is_the_chunks_device_time_a_batch(tmp_path):
    run = traced_run(tmp_path, [
        {"name": "clock", "ph": "M", "pid": 1, "tid": 0, "args": {}},
        span("chunk", device_us=9000.0, batches=32),
        span("chunk", device_us=1000.0, batches=8),
        span("stats_fetch"), span("level", batches=99)])
    assert reader("step.device_us")(run) == pytest.approx(250.0)


def test_device_us_reads_nothing_without_device_time(tmp_path):
    """The CPU, or a program whose chunk spans carry no device time."""
    assert reader("step.device_us")(traced_run(
        tmp_path, [span("chunk"), span("chunk", batches=4)])) is None
    assert reader("step.device_us")(traced_run(
        tmp_path, [span("chunk", device_us=5.0, batches=1)],
        profile=False)) is None
    assert reader("step.device_us")(types.SimpleNamespace(
        out_dir=str(tmp_path / "none"), profile=object())) is None
