"""The control (the reference one precision down, ``control.py``) comes
out not correct.  At a cell's size on the chip it runs with 32-bit keys;
at a size a test can hold, 32 bits collide too rarely to show, so these
runs take 12-bit keys on MCraft_bounded to depth 5 (2,300 states, a few
hundred colliding pairs), and a 64-bit key passes."""

import pytest

from portbench.reference import control


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails(seed):
    got = control.run_control("mcraft_bounded", 5, seed, bits=12)
    assert got["correct"] is False
    assert got["compared"]["distinct_gap"]["value"] > 0
    assert got["compared"]["action_gap"]["value"] > 0
    assert got["distinct"] < 2300


def test_seeds_change_the_collisions():
    a = control.run_control("mcraft_bounded", 5, 1, bits=12)
    b = control.run_control("mcraft_bounded", 5, 2, bits=12)
    assert a["levels"] != b["levels"] or a["distinct"] != b["distinct"]


def test_a_64_bit_key_passes():
    got = control.run_control("mcraft_bounded", 5, 1, bits=64)
    assert got["correct"] is True
