"""The rooflines' byte counts and the trace reduction on hand counts."""

import types

import pytest

from conftest import REPO
from portbench import devtrace, harness

BASE = REPO + "/portbench"
FRONT = harness.metric_reader("chunk_front_roofline", BASE)
TAIL = harness.metric_reader("fused_tail_roofline", BASE)
H100 = "NVIDIA H100 80GB HBM3"
BW = 3.35e12

#: MCraft_bounded to L11 from the one root (BASELINE.md's profile).
L11 = {"levels": [1, 3, 18, 79, 318, 1218, 4433, 15510, 52467, 172129,
                  548904, 1703703], "diameter": 11, "distinct": 6005282,
       "generated": 17354955, "batches": 537}


def test_front_bytes_by_hand():
    # Parents: every level but the last, 795,080 rows of 473 bytes;
    # successors: 17,354,955 x (8 + 1).
    assert FRONT.expanded(L11) == 795080
    assert FRONT.least_bytes([L11], 473) == 795080 * 473 + 17354955 * 9
    assert FRONT.least_bytes([L11, L11], 473) == \
        2 * FRONT.least_bytes([L11], 473)


def test_tail_bytes_by_hand():
    # Probe: 17,354,955 x (8 + 1); insert: 6,005,281 novel keys x 8; rows
    # enqueued (every level above the root) 2,498,782 x 473, read and
    # written.
    assert TAIL.enqueued(L11) == 2498782
    assert TAIL.novel(L11, 1) == 6005281
    assert TAIL.least_bytes([L11], 473, 1) == (
        17354955 * 9 + 6005281 * 8 + 2 * 2498782 * 473)


def test_tiny_hand_check():
    c = {"levels": [1, 2, 3], "diameter": 2, "distinct": 8, "generated": 10}
    assert FRONT.least_bytes([c], 100) == 3 * 100 + 10 * 9
    assert TAIL.least_bytes([c], 100, 1) == 10 * 9 + 7 * 8 + 2 * 5 * 100


def profile_with(names_us, checks):
    dev, at = [], 0.0
    for name, us in names_us:
        dev.append((name, at, at + us))
        at += us
    return types.SimpleNamespace(dev=dev, checks=checks,
                                 marks=[("portbench.check", 0.0, at)])


def test_shares_against_the_card_peak():
    c = {"levels": [1, 2, 3], "diameter": 2, "distinct": 8, "generated": 10}
    prof = profile_with([
        ("void (anonymous namespace)::lanes_kernel<false, false>(Dims)", 1.0),
        ("void (anonymous namespace)::masks_kernel<false>(Dims)", 0.5),
        ("rtt::compact_scan_kernel(unsigned char const*)", 0.5),
        ("probe_claim_kernel(unsigned long long const*, int)", 1.0),
        ("own_kernel(int const*, int, int*)", 0.25),
        ("resolve_kernel(int const*, int, int*)", 0.25),
        ("void enqueue_tiles_kernel<64>(unsigned char const*)", 0.5),
        ("void at::native::elementwise_kernel<128, 4>(int, F)", 5.0)], [c])
    run = types.SimpleNamespace(profile=prof, row_bytes=100, n_roots=1,
                                device_kind=H100,
                                peaks={H100: {"hbm_bytes_per_s": BW}})
    assert FRONT.read(run) == pytest.approx(
        100 * (3 * 100 + 10 * 9) / (2e-6 * BW))
    assert TAIL.read(run) == pytest.approx(
        100 * (10 * 9 + 7 * 8 + 2 * 5 * 100) / (2e-6 * BW))
    glue = harness.metric_reader("step.glue_us", BASE)
    ops = harness.metric_reader("step.device_ops", BASE)
    c["batches"] = 2
    assert glue.read(run) == pytest.approx(2.5)
    assert ops.read(run) == 4.0
    # One launch of a stage missing from the trace: no share at all.
    prof.dev[:] = [d for d in prof.dev if "own_kernel" not in d[0]
                   and "masks_kernel" not in d[0]]
    assert FRONT.read(run) is None and TAIL.read(run) is None


def test_no_kernel_no_card_no_share():
    c = {"levels": [1, 2], "diameter": 1, "distinct": 3, "generated": 2}
    prof = profile_with([("elementwise_kernel(int)", 4.0)], [c])
    run = types.SimpleNamespace(profile=prof, row_bytes=100, n_roots=1,
                                device_kind=H100,
                                peaks={H100: {"hbm_bytes_per_s": BW}})
    assert FRONT.read(run) is None and TAIL.read(run) is None
    run.device_kind = "some other card"
    prof.dev.append(("lanes_kernel(int)", 4.0, 5.0))
    assert FRONT.read(run) is None
    run.profile = None
    assert FRONT.read(run) is None


def test_busy_gaps_and_spans():
    dev = [("a", 1.0, 3.0), ("b", 2.0, 4.0), ("c", 6.0, 7.0),
           ("d", 9.0, 12.0)]
    assert devtrace.merged(dev) == [(1.0, 4.0), (6.0, 7.0), (9.0, 12.0)]
    assert devtrace.busy_us(dev, 0.0, 10.0) == 3.0 + 1.0 + 1.0
    assert devtrace.idle_gaps(dev, 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0),
                                                 (7.0, 9.0)]
    spans = [("run", 0.0, 10.0), ("level", 3.0, 8.0), ("chunk", 4.5, 5.5)]
    assert devtrace.span_at(spans, 5.0) == "chunk"
    assert devtrace.span_at(spans, 8.5) == "run"
    assert devtrace.span_at(spans, 11.0) is None
    got = devtrace.gaps_by_span([(0.0, 1.0), (4.0, 6.0), (7.0, 9.0),
                                 (10.5, 11.5)], spans)
    assert got == [["chunk", 2e-6], ["level", 2e-6], ["run", 1e-6],
                   ["between_spans", 1e-6]]
    idle = harness.metric_reader("device.idle_pct.bfs", BASE)
    prof = types.SimpleNamespace(dev=dev, marks=[("m", 0.0, 10.0)],
                                 busy_us=5.0, window_us=10.0)
    assert idle.read(types.SimpleNamespace(profile=prof)) == 50.0


def test_top_ops_and_short_names():
    assert devtrace.short_name(
        "void rtt::lanes_kernel<3>(rtt::Dims, unsigned char const*)") \
        == "lanes_kernel"
    assert devtrace.short_name(
        "void (anonymous namespace)::lanes_kernel<false, false>(rtt::Dims, "
        "unsigned char const*)") == "lanes_kernel"
    assert devtrace.short_name(
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "(anonymous namespace)::f<bool>, std::array<char*, 2ul> >(int, F)") \
        == "vectorized_elementwise_kernel"
    assert devtrace.short_name("Memcpy DtoD (Device -> Device)") == \
        "Memcpy DtoD (Device -> Device)"
    assert devtrace.short_name("") == "(unnamed)"
    dev = [("k(int)", 0.0, 3.0), ("j(int)", 3.0, 4.0), ("k(int)", 5.0, 6.0)]
    assert devtrace.top_ops(dev) == [["k", 4e-6], ["j", 1e-6]]
