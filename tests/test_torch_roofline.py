"""The roofline's traffic walk (``obs/roofline.py`` ``TrafficDomain``,
``graph_traffic``, ``stage_traffic``) against the JAX package's
``jaxpr_traffic`` and ``stage_traffic``, on the CPU.

- Rule parity: small paired programs in ``jnp`` and ``torch`` that
  compute the same thing (a row gather, a reshape passthrough, a
  broadcast, an update into a passed-through buffer, a scatter-add, an
  elementwise chain, a kernel against a ``pallas_call``) give equal
  bytes read and written; launches are equal where both sides are the
  same ops, else the difference is pinned with its reason.  The view
  rule (a ``slice`` or a ``transpose`` is free in the port, an op that
  reads its operand in full in XLA) and the in-place writes into stage
  inputs, which the JAX rules do not have, are pinned here too.
- Stage floors at MCraft_bounded, B 2048, K 32,768 (v1, v3, v4, the
  swarm): each walked floor equals a count worked out by hand from the
  stage's tensors, and stands beside the JAX walk's with its exact
  difference and the reason for it; the launches (device ops) are
  pinned.
- Nothing runs during a walk (each plain version raises if entered, the
  wrappers' counters stay); a walk is memoised; a failed walk warns and
  leaves the engine's roofline empty; the advisor charges the PyTorch
  stages their device ops.

The JAX side: under jax 0.9 the call primitive that ``jax.jit`` leaves in
a jaxpr is named ``jit``, which the JAX ``analysis/interp.py``'s
``_CALL_PRIMS`` does not list (it knows ``pjit``), so its walk prices
every jitted stage as one opaque call.  Each JAX walk here runs with
``monkeypatch.setattr(raft_tla_tpu.analysis.interp, "_CALL_PRIMS",
_CALL_PRIMS + ("jit",))`` for its own duration only; no file of the JAX
package changes.
"""

import dataclasses
import io
import os
from contextlib import redirect_stderr

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

import raft_tla_tpu.analysis.interp as jinterp
from raft_tla_tpu.models.dims import RaftDims as JDims
from raft_tla_tpu.obs import roofline as jroofline
from raft_tla_tpu.ops.compact import kspread as j_kspread
from raft_tla_tpu.ops.compact_pallas import _compact_jit
from raft_tla_tpu_torch.obs import profile, roofline
from raft_tla_tpu_torch.obs.profile import kernel_modules
from raft_tla_tpu_torch.ops import compact_cuda
from raft_tla_tpu_torch.ops.compact import kspread as t_kspread
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")
B, K = 2048, 32768


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _entered(*a, **k):
    raise AssertionError("a kernel's plain version ran during a walk")


LAUNCHES_BEFORE = []


@pytest.fixture(autouse=True, scope="module")
def no_kernel_runs():
    """For the whole module: each kernel's plain version raises if it is
    entered, and the walks start from an empty memo, so every walk here
    is traced under that rule; the wrappers' counters are kept."""
    from raft_tla_tpu_torch.analysis.lint import kernel_sites
    LAUNCHES_BEFORE[:] = [m.launches for m in kernel_modules()]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(roofline, "_WALKS", {})
        for obj, attr, _label in kernel_sites():
            mp.setattr(obj, attr, _entered)
        yield


def jax_walk(fn, *args):
    """``jaxpr_traffic`` of ``fn`` with the jax-0.9 ``jit`` call
    primitive inlined for this call only."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinterp, "_CALL_PRIMS", jinterp._CALL_PRIMS + ("jit",))
        closed = jax.make_jaxpr(fn)(*args)
        flat, _ = jax.tree_util.tree_flatten(args)
        return jroofline.jaxpr_traffic(closed, flat)


def torch_walk(fn, *args):
    gm = make_fx(fn, tracing_mode="fake")(*args)
    return roofline.graph_traffic(gm, list(args))


def floors(t):
    return t["bytes_read"], t["bytes_written"]


# ---------------------------------------------------------------------------
# (a) Rule parity on paired programs

N, W, M = 64, 8, 16
RNG = np.random.default_rng(18)
X = RNG.integers(0, 100, (N, W), dtype=np.int32)
IDX = RNG.permutation(N)[:M].astype(np.int32)
UPD = RNG.integers(0, 100, (M, W), dtype=np.int32)
V = RNG.integers(0, 100, (W,), dtype=np.int32)


def t(a):
    return torch.from_numpy(np.array(a))


def test_row_gather():
    j = jax_walk(lambda x, i: x[i], jnp.asarray(X), jnp.asarray(IDX))
    p = torch_walk(lambda x, i: x.index_select(0, i), t(X), t(IDX))
    # The gathered rows of x and the index vector in full; the rows out.
    assert floors(p) == floors(j) == (M * W * 4 + M * 4, M * W * 4)
    # jnp indexing wraps negative indices (lt, add, select_n) before its
    # gather: three ops more than index_select.
    assert (p["launches"], j["launches"]) == (1, 4)


def test_reshape_passthrough():
    j = jax_walk(lambda x: x.reshape(N * W), jnp.asarray(X))
    p = torch_walk(lambda x: x.reshape(N * W), t(X))
    assert floors(p) == floors(j) == (0, 0)
    assert p["launches"] == j["launches"] == 0


def test_broadcast():
    j = jax_walk(lambda x, v: jnp.broadcast_to(v, (N, W)) + x,
                 jnp.asarray(X), jnp.asarray(V))
    p = torch_walk(lambda x, v: v.expand(N, W) + x, t(X), t(V))
    assert floors(p) == floors(j) == (N * W * 4 + W * 4, N * W * 4)
    assert p["launches"] == j["launches"] == 1


@pytest.mark.parametrize("in_place", [True, False])
def test_update_into_passed_through_buffer(in_place):
    j = jax_walk(lambda q, u: jax.lax.dynamic_update_slice(q, u, (8, 0)),
                 jnp.asarray(X), jnp.asarray(UPD))

    def port(q, u):
        at = torch.arange(8, 8 + M)
        return q.index_copy_(0, at, u) if in_place else \
            q.index_copy(0, at, u)

    p = torch_walk(port, t(X), t(UPD))
    # The update window of q read and written back, the update in full.
    assert floors(p) == floors(j) == (2 * M * W * 4, M * W * 4)
    # index_copy takes an index vector, which the port builds (arange).
    assert (p["launches"], j["launches"]) == (2, 1)


def test_scatter_add():
    acc = np.zeros(N, np.int32)
    vals = RNG.integers(0, 9, (M,), dtype=np.int32)
    j = jax_walk(lambda a, i, v: a.at[i].add(v), jnp.asarray(acc),
                 jnp.asarray(IDX), jnp.asarray(vals))
    p = torch_walk(lambda a, i, v: a.index_put_((i,), v, accumulate=True),
                   t(acc), t(IDX), t(vals))
    assert floors(p) == floors(j) == (M * 4 + M * 4 + M * 4, M * 4)
    # jnp wraps the indices (lt, add, select_n) and broadcasts them into
    # a scatter index (broadcast_in_dim is free) before the scatter-add.
    assert (p["launches"], j["launches"]) == (1, 4)


def test_elementwise_chain():
    y = RNG.integers(0, 100, (N, W), dtype=np.int32)
    j = jax_walk(lambda a, b: ((a + 1) * b) ^ 3, jnp.asarray(X),
                 jnp.asarray(y))
    p = torch_walk(lambda a, b: ((a + 1) * b) ^ 3, t(X), t(y))
    assert floors(p) == floors(j) == (2 * N * W * 4, N * W * 4)
    assert p["launches"] == j["launches"] == 3


def test_kernel_leaf_against_pallas_call():
    Bc, Gc, Kc = 8, 12, 128
    en = RNG.random((Bc, Gc)) < 0.3
    j = jax_walk(lambda e, s: _compact_jit(e, s, K=Kc, interpret=True),
                 jnp.asarray(en), j_kspread(Bc, Gc, Kc))

    def port(e, s):
        pt, lane_id, kvalid = compact_cuda.compact(e, Kc, s)
        return pt[0], pt[1], lane_id, kvalid

    with roofline.kernels_as_leaves():
        p = torch_walk(port, t(en), t_kspread(Bc, Gc, Kc, "cpu"))
    # Both read en and kspread in full (operand granularity) and write
    # P, total, lane_id and kvalid.
    assert floors(p) == floors(j) == (Bc * Gc + 4 * Kc, 4 + 4 + 4 * Kc + Kc)
    # The JAX compactor converts en to int32 before its pallas_call,
    # slices P and total out of [1] arrays and converts kvalid back to
    # bool after it; the port's kernel takes and gives those directly.
    assert (p["launches"], j["launches"]) == (1, 5)
    assert "kernel leaf: raft_walk::compact" in p["notes"]


def test_views_are_windows():
    """The one rule where the port departs from the JAX walk: a view
    launches nothing on the card, and what reads it reads its window."""
    j = jax_walk(lambda x: x[:, :3] + 1, jnp.asarray(X))
    p = torch_walk(lambda x: x[:, :3] + 1, t(X))
    assert floors(j) == (N * W * 4, N * 3 * 4)
    assert floors(p) == (N * 3 * 4, N * 3 * 4)
    assert (p["launches"], j["launches"]) == (1, 2)
    j = jax_walk(lambda x: x.T + 1, jnp.asarray(X))
    p = torch_walk(lambda x: x.T + 1, t(X))
    assert floors(p) == floors(j) == (N * W * 4, N * W * 4)
    assert (p["launches"], j["launches"]) == (1, 2)


def test_in_place_writes_into_stage_inputs():
    """What the JAX rules do not have: the port's stages write into the
    buffers they are given."""
    count = torch.zeros(1, dtype=torch.int32)

    def zero(c):
        c.zero_()
        return torch.ones(3)

    p = torch_walk(zero, count)            # overwritten, not read
    assert floors(p) == (0, 4 + 3 * 4) and p["launches"] == 2
    q = torch.zeros((N, W), dtype=torch.uint8)
    rows = torch.ones((5, W), dtype=torch.uint8)

    def window(qn, r):
        qn[10:15].copy_(r)
        return qn.sum()

    p = torch_walk(window, q, rows)        # a window of q written
    assert floors(p) == (N * W + 5 * W, 5 * W + 8)
    assert p["launches"] == 2
    p = torch_walk(lambda x: x.add_(1), t(X))  # read and written in full
    assert floors(p) == (N * W * 4, N * W * 4) and p["launches"] == 1
    p = torch_walk(lambda x, y: (x, y + 1), t(X), t(X))  # x returned as is
    assert floors(p) == (N * W * 4, N * W * 4)


# ---------------------------------------------------------------------------
# (b) Stage floors at the main path's sizes

DIMS = load_config(BOUNDED).dims
G, SW = DIMS.n_instances, 473
#: The walk's seen set: keys int64 [C] and size int64 [1] (the JAX one:
#: hi and lo uint32 [C] and size int32 [1]).
C = roofline.WALK_SEEN_CAPACITY
SEEN, JSEEN = 8 * C + 8, 8 * C + 4
#: The int64 StateBatch of B parents (its fields hold sw elements); the
#: JAX states hold int32 fields.
STATES, JSTATES = 8 * B * SW, 4 * B * SW
QNEXT = 2 * K * SW                      # the scratch queue, K + max(B, K)
RING = 16

#: The JAX walk's floors (bytes read, written, launches), as the live
#: JAX walk gives them with ``jit`` inlined; the swarm at the same
#: ``swarm_pipeline`` as the port.
JAX = {
    "v1": {"expand": (970752, 511639552, 1317),
           "fingerprint": (62128128, 62259200, 172),
           "dedup_insert": (425988, 163845, 126),
           "enqueue": (77529088, 15499264, 12)},
    "v3": {"masks": (970752, 4145152, 601),
           "compact": (270336, 163840, 35),
           "fingerprint": (4005888, 15761408, 2054),
           "insert_enqueue": (46923780, 31162373, 9)},
    "v4": {"front": (970752, 15925248, 9),
           "insert_enqueue": (46923780, 31162373, 9)},
    "swarm-v2": {"expand": (970752, 4415488, 601),
                 "choose": (270340, 8192, 103),
                 "latch": (3883008, 985088, 2077),
                 "ring_probe": (827392, 270340, 65)},
}

#: The tail of v3 and v4: reads the queue, krows, kh and kl (int64), kvalid,
#: cons_ok, the seen set and the count; writes the queue and the seen set
#: in full (the fused tail's operands), the zeroed count, is_new, fail
#: and the count it returns.  Launches: zero_, the five ops of
#: ``fpset.pack`` (ge, sub, where, mul, add) and the kernel.
TAIL = (QNEXT + K * SW + 16 * K + K + K + SEEN + 4,
        QNEXT + SEEN + 4 + K + 1 + 4, 7)

#: The port's floors worked out by hand from each stage's tensors, and
#: the launches (device ops) pinned; launches that are not a kernel and a
#: few ops are pinned as the walk counts them.
HAND = {
    "v1": {
        # rows and valid in; the parents (int64) for the lanes stage, the
        # candidates' packed rows and pack_ok, lane_id and kvalid out.
        "expand": (B * SW + B, STATES + B * G * SW + B * G + 4 * K + K,
                   1221),
        # The K candidate rows gathered and lane_id; kh, kl, krows and
        # cons_ok out.
        "fingerprint": (K * SW + 4 * K, 16 * K + K * SW + K, 316),
        # kh, kl, kvalid and the seen set; the seen set, is_new and fail.
        # Launches: ``pack``'s five ops and the insert kernel.
        "dedup_insert": (16 * K + K + SEEN, SEEN + K + 1, 6),
        # The queue (the kernel's operand, in full), krows, is_new,
        # cons_ok and the count; the queue, the zeroed count and the
        # count returned.  Launches: new & cons_ok, zero_, the kernel.
        "enqueue": (QNEXT + K * SW + K + K + 4, QNEXT + 4 + 4, 3)},
    "v3": {
        "masks": (B * SW + B, STATES + B * G, 360),
        "compact": (B * G, 4 * K + K, 1),
        # The parents in full (every field is hashed) and lane_id.
        "fingerprint": (STATES + 4 * K, 16 * K + K * SW + K, 2691),
        "insert_enqueue": TAIL},
    "v4": {
        # The front kernel reads rows and valid; the stage hands the
        # tail kh, kl, kvalid, krows and cons_ok.
        "front": (B * SW + B, 16 * K + K + K * SW + K, 1),
        "insert_enqueue": TAIL},
    "swarm-v2": {
        "expand": (B * SW + B, STATES + 2 * B * G, 359),
        # The sample number is a host int: only en is read.
        "choose": (B * G, 8 * B, 111),
        # The parents in full, the int64 choice; the rows and the two
        # int64 fingerprint halves.
        "latch": (STATES + 8 * B, B * SW + 16 * B, 776),
        # The int64 rings and cursors, both fingerprint halves, en and
        # ovf; the rings and cursors out.
        "ring_probe": (16 * B * RING + 8 * B + 16 * B + 2 * B * G,
                       16 * B * RING + 8 * B, 25)},
}

#: Port minus JAX, bytes read and written, stage by stage, with the
#: reasons.  The JAX walk's launches are XLA's pre-fusion equations of
#: another program (the JAX stages are written over an unpacked pytree),
#: so the launch columns are both pinned, not derived from each other.
DIFF = {
    "v1": {
        # The JAX candidates are an unpacked int32 pytree (4 bytes an
        # element), the port's packed uint8 rows with pack_ok; the port
        # also hands on the parents (int64) for the trace's parent
        # fingerprints.
        "expand": (0, -3 * B * G * SW + B * G + STATES),
        # The gather reads packed rows (1 byte an element, not 4); the
        # JAX stage writes the gathered int32 states, the port the packed
        # krows, int64 kh/kl and cons_ok.
        "fingerprint": (-3 * K * SW, -3 * K * SW + 8 * K + K),
        # kh/kl int64 (+8K), the seen set's size int64 (+4).
        "dedup_insert": (8 * K + 4, 4),
        # JAX reads the K unpacked states (4K*sw) and a K-row queue and
        # counts its scatter's window; the port reads the packed krows
        # and its kernel reads and writes the 2K-row queue in full,
        # reads cons_ok and the count, zeroes and returns the count.
        "enqueue": (-2 * K * SW + K + 4, K * SW + 8)},
    "v3": {
        "masks": (0, 4 * B * SW),                 # int64 states
        "compact": (0, 0),
        # int64 states read; int64 kh/kl and the constraint's lanes
        # written (the JAX tail makes its own all-true cons).
        "fingerprint": (4 * B * SW, 8 * K + K),
        # int64 kh/kl, cons_ok, the int64 size, the count read; the
        # size's 4 more bytes, the zeroed count and the count returned.
        "insert_enqueue": (8 * K + K + 4 + 4, 4 + 4 + 4)},
    "v4": {
        "front": (0, 8 * K + K - 4 * K),   # kh/kl int64, cons_ok; no lane_id
        "insert_enqueue": (8 * K + K + 4 + 4, 4 + 4 + 4)},
    "swarm-v2": {
        "expand": (0, 4 * B * SW),                # int64 states
        "choose": (-4, 4 * B),    # k a host int; the choice int64
        "latch": (4 * B * SW + 4 * B, 8 * B),     # int64 states, fps
        # int64 rings, cursors and fingerprints; JAX also returns the
        # accepted count (4 bytes).
        "ring_probe": (8 * B * RING + 4 * B + 8 * B,
                       8 * B * RING + 4 * B - 4)},
}

PIPES = ["v1", "v3", "v4", "swarm-v2"]


def _args(pipe):
    if pipe.startswith("swarm"):
        return dict(pipeline="swarm", swarm_pipeline=pipe[-2:]), G
    return dict(pipeline=pipe), K


@pytest.mark.parametrize("pipe", PIPES)
def test_stage_floors_by_hand_and_against_jax(pipe):
    kw, k = _args(pipe)
    got = roofline.stage_traffic(DIMS, B, k, ring=RING, **kw)
    assert tuple(got) == tuple(HAND[pipe])
    assert {s: (r["bytes_read"], r["bytes_written"], r["launches"])
            for s, r in got.items()} == HAND[pipe]
    for r in got.values():
        assert r["bytes_total"] == r["bytes_read"] + r["bytes_written"]
        assert (r["while_launches"], r["collectives"],
                r["collectives_in_loop"]) == (0, 0, 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinterp, "_CALL_PRIMS", jinterp._CALL_PRIMS + ("jit",))
        jgot = jroofline.stage_traffic(
            JDims(**dataclasses.asdict(DIMS)), B, k, ring=RING,
            **({"pipeline": "swarm", "swarm_pipeline": pipe[-2:]}
               if pipe.startswith("swarm") else {"pipeline": pipe}))
    assert {s: (r["bytes_read"], r["bytes_written"], r["launches"])
            for s, r in jgot.items()} == JAX[pipe]
    for s in got:
        assert (got[s]["bytes_read"] - jgot[s]["bytes_read"],
                got[s]["bytes_written"] - jgot[s]["bytes_written"]) \
            == DIFF[pipe][s], s
        assert set(got[s]) == set(jgot[s])


# ---------------------------------------------------------------------------
# (c) Nothing runs, (d) memoised, a failed walk, (e) the advisor


def test_nothing_runs_during_a_walk():
    """Every walk of this module ran with each plain version raising if
    entered (``no_kernel_runs``): here the v1 and v4 walks, whose leaves
    are all five kernels."""
    from raft_tla_tpu_torch.analysis.lint import kernel_sites
    leaves = set()
    for pipe in ("v1", "v4"):
        got = roofline.stage_traffic(DIMS, B, K, pipeline=pipe)
        leaves |= {n for r in got.values() for n in r["notes"]
                   if n.startswith("kernel leaf")}
    assert leaves == {f"kernel leaf: raft_walk::{k}" for k in (
        "compact", "fpset_insert", "fused_tail", "enqueue", "chunk_front")}
    assert [m.launches for m in kernel_modules()] == LAUNCHES_BEFORE
    # The sites are put back after each walk, and a stand-in never runs
    # on real tensors.
    for obj, attr, _label in kernel_sites():
        assert getattr(obj, attr) is _entered
    with pytest.raises(RuntimeError, match="never runs"):
        torch.ops.raft_walk.compact(torch.zeros((2, 3), dtype=torch.bool),
                                    torch.zeros(4, dtype=torch.int32))


def test_walk_is_memoised(monkeypatch):
    monkeypatch.setattr(roofline, "_WALKS", {})
    calls = []
    monkeypatch.setattr(roofline, "_walk", lambda *a: calls.append(a) or {
        "front": {"launches": 1}})
    one = roofline.stage_traffic(DIMS, 64, 1024, pipeline="v4")
    two = roofline.stage_traffic(DIMS, 64, 1024, pipeline="v4")
    # The swarm's ring and expansion do not key a BFS walk.
    three = roofline.stage_traffic(DIMS, 64, 1024, pipeline="v4", ring=8,
                                   swarm_pipeline="v1")
    assert len(calls) == 1
    assert one == two == three and one is not two
    one["front"]["launches"] = -1
    assert roofline.stage_traffic(DIMS, 64, 1024,
                                  pipeline="v4")["front"]["launches"] == 1
    # v1 takes the split tail for "fused": one walk for both names.
    roofline.stage_traffic(DIMS, 64, 1024, pipeline="v1")
    roofline.stage_traffic(DIMS, 64, 1024, pipeline="v1",
                           enqueue_method="kernel")
    assert len(calls) == 2
    assert calls[1][3:5] == ("v1", "kernel")


def test_failed_walk_warns_and_builds_the_engine(monkeypatch):
    from raft_tla_tpu_torch.engine.bfs import BFSEngine, EngineConfig

    def broken(*a):
        raise RuntimeError("no trace")

    monkeypatch.setattr(roofline, "_WALKS", {})
    monkeypatch.setattr(roofline, "_walk", broken)
    err = io.StringIO()
    with redirect_stderr(err):
        eng = BFSEngine(DIMS, config=EngineConfig(
            batch=64, queue_capacity=1 << 12, seen_capacity=1 << 14,
            perf=True, pipeline="v3"), device="cpu")
    assert "perf: BFSEngine roofline walk unavailable (RuntimeError: no " \
           "trace); continuing without" in err.getvalue()
    assert eng._perf is not None and eng._perf.traffic is None
    summary = eng._perf.summary({"masks": 1e-3})
    assert summary["roofline"]["stages"] == {}
    assert summary["advisor"]["top"] is None


@pytest.mark.parametrize("pipe", PIPES)
def test_advisor_charges_pytorch_stages(pipe):
    kw, k = _args(pipe)
    rows = roofline.build_roofline(
        roofline.stage_traffic(DIMS, B, k, ring=RING, **kw), None,
        {"bytes_per_sec": 3.35e12, "source": "test"})
    adv = roofline.advise(rows, 5e-6)
    assert adv["top"] in rows and adv["top"] in adv["verdict"]
    ranked = {r["stage"]: r for r in adv["ranking"]}
    for s, r in rows.items():
        assert r["launches"] > 0
        assert ranked[s]["launch_tax_seconds"] == pytest.approx(
            r["launches"] * 5e-6, abs=1e-6)
    if pipe == "v3":
        assert rows["masks"]["launches"] == 360
        assert rows["fingerprint"]["launches"] == 2691
        assert adv["top"] == "fingerprint"


def test_walked_stages_are_the_profilers():
    """The chain ``ChunkProfiler`` runs is the one the walk traces: the
    same stages, names and order."""
    for pipe, stages in [("v1", profile.STAGES), ("v3", profile.STAGES_V3),
                         ("v4", profile.STAGES_V4),
                         ("swarm", profile.STAGES_SWARM)]:
        chain = profile.build_stage_chain(DIMS, 8, 1024, "cpu",
                                          pipeline=pipe)
        assert tuple(s.name for s in chain) == stages
        k = G if pipe == "swarm" else K
        assert tuple(roofline.stage_traffic(DIMS, B, k, ring=RING,
                                            pipeline=pipe)) == stages


def test_chip_smoke_pins_are_the_hand_counts():
    """``chip_smoke.py`` holds the walk on the card's host to these pins."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.WALK_PINS == {
        "v1": HAND["v1"], "v3": HAND["v3"], "v4": HAND["v4"],
        "swarm": HAND["swarm-v2"]}
