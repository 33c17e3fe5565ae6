"""Each kernel module's plain version vs the JAX Pallas kernel it replaces.

The Pallas kernels run in interpret mode, as the JAX package's own tests
run them on the CPU; on CPU tensors the port's wrappers take their plain
versions, so these are the contracts the CUDA kernels are held to on the
card (chip_smoke.py).  All comparisons are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tla_tpu.ops import compact as jcompact
from raft_tla_tpu.ops import compact_pallas, fpset_pallas, fused_tail_pallas
from raft_tla_tpu.ops import fpset as jfpset
from raft_tla_tpu_torch.ops import compact as tcompact
from raft_tla_tpu_torch.ops import compact_cuda, fpset_cuda, fused_tail_cuda
from raft_tla_tpu_torch.ops import fpset as tfpset


def _i64(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _keys(pairs):
    """[n, 2] uint32 (hi, lo) pairs -> packed int64 keys."""
    return tfpset.pack(_i64(pairs[:, 0]), _i64(pairs[:, 1]))


def _fanout_mask(rng, counts, G):
    """[len(counts), G] bool with counts[b] enabled lanes in row b."""
    order = rng.rand(len(counts), G).argsort(1)
    return order < np.asarray(counts)[:, None]


# Masks built around the compaction's traps, at B = 37 rows (no multiple
# of the CUDA scan's 16-row blocks) and G = 10: (K, the row fan-outs up to
# the boundary, the P they must give).  Rows past the listed ones have
# fan-out 5, so none of them fits after a boundary.
_TRAPS = {
    "zero rows after the last fitting row": (64, [10] * 6 + [0] * 3, 9),
    "total == K on a block edge": (64, [4] * 16, 16),
    "total == K inside a block": (64, [4] * 15 + [2, 2], 17),
    "boundary inside a block": (64, [3] * 21, 21),
    "P == 1 at the least K >= G": (16, [10, 10], 1),
    "P == B with trailing zero rows": (512, [5] * 32 + [0] * 5, 37),
}


@pytest.mark.parametrize("density", [0.0, 0.06, 0.3, 1.0] + list(_TRAPS))
def test_compact_matches_pallas(density):
    if density in _TRAPS:
        B, G = 37, 10
        K, head, want_p = _TRAPS[density]
        rng = np.random.RandomState(len(head) + K)
        en = _fanout_mask(rng, head + [5] * (B - len(head)), G)
    else:
        B, G, K = 24, 132, 256
        rng = np.random.RandomState(7 + int(density * 100))
        en = rng.rand(B, G) < density
        want_p = None
    P, total, lane_id, kvalid = (np.asarray(x) for x in
                                 compact_pallas.build_compactor(B, G, K)(
                                     jnp.asarray(en)))
    assert want_p is None or int(P) == want_p
    kspr = tcompact.kspread(B, G, K, "cpu")
    assert (kspr.numpy() == np.asarray(jcompact.kspread(B, G, K))).all()
    pt, lid, kv = compact_cuda.compact(torch.as_tensor(en), K, kspr)
    assert pt.tolist() == [int(P), int(total)]
    assert (lid.numpy() == lane_id).all()
    assert (kv.numpy() == kvalid).all()


def test_choose_k_matches():
    for B in (1, 32, 128, 256, 2048, 8192):
        for G in (3, 132, 400):
            for req in (None, 100, 5000):
                assert tcompact.choose_k(B, G, req) == \
                    jcompact.choose_k(B, G, req)


def test_probe_base_and_packing_match():
    rng = np.random.RandomState(2)
    hi = rng.randint(0, 1 << 32, 5000, dtype=np.uint64).astype(np.uint32)
    lo = rng.randint(0, 1 << 32, 5000, dtype=np.uint64).astype(np.uint32)
    for c in (16, 4096, 1 << 25):
        h1, h2 = jfpset._probe_base(jnp.asarray(hi), jnp.asarray(lo), c)
        t1, t2 = tfpset.probe_base(_i64(hi), _i64(lo), c)
        assert (t1.numpy() == np.asarray(h1)).all()
        assert (t2.numpy() == np.asarray(h2)).all()
    keys = tfpset.pack(_i64(hi), _i64(lo))
    uh, ul = tfpset.unpack(keys)
    assert (uh.numpy() == hi).all() and (ul.numpy() == lo).all()
    assert int(tfpset.pack(_i64([0xFFFFFFFF]), _i64([0xFFFFFFFF]))) == \
        tfpset.EMPTY


def _same_table(j, t):
    jh, jl = jfpset.to_host_keys(j)
    th, tl = tfpset.to_host_keys(t)
    assert (jh == th).all() and (jl == tl).all()
    assert int(j.size) == int(t.size[0])


def test_insert_matches_pallas_on_duplicate_heavy_batches():
    rng = np.random.RandomState(3)
    j = jfpset.empty(4096)
    t = tfpset.empty(4096, "cpu")
    for _ in range(4):
        pool = rng.randint(0, 300, size=(512, 2)).astype(np.uint32)
        valid = rng.rand(512) < 0.8
        j, new_j, fail_j = fpset_pallas.insert(
            j, jnp.asarray(pool[:, 0]), jnp.asarray(pool[:, 1]),
            jnp.asarray(valid))
        new_t, fail_t = fpset_cuda.insert(
            t, _keys(pool), torch.as_tensor(valid))
        assert (new_t.numpy() == np.asarray(new_j)).all()
        assert bool(fail_t) == bool(fail_j)
        _same_table(j, t)


def test_insert_fail_flag_matches_on_a_full_table():
    rng = np.random.RandomState(4)
    keys = rng.randint(0, 1 << 32, size=(64, 2), dtype=np.uint64) \
        .astype(np.uint32)
    valid = np.ones(64, bool)
    j, new_j, fail_j = fpset_pallas.insert(
        jfpset.empty(16), jnp.asarray(keys[:, 0]), jnp.asarray(keys[:, 1]),
        jnp.asarray(valid))
    t = tfpset.empty(16, "cpu")
    new_t, fail_t = fpset_cuda.insert(t, _keys(keys), torch.as_tensor(valid))
    assert bool(fail_j) and bool(fail_t)
    assert (new_t.numpy() == np.asarray(new_j)).all()
    _same_table(j, t)


def test_host_keys_round_trip_through_the_insert():
    rng = np.random.RandomState(5)
    keys = np.unique(rng.randint(0, 1 << 40, 3000, dtype=np.uint64))
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    j = jfpset.from_host_keys(hi, lo, 8192)
    t = tfpset.from_host_keys(hi, lo, 8192, "cpu", chunk=1000)
    _same_table(j, t)
    g = tfpset.grow(t, 16384, chunk=700)
    assert g.capacity == 16384
    _same_table(j, g)


def test_fused_tail_matches_pallas_including_live_rows():
    rng = np.random.RandomState(11)
    K, SW, Q = 1024, 37, 1024
    for _trial in range(3):
        pool = rng.randint(0, 400, size=(K, 2)).astype(np.uint32)
        valid = rng.rand(K) < 0.8
        cons = rng.rand(K) < 0.7
        krows = rng.randint(0, 255, (K, SW)).astype(np.uint8)
        nc = int(rng.randint(0, 64))
        qinit = rng.randint(0, 255, (Q + K, SW)).astype(np.uint8)
        j, new_j, fail_j, q_j = fused_tail_pallas.insert_enqueue(
            jfpset.empty(8192), jnp.asarray(pool[:, 0]),
            jnp.asarray(pool[:, 1]), jnp.asarray(valid), jnp.asarray(krows),
            jnp.asarray(cons), jnp.asarray(qinit), jnp.int32(nc), Q)
        t = tfpset.empty(8192, "cpu")
        q_t = torch.as_tensor(qinit.copy())
        new_t, fail_t, cnt = fused_tail_cuda.insert_enqueue(
            t, _keys(pool), torch.as_tensor(valid), torch.as_tensor(krows),
            torch.as_tensor(cons), q_t, nc)
        new_j = np.asarray(new_j)
        assert (new_t.numpy() == new_j).all()
        assert bool(fail_t) == bool(fail_j)
        _same_table(j, t)
        hi = nc + int((new_j & cons).sum())
        assert int(cnt) == hi
        q_j = np.asarray(q_j)
        assert (q_t.numpy()[:hi] == q_j[:hi]).all()      # live rows
        assert (q_t.numpy()[hi:] == qinit[hi:]).all()    # no trash writes


# --- Trap batches of the insert and the fused tail (the batches the CUDA
# kernels are held to on the card, at sizes a CPU run takes) ---------------

def _pairs(rng, n, hi=1 << 32):
    return rng.randint(0, hi, size=(n, 2), dtype=np.uint64).astype(np.uint32)


def _trap(name):
    """``(capacity, prefill pairs, query pairs, valid)`` of a trap batch,
    from a numpy seed of its own."""
    rng = np.random.RandomState(sum(map(ord, name)))
    old = _pairs(rng, 200)
    if name == "n = 1 (the root ingest)":
        return 4096, old, _pairs(rng, 1), np.ones(1, bool)
    if name == "n = 512 into 4,096 slots":
        pool = np.concatenate([old[:60], _pairs(rng, 240)])
        return 4096, old, pool[rng.randint(0, 300, 512)], rng.rand(512) < 0.8
    if name == "n = 1,000 (no multiple of a tile)":
        pool = np.concatenate([old[:100], _pairs(rng, 500)])
        return 8192, old, pool[rng.randint(0, 600, 1000)], rng.rand(1000) < 0.8
    if name == "1,024 lanes one new key":
        return 8192, old, np.repeat(_pairs(rng, 1), 1024, 0), np.ones(1024, bool)
    if name == "one present key on every lane":
        return 8192, old, np.repeat(old[7:8], 1024, 0), np.ones(1024, bool)
    if name == "no valid lane":
        return 8192, old, _pairs(rng, 1024, 300), np.zeros(1024, bool)
    if name == "a 64-slot table that fails":
        return 64, old[:20], _pairs(rng, 1024), np.ones(1024, bool)
    raise KeyError(name)


_INSERT_TRAPS = ["n = 1 (the root ingest)", "n = 512 into 4,096 slots",
                 "n = 1,000 (no multiple of a tile)", "1,024 lanes one new key",
                 "one present key on every lane", "no valid lane",
                 "a 64-slot table that fails"]


def _tables(capacity, prefill):
    j = jfpset.empty(capacity)
    t = tfpset.empty(capacity, "cpu")
    ok = np.ones(len(prefill), bool)
    j, _n, _f = fpset_pallas.insert(j, jnp.asarray(prefill[:, 0]),
                                    jnp.asarray(prefill[:, 1]), jnp.asarray(ok))
    fpset_cuda.insert(t, _keys(prefill), torch.as_tensor(ok))
    _same_table(j, t)
    return j, t


@pytest.mark.parametrize("trap", _INSERT_TRAPS)
def test_insert_traps_match_pallas(trap):
    capacity, prefill, q, valid = _trap(trap)
    j, t = _tables(capacity, prefill)
    j, new_j, fail_j = fpset_pallas.insert(
        j, jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1]), jnp.asarray(valid))
    new_t, fail_t = fpset_cuda.insert(t, _keys(q), torch.as_tensor(valid))
    assert (new_t.numpy() == np.asarray(new_j)).all()
    assert bool(fail_t) == bool(fail_j) == (trap == "a 64-slot table that "
                                                    "fails")
    _same_table(j, t)


def test_insert_matches_pallas_on_a_growing_table():
    """Batches of 512 into 4,096 slots, the table doubled (the port through
    its insert, the JAX one rebuilt from its keys) whenever the next batch
    could take it past half full, as the engine grows it."""
    rng = np.random.RandomState(12)
    pool = _pairs(rng, 5000)
    j, t = jfpset.empty(4096), tfpset.empty(4096, "cpu")
    grows, peak = 0, 0.0
    while grows < 2:
        if int(t.size[0]) + 512 > t.capacity // 2:
            t = tfpset.grow(t, 2 * t.capacity, chunk=1000)
            j = jfpset.from_host_keys(*jfpset.to_host_keys(j), t.capacity)
            grows += 1
        q = pool[rng.randint(0, len(pool), 512)]
        valid = rng.rand(512) < 0.9
        j, new_j, fail_j = fpset_pallas.insert(
            j, jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1]), jnp.asarray(valid))
        new_t, fail_t = fpset_cuda.insert(t, _keys(q), torch.as_tensor(valid))
        assert (new_t.numpy() == np.asarray(new_j)).all()
        assert not bool(fail_t) and not bool(fail_j)
        _same_table(j, t)
        peak = max(peak, int(t.size[0]) / t.capacity)
    assert t.capacity == 16384 and 0.3 < peak <= 0.5


_TAIL_TRAPS = _INSERT_TRAPS + ["enq_ok all false", "enq_ok all true",
                               "the last live row on the queue's last row",
                               "rows of 403 bytes", "rows of 679 bytes"]


@pytest.mark.parametrize("trap", _TAIL_TRAPS)
def test_fused_tail_traps_match_pallas(trap):
    """The port's insert_enqueue against the JAX fused tail: is_new, fail,
    the table, the count, the live rows, and every other row of the
    port's queue unchanged (the JAX kernel's trash rows lie past it)."""
    base = trap if trap in _INSERT_TRAPS else "n = 1,000 (no multiple of a tile)"
    capacity, prefill, q, valid = _trap(base)
    rng = np.random.RandomState(len(trap))
    n = len(q)
    sw = {"rows of 403 bytes": 403,
          "rows of 679 bytes": 679}.get(trap, 473)    # MCraft_noleader, raft5
    enq_ok = {"enq_ok all false": np.zeros(n, bool),
              "enq_ok all true": np.ones(n, bool)}.get(trap, rng.rand(n) < 0.7)
    nc, rows = 37, 37 + n + 5
    if trap == "the last live row on the queue's last row":
        q, valid, enq_ok = _pairs(rng, n), np.ones(n, bool), np.ones(n, bool)
        nc = rows - n
    krows = rng.randint(0, 256, (n, sw)).astype(np.uint8)
    npad = 1 << (n - 1).bit_length()
    qinit = rng.randint(0, 256, (rows + npad, sw)).astype(np.uint8)
    j, t = _tables(capacity, prefill)
    j, new_j, fail_j, q_j = fused_tail_pallas.insert_enqueue(
        j, jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1]), jnp.asarray(valid),
        jnp.asarray(krows), jnp.asarray(enq_ok), jnp.asarray(qinit),
        jnp.int32(nc), rows)
    q_t = torch.as_tensor(qinit[:rows].copy())
    new_t, fail_t, cnt = fused_tail_cuda.insert_enqueue(
        t, _keys(q), torch.as_tensor(valid), torch.as_tensor(krows),
        torch.as_tensor(enq_ok), q_t, nc)
    new_j = np.asarray(new_j)
    assert (new_t.numpy() == new_j).all()
    assert bool(fail_t) == bool(fail_j)
    _same_table(j, t)
    count = nc + int((new_j & enq_ok).sum())
    assert int(cnt) == count
    assert (q_t.numpy() == np.asarray(q_j)[:rows]).all()
    assert (q_t.numpy()[count:] == qinit[count:rows]).all()
    if trap == "the last live row on the queue's last row":
        assert count == rows
    if trap == "enq_ok all true":
        assert count - nc == int(new_j.sum()) > 0


# --- The wrappers ---------------------------------------------------------

def _tail_args(n=64, sw=473, rows=200):
    t = tfpset.empty(4096, "cpu")
    keys = _keys(_pairs(np.random.RandomState(1), n))
    return dict(seen=t, keys=keys, valid=torch.ones(n, dtype=torch.bool),
                krows=torch.zeros((n, sw), dtype=torch.uint8),
                enq_ok=torch.ones(n, dtype=torch.bool),
                qnext=torch.zeros((rows, sw), dtype=torch.uint8),
                next_count=0)


_BAD_TAIL = {
    "queue overrun": dict(next_count=137 + 1),
    "negative next_count": dict(next_count=-1),
    "int32 keys": dict(keys=torch.zeros(64, dtype=torch.int32)),
    "uint8 valid": dict(valid=torch.ones(64, dtype=torch.uint8)),
    "int16 rows": dict(krows=torch.zeros((64, 473), dtype=torch.int16)),
    "non-contiguous rows": dict(
        krows=torch.zeros((473, 64), dtype=torch.uint8).t()),
    "non-contiguous queue": dict(
        qnext=torch.zeros((473, 200), dtype=torch.uint8).t()),
    "queue of another width": dict(qnext=torch.zeros((200, 472),
                                                     dtype=torch.uint8)),
    "uint8 enq_ok": dict(enq_ok=torch.ones(64, dtype=torch.uint8)),
    "enq_ok of another length": dict(enq_ok=torch.ones(63, dtype=torch.bool)),
    "keys of another length": dict(keys=torch.zeros(63, dtype=torch.int64),
                                   valid=torch.ones(63, dtype=torch.bool)),
}


@pytest.mark.parametrize("case", list(_BAD_TAIL))
def test_fused_tail_wrapper_raises(case):
    args = _tail_args()
    args.update(_BAD_TAIL[case])
    before = fused_tail_cuda.launches
    with pytest.raises(ValueError):
        fused_tail_cuda.insert_enqueue(**args)
    assert fused_tail_cuda.launches == before


_BAD_INSERT = {
    "int32 keys": (torch.zeros(8, dtype=torch.int32),
                   torch.ones(8, dtype=torch.bool)),
    "uint8 valid": (torch.zeros(8, dtype=torch.int64),
                    torch.ones(8, dtype=torch.uint8)),
    "[n, 1] keys": (torch.zeros((8, 1), dtype=torch.int64),
                    torch.ones((8, 1), dtype=torch.bool)),
    "shapes differ": (torch.zeros(8, dtype=torch.int64),
                      torch.ones(7, dtype=torch.bool)),
}


@pytest.mark.parametrize("case", list(_BAD_INSERT))
def test_insert_wrapper_raises(case):
    keys, valid = _BAD_INSERT[case]
    before = fpset_cuda.launches
    with pytest.raises(ValueError):
        fpset_cuda.insert(tfpset.empty(64, "cpu"), keys, valid)
    assert fpset_cuda.launches == before


def test_wrappers_count_no_launch_on_cpu_tensors():
    before = (fpset_cuda.launches, fused_tail_cuda.launches)
    args = _tail_args()
    new, fail = fpset_cuda.insert(args["seen"], args["keys"], args["valid"])
    assert int(new.sum()) == 64 and not bool(fail)
    new, fail, cnt = fused_tail_cuda.insert_enqueue(**_tail_args())
    assert int(cnt) == 64 and fail.dim() == 0 and cnt.dim() == 0
    assert (fpset_cuda.launches, fused_tail_cuda.launches) == before


@pytest.mark.parametrize("n,tiles", [(0, 1), (1, 1), (64, 1), (65, 2),
                                     (1000, 16), (32768, 512),
                                     (1 << 20, 16384)])
def test_fused_tail_tiles(n, tiles):
    assert fused_tail_cuda.tiles(n, 64) == tiles
