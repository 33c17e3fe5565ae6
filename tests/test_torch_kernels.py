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
