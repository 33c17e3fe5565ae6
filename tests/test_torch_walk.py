"""The port's walk primitives (``raft_tla_tpu_torch/ops/walk_kernels.py``)
against the JAX package's, on seeded numpy inputs: the counter hash at
seeds, walk ids and steps around 2^31 and 2^32, the masked and
family-preferred draws (rows with no enabled lane, families past 32),
the rings and the Bloom filters."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tla_tpu.ops import walk_kernels as J
from raft_tla_tpu_torch.ops import walk_kernels as T

STREAMS = (J.CHOICE_STREAM, J.ROOT_STREAM, J.INIT_STREAM, J.FAMILY_STREAM)


def t64(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def test_stream_constants_match():
    assert (T.CHOICE_STREAM, T.ROOT_STREAM, T.INIT_STREAM,
            T.FAMILY_STREAM) == STREAMS


@pytest.mark.parametrize("seed", [0, 5, 2**31 - 1, 2**31, 2**32 - 1])
def test_walk_bits_match_across_the_uint32_range(seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    ids = np.concatenate([np.arange(4), [2**31 - 2, 2**31 - 1, 2**31,
                                         2**32 - 1],
                          rng.integers(0, 2**32, 8)]).astype(np.uint32)
    for step in (0, 9, 2**31 - 1, 2**31, 2**32 - 1):
        for stream in STREAMS:
            want = np.asarray(J.walk_bits(np.uint32(seed), jnp.asarray(ids),
                                          np.uint32(step), stream))
            got = T.walk_bits(seed, t64(ids), step, stream)
            assert np.array_equal(got.numpy(), want.astype(np.int64))
    # Per-lane steps (the family stream keys on each lane's epoch), and a
    # seed past 2^32 wraps to its low 32 bits as the engines pass it.
    steps = rng.integers(0, 2**32, ids.size).astype(np.uint32)
    want = np.asarray(J.walk_bits(np.uint32(seed), jnp.asarray(ids),
                                  jnp.asarray(steps), J.FAMILY_STREAM))
    got = T.walk_bits(seed + (7 << 32), t64(ids), t64(steps),
                      T.FAMILY_STREAM)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    # A seed held in a device scalar (the chunk's control tensor).
    got = T.walk_bits(torch.tensor(seed), t64(ids), t64(steps),
                      T.FAMILY_STREAM)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.fixture(scope="module")
def draws():
    rng = np.random.default_rng(20261017)
    en = rng.random((64, 132)) < rng.random((64, 1))
    en[:4] = False                               # rows with no lane
    en[4, -1] = True
    en[4, :-1] = False                           # only the last lane
    bits = rng.integers(0, 2**32, 64).astype(np.uint32)
    bits[5] = 2**32 - 1
    fam = (np.arange(132) * 7) % 45              # families past 32
    return en, bits, fam


def test_masked_choice_matches_and_gives_lane_zero_when_none(draws):
    en, bits, _fam = draws
    want = np.asarray(J.masked_choice(jnp.asarray(bits), jnp.asarray(en)))
    got = T.masked_choice(t64(bits), torch.as_tensor(en)).numpy()
    assert np.array_equal(got, want)
    assert (got[:4] == 0).all() and got[4] == 131


def test_family_subset_and_preferred_choice_match(draws):
    en, bits, fam = draws
    rng = np.random.default_rng(3)
    mbits = rng.integers(0, 2**32, 64).astype(np.uint32)
    mbits[:8] = 0                                # empty subsets: fall back
    want_p = np.asarray(J.family_subset(jnp.asarray(mbits),
                                        jnp.asarray(fam, jnp.int32)))
    got_p = T.family_subset(t64(mbits), torch.as_tensor(fam))
    assert np.array_equal(got_p.numpy(), want_p)
    want = np.asarray(J.preferred_choice(jnp.asarray(bits), jnp.asarray(en),
                                         jnp.asarray(want_p)))
    got = T.preferred_choice(t64(bits), torch.as_tensor(en), got_p).numpy()
    assert np.array_equal(got, want)


def test_rings_match():
    rng = np.random.default_rng(11)
    lanes, cap = 9, 4
    jh, jl, jp = J.ring_init(lanes, cap)
    th, tl, tp = T.ring_init(lanes, cap)
    assert (th == 0xFFFFFFFF).all() and (tl == 0xFFFFFFFF).all()
    for _ in range(12):
        hi = rng.integers(0, 2**32, lanes).astype(np.uint32)
        lo = rng.integers(0, 2**32, lanes).astype(np.uint32)
        if rng.random() < 0.5:                   # revisit a ring entry
            hi[:3] = np.asarray(jh)[:3, 0]
            lo[:3] = np.asarray(jl)[:3, 0]
        do = rng.random(lanes) < 0.7
        reset = rng.random(lanes) < 0.2
        want = np.asarray(J.ring_probe(jh, jl, jnp.asarray(hi),
                                       jnp.asarray(lo)))
        got = T.ring_probe(th, tl, t64(hi), t64(lo)).numpy()
        assert np.array_equal(got, want)
        jh, jl, jp = J.ring_push(jh, jl, jp, jnp.asarray(hi),
                                 jnp.asarray(lo), jnp.asarray(do))
        th, tl, tp = T.ring_push(th, tl, tp, t64(hi), t64(lo),
                                 torch.as_tensor(do))
        jh, jl, jp = J.ring_reset(jh, jl, jp, jnp.asarray(reset))
        th, tl, tp = T.ring_reset(th, tl, tp, torch.as_tensor(reset))
        for a, b in ((jh, th), (jl, tl), (jp, tp)):
            assert np.array_equal(np.asarray(a).astype(np.int64), b.numpy())


def test_bloom_matches():
    rng = np.random.default_rng(12)
    with pytest.raises(ValueError):
        T.bloom_init(48)
    jb, tb = J.bloom_init(64), T.bloom_init(64)
    for _ in range(5):
        hi = rng.integers(0, 2**32, 40).astype(np.uint32)
        lo = rng.integers(0, 2**32, 40).astype(np.uint32)
        hi[10:20] = hi[:10]                      # duplicate probes
        do = rng.random(40) < 0.6
        want = np.asarray(J.bloom_probe(jb, jnp.asarray(hi), jnp.asarray(lo)))
        got = T.bloom_probe(tb, t64(hi), t64(lo)).numpy()
        assert np.array_equal(got, want)
        jb = J.bloom_push(jb, jnp.asarray(hi), jnp.asarray(lo),
                          jnp.asarray(do))
        tb = T.bloom_push(tb, t64(hi), t64(lo), torch.as_tensor(do))
        assert np.array_equal(np.asarray(jb), tb.numpy())
