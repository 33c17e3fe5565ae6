"""Randomized initial states: the SmokeInit roots and unstructured states.

The Smokeraft harness draws each state variable from a ``RandomSubset(k,
<finitized domain>)`` (Smokeraft.tla:64-76); the initial states are the
cartesian product of the nine per-variable k-subsets (``k^9`` states), all
sharing one random message bag whose multiplicities are 1 (:76).  The
finitized domains (:4-15):

    SmokeNat = 0..2,  SmokeInt = -1..1,  logs: BoundedSeq(entries, 3),
    message sequences (mentries/mlog): length <= 1,
    nextIndex domain {n \\in SmokeNat : 1 <= n} = {1, 2}.

``random_states`` draws unstructured states over the same domains, each
with its own bag: the states that break the safety suite, for testing.

This is the JAX package's ``models/smoke.py``, numpy only, kept as the
port's own copy: it makes the same ``np.random.default_rng(seed)`` draws in
the same order, so one seed gives the JAX package's roots state for state.
"""

from __future__ import annotations

import itertools
from typing import List

import numpy as np

from .dims import AEQ, AER, RVQ, RVR, RaftDims
from .pystate import PyState

SMOKE_NAT = (0, 1, 2)        # Smokeraft.tla:11-12
SMOKE_INT = (-1, 0, 1)       # Smokeraft.tla:14-15
SMOKE_MAX_INIT_LOG = 3       # Smokeraft.tla:70


def _rand_fn(rng, domain_sampler, n):
    return tuple(domain_sampler(rng) for _ in range(n))


def _random_subset(rng, k: int, sampler):
    """RandomSubset(k, S): k *distinct* draws (rejection-sampled)."""
    out, tries = set(), 0
    while len(out) < k and tries < 10000:
        out.add(sampler(rng))
        tries += 1
    if len(out) < k:
        raise ValueError("domain smaller than k")
    return sorted(out)


def _sample_log(rng, dims: RaftDims, max_len: int):
    ln = rng.integers(0, max_len + 1)
    return tuple((int(rng.choice(SMOKE_NAT)),
                  int(rng.integers(1, dims.n_values + 1)))
                 for _ in range(ln))


def _sample_message(rng, dims: RaftDims):
    """One element of SmokeMessageType (Smokeraft.tla:24-62)."""
    n = dims.n_servers
    mtype = int(rng.integers(0, 4))
    src, dst = int(rng.integers(0, n)), int(rng.integers(0, n))
    mterm = int(rng.choice(SMOKE_NAT))
    if mtype == RVQ:
        return (RVQ, src, dst, mterm, int(rng.choice(SMOKE_NAT)),
                int(rng.choice(SMOKE_NAT)))
    if mtype == RVR:
        return (RVR, src, dst, mterm, int(rng.integers(0, 2)),
                _sample_log(rng, dims, 1))
    if mtype == AEQ:
        return (AEQ, src, dst, mterm, int(rng.choice(SMOKE_INT)),
                int(rng.choice(SMOKE_NAT)), _sample_log(rng, dims, 1),
                int(rng.choice(SMOKE_NAT)))
    return (AER, src, dst, mterm, int(rng.integers(0, 2)),
            int(rng.choice(SMOKE_NAT)))


def smoke_init_states(dims: RaftDims, k: int = 2,
                      seed: int = 0) -> List[PyState]:
    """The full SmokeInit set: product of per-variable k-subsets (k^9
    states) sharing one random message bag — Smokeraft.tla:64-76."""
    n = dims.n_servers
    rng = np.random.default_rng(seed)

    def fn_sampler(cell):
        return lambda r: _rand_fn(r, cell, n)

    per_var = {
        "current_term": _random_subset(
            rng, k, fn_sampler(lambda r: int(r.choice(SMOKE_NAT)))),
        "role": _random_subset(
            rng, k, fn_sampler(lambda r: int(r.integers(0, 3)))),
        "voted_for": _random_subset(
            rng, k, fn_sampler(lambda r: int(r.integers(0, n + 1)))),
        "log": _random_subset(
            rng, k, fn_sampler(
                lambda r: _sample_log(r, dims, SMOKE_MAX_INIT_LOG))),
        "commit_index": _random_subset(
            rng, k, fn_sampler(lambda r: int(r.choice(SMOKE_NAT)))),
        "votes_responded": _random_subset(
            rng, k, fn_sampler(lambda r: int(r.integers(0, 1 << n)))),
        "votes_granted": _random_subset(
            rng, k, fn_sampler(lambda r: int(r.integers(0, 1 << n)))),
        # nextIndex \in [Server -> [Server -> {1, 2}]]  (SmokeNat n >= 1)
        "next_index": _random_subset(
            rng, k, fn_sampler(
                lambda r: tuple(int(r.integers(1, 3)) for _ in range(n)))),
        "match_index": _random_subset(
            rng, k, fn_sampler(
                lambda r: tuple(int(r.choice(SMOKE_NAT)) for _ in range(n)))),
    }
    # messages: one fixed bag, union of 4 k-subsets, multiplicity 1 (:58-76).
    msgs = set()
    for mt in range(4):
        msgs.update(_random_subset(
            rng, k, lambda r, _mt=mt: _until_type(r, dims, _mt)))
    bag = frozenset((m, 1) for m in msgs)

    names = list(per_var)
    states = []
    for combo in itertools.product(*(per_var[v] for v in names)):
        kw = dict(zip(names, combo))
        states.append(PyState(messages=bag, **kw))
    return states


def _until_type(rng, dims, mtype):
    while True:
        m = _sample_message(rng, dims)
        if m[0] == mtype:
            return m


def random_states(dims: RaftDims, count: int, seed: int = 0,
                  max_msgs: int = 4) -> List[PyState]:
    """Unstructured random states over the smoke domains — broader than
    SmokeInit (independent per-state message bags); used for differential
    fuzzing of the kernels, not part of TLC parity."""
    rng = np.random.default_rng(seed)
    n = dims.n_servers
    out = []
    for _ in range(count):
        n_msgs = int(rng.integers(0, max_msgs + 1))
        bag = {}
        for _k in range(n_msgs):
            bag[_sample_message(rng, dims)] = int(rng.integers(1, 3))
        out.append(PyState(
            current_term=_rand_fn(rng, lambda r: int(r.choice(SMOKE_NAT)), n),
            role=_rand_fn(rng, lambda r: int(r.integers(0, 3)), n),
            voted_for=_rand_fn(rng, lambda r: int(r.integers(0, n + 1)), n),
            log=_rand_fn(
                rng, lambda r: _sample_log(r, dims, SMOKE_MAX_INIT_LOG), n),
            commit_index=_rand_fn(rng, lambda r: int(r.choice(SMOKE_NAT)), n),
            votes_responded=_rand_fn(
                rng, lambda r: int(r.integers(0, 1 << n)), n),
            votes_granted=_rand_fn(
                rng, lambda r: int(r.integers(0, 1 << n)), n),
            next_index=tuple(
                tuple(int(rng.integers(1, 3)) for _ in range(n))
                for _ in range(n)),
            match_index=tuple(
                tuple(int(rng.choice(SMOKE_NAT)) for _ in range(n))
                for _ in range(n)),
            messages=frozenset(bag.items())))
    return out
