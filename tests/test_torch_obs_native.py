"""The port's native trace store (``raft_tla_tpu_torch/native/``) against
its columnar store and the JAX package's ``NativeTraceStore``, on the
CPU.

The native store's ``export`` returns records in hash-slot order and the
columnar store's in insertion order, so every comparison of exported
records is a comparison of sets.  Fuzzed batches repeat fingerprints
(the first record of a fingerprint wins in all three stores), chains
agree, an engine run with either store gives the same counts, trace
records and replay, names its store on ``run_start`` and the result,
and a snapshot written with the native store loads in both packages to
the columnar snapshot's records.  A native store that cannot be built
says why and the columnar store runs.
"""

import json
import os

import numpy as np
import pytest
import torch

from raft_tla_tpu import native as jnative
from raft_tla_tpu.engine import checkpoint as jckpt
from raft_tla_tpu.engine.trace import NativeTraceStore as JNative
from raft_tla_tpu_torch import native
from raft_tla_tpu_torch.engine import checkpoint as ckpt_mod
from raft_tla_tpu_torch.engine.bfs import EngineConfig
from raft_tla_tpu_torch.engine.check import run_check
from raft_tla_tpu_torch.engine.trace import (NativeTraceStore, PyTraceStore,
                                             make_trace_store)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOLEADER = os.path.join(REPO, "configs/MCraft_noleader.cfg")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def records(store):
    f, p, a = store.export()
    return set(zip(f.tolist(), p.tolist(), a.tolist()))


@pytest.mark.parametrize("seed", [1, 7, 23])
def test_native_equals_columnar_and_jax_on_fuzzed_batches(seed):
    rng = np.random.default_rng(seed)
    stores = [NativeTraceStore(native.load(), 16), PyTraceStore(),
              JNative(jnative.load(), 16)]
    pool = rng.integers(1, 1 << 64, 3000, dtype=np.uint64)
    for _ in range(12):
        n = int(rng.integers(0, 900))
        fps = rng.choice(pool, n)               # repeats within and across
        par = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        act = rng.integers(-1, 200, n).astype(np.int32)
        for s in stores:
            s.add_batch(fps, par, act)
    got = [records(s) for s in stores]
    assert got[0] == got[1] == got[2]
    assert len(stores[0]) == len(stores[1]) == len(got[0])
    for fp in rng.choice(pool, 50):
        assert stores[0].get(int(fp)) == stores[1].get(int(fp)) \
            == stores[2].get(int(fp))
        assert stores[0].chain(int(fp)) == stores[1].chain(int(fp))


def test_chain_walks_back_to_the_root():
    for kind in ("native", "columnar"):
        s = make_trace_store(kind)
        assert s.kind == kind
        s.add_batch(np.array([100, 200, 300], np.uint64),
                    np.array([0, 100, 200], np.uint64),
                    np.array([-1, 5, 7], np.int32))
        s.add_batch(np.array([300], np.uint64), np.array([9], np.uint64),
                    np.array([1], np.int32))          # the first wins
        assert s.chain(300) == [(100, -1), (200, 5), (300, 7)]
        assert s.chain(999) == []
    with pytest.raises(ValueError, match="trace_store"):
        make_trace_store("disk")


def test_a_failed_build_says_why(monkeypatch, capsys):
    def fail():
        raise native.NativeUnavailable("g++ failed on trace_store.cpp: x")
    monkeypatch.setattr(native, "load", fail)
    s = make_trace_store("native")
    assert s.kind == "columnar"
    assert "native store unavailable (g++ failed" in capsys.readouterr().err


def test_engine_runs_alike_on_both_stores(tmp_path):
    runs = {}
    for kind in ("columnar", "native"):
        ck, ev = tmp_path / kind, tmp_path / f"{kind}.jsonl"
        cfg = EngineConfig(batch=64, queue_capacity=1 << 12,
                           seen_capacity=1 << 14, trace_store=kind,
                           checkpoint_dir=str(ck), events_out=str(ev),
                           statespace_report=False)
        res = run_check(NOLEADER, cfg, device="cpu")
        start = json.loads(ev.read_text().splitlines()[0])
        assert start["event"] == "run_start"
        assert start["trace_store"] == res.trace_store == kind
        runs[kind] = (res, records(res.engine.trace),
                      res.engine.replay(res.violation.fingerprint),
                      ckpt_mod.latest(str(ck)))
    (cres, crec, crep, cck), (nres, nrec, nrep, nck) = (
        runs["columnar"], runs["native"])
    assert (nres.distinct, nres.generated, nres.levels) \
        == (cres.distinct, cres.generated, cres.levels)
    assert nres.violation.fingerprint == cres.violation.fingerprint
    assert nrec == crec and nrep == crep
    # The native run's snapshot: hash-order records, the same set, in
    # both packages.
    for load in (ckpt_mod.load, jckpt.load):
        a, b = load(nck), load(cck)
        assert set(zip(a.trace_fps.tolist(), a.trace_parents.tolist(),
                       a.trace_actions.tolist())) \
            == set(zip(b.trace_fps.tolist(), b.trace_parents.tolist(),
                       b.trace_actions.tolist()))
        assert a.distinct == b.distinct
