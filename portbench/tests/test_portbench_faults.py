"""A run with the timed path broken underneath comes out not correct.

Each fault is planted in the program's tail (``engine/chunk.py``'s
``insert_enqueue``, the fused insert and enqueue every batch goes
through) and the rest of a run is driven on the CPU: a step that leaves
its state unchanged (nothing inserted, nothing enqueued), half of the
batch left out, and an answer altered where it is produced (one
successor's fingerprint a batch).  The exchange between chips does not
exist in these one-chip cells."""

import pytest
import torch

from conftest import run_cpu


def unchanged(real):
    def tail(seen, keys, valid, krows, enq_ok, qnext, next_count,
             max_count=None):
        return real(seen, keys, torch.zeros_like(valid), krows, enq_ok,
                    qnext, next_count, max_count)
    return tail


def half(real):
    def tail(seen, keys, valid, krows, enq_ok, qnext, next_count,
             max_count=None):
        keep = torch.arange(valid.shape[0], device=valid.device) \
            < valid.shape[0] // 2
        return real(seen, keys, valid & keep, krows, enq_ok, qnext,
                    next_count, max_count)
    return tail


def altered(real):
    def tail(seen, keys, valid, krows, enq_ok, qnext, next_count,
             max_count=None):
        keys = keys.clone()
        keys[0] ^= 1
        return real(seen, keys, valid, krows, enq_ok, qnext, next_count,
                    max_count)
    return tail


def test_a_sound_run_is_correct(tree, one_thread):
    result, compared = run_cpu(tree)
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "compared"
    assert all(v["value"] == 0 for v in result["compared"].values())


@pytest.mark.parametrize("fault", [unchanged, half, altered])
def test_a_fault_comes_out_not_correct(fault, tree, one_thread,
                                       monkeypatch):
    from raft_tla_tpu_torch.engine import chunk
    monkeypatch.setattr(chunk, "insert_enqueue",
                        fault(chunk.insert_enqueue))
    result, compared = run_cpu(tree)
    assert result["correct"] is False
    assert result["failed"] == result["attempted"] >= 1
    assert compared["distinct_gap"][0] > 0
