"""The v4 chunk front: port vs the JAX ``build_front``, exactly.

The JAX front (``ops/chunk_front_pallas.py``) runs in interpret mode, as
the JAX package's own tests run it on the CPU; on CPU tensors the port's
``ops/chunk_front_cuda.py`` front takes its plain version, the contract
the CUDA kernel is held to on the card (``chip_smoke.py``).  Parent rows
are reachable states, leader states, uint8 edge states and random states
packed into B-row windows, some rows marked invalid.  All 14 outputs are
compared with tolerance 0; the seven per-lane outputs the kernel leaves
unwritten on dead lanes (``chunk_front.LIVE_ONLY``) on live lanes only.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tla_tpu.models.actions2 import build_v2 as j_build_v2
from raft_tla_tpu.models.invariants import build_constraint as j_constraint
from raft_tla_tpu.models.invariants import build_no_leader as j_no_leader
from raft_tla_tpu.models.invariants import build_type_ok as j_type_ok
from raft_tla_tpu.ops.chunk_front_pallas import build_front as j_build_front
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch.models import schema as tschema
from raft_tla_tpu_torch.models.actions2 import build_v2
from raft_tla_tpu_torch.models.dims import RaftDims
from raft_tla_tpu_torch.models.invariants import (build_constraint,
                                                  build_no_leader,
                                                  build_type_ok)
from raft_tla_tpu_torch.ops import chunk_front_cuda
from raft_tla_tpu_torch.ops.chunk_front import LIVE_ONLY, FrontOut
from raft_tla_tpu_torch.utils.cfg import load_config

from tests.test_por import forged_dup_table
from tests.test_torch_actions2 import _states
from tests.test_torch_schema_fp import to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")


@pytest.fixture(scope="module")
def rig():
    jsetup = j_load_config(BOUNDED)
    setup = load_config(BOUNDED)
    dims = setup.dims
    states = _states(jsetup.dims, jsetup.bounds)
    st = tschema.stack_states(
        [tschema.encode_state(to_port(s), dims) for s in states], "cpu")
    rows = tschema.flatten_state(st, dims)
    fanout = build_v2(dims, "cpu").masks(st)[0].sum(1)
    return jsetup, setup, rows, fanout


def windows(rows, fanout, B, K, fit):
    """B-row windows over every row, every fifth row marked invalid; with
    ``fit`` each window's valid fan-out fits K (so P == B)."""
    n = rows.shape[0]
    out, idx, cur = [], [], 0
    for r in range(n):
        f = int(fanout[r]) if r % 5 else 0
        if len(idx) == B or (fit and cur + f > K):
            out.append(idx)
            idx, cur = [], 0
        idx.append(r)
        cur += f
    out.append(idx)
    wins = []
    for idx in out:
        w = torch.zeros((B, rows.shape[1]), dtype=torch.uint8)
        w[:len(idx)] = rows[idx]
        valid = torch.zeros(B, dtype=torch.bool)
        valid[:len(idx)] = torch.tensor([r % 5 != 0 for r in idx])
        wins.append((w, valid))
    return wins


def fronts(rig, B, K, *, preds=True, por=None):
    jsetup, setup, _rows, _f = rig
    jd, d = jsetup.dims, setup.dims
    pm = pp = None
    if por is not None:
        pm, pp = por
    jf = j_build_front(
        dims=jd, v2=j_build_v2(jd),
        constraint=j_constraint(jd, jsetup.bounds) if preds else None,
        inv_fns=[j_type_ok(jd), j_no_leader(jd)] if preds else None,
        B=B, G=jd.n_instances, K=K,
        por_mask=None if pm is None else jnp.asarray(pm),
        por_priority=None if pp is None else jnp.asarray(pp),
        interpret=True)
    tf = chunk_front_cuda.Front(
        dims=d, v2=build_v2(d, "cpu"),
        inv_fns=[build_type_ok(d), build_no_leader(d)] if preds else [],
        constraint=build_constraint(d, setup.bounds) if preds else None,
        B=B, K=K, device="cpu", por_mask=pm, por_priority=pp)
    return jf, tf


def assert_equal_fronts(want, got: FrontOut):
    total = int(got.total)
    for name, w, g in zip(FrontOut._fields, want, got):
        w = np.asarray(w)
        g = g.numpy()
        if name in ("kh", "kl", "parent_hi", "parent_lo"):
            w = w.astype(np.int64)
        if name in LIVE_ONLY:
            w, g = w[:total], g[:total]
        assert w.shape == g.shape, name
        assert (w == g).all(), name


def run_case(rig, B, K, wins, **kw):
    jf, tf = fronts(rig, B, K, **kw)
    outs = []
    for rows, valid in wins:
        want = jax.device_get(jf(jnp.asarray(rows.numpy()),
                                 jnp.asarray(valid.numpy())))
        got = tf(rows, valid)
        assert_equal_fronts(want, got)
        outs.append(got)
    return outs


def test_front_fitting_windows(rig):
    B, K = 16, 256
    wins = windows(rig[2], rig[3], B, K, fit=True)
    outs = run_case(rig, B, K, wins)
    assert all(int(o.P) == B for o in outs)
    assert sum(int(o.total) for o in outs) > 1000
    assert any(bool(o.ovf.any()) for o in outs)        # pack guards hit
    assert any(bool((o.inv[:int(o.total)] >= 0).any()) for o in outs)
    assert any(bool((~o.cons_ok[:int(o.total)]).any()) for o in outs)


def test_front_progress_limited_windows(rig):
    B, K = 64, 256
    outs = run_case(rig, B, K, windows(rig[2], rig[3], B, K, fit=False))
    assert all(int(o.P) < B for o in outs)
    assert all(not o.en[int(o.P):].any() for o in outs)


@pytest.mark.parametrize("ties", [False, True])
def test_front_por_forged_dup_table(rig, ties):
    """The forged DuplicateMessage table of tests/test_por.py; with
    ``ties`` every certified lane has the same priority, so the lowest
    enabled g must win."""
    jsetup = rig[0]
    table = forged_dup_table(jsetup.dims)
    pri = np.asarray(table.priority, np.int32)
    if ties:
        pri = np.zeros_like(pri)
    B, K = 16, 256
    outs = run_case(rig, B, K, windows(rig[2], rig[3], B, K, fit=True),
                    por=(np.asarray(table.ample_mask, bool), pri))
    assert any(bool(o.pruned.any()) for o in outs)
    for o in outs:
        kept_amp = (o.en & torch.as_tensor(table.ample_mask)).sum(1)
        assert (kept_amp <= 1).all()


def test_front_without_constraint_or_invariants(rig):
    B, K = 16, 256
    outs = run_case(rig, B, K, windows(rig[2], rig[3], B, K, fit=True),
                    preds=False)
    for o in outs:
        t = int(o.total)
        assert o.cons_ok[:t].all() and (o.inv[:t] == -1).all()


def test_front_rejects_what_the_kernel_cannot_run(rig):
    setup = rig[1]
    d = setup.dims
    kw = dict(v2=build_v2(d, "cpu"), B=16, K=256, device="cpu")
    with pytest.raises(ValueError, match="no device code for invariant"):
        chunk_front_cuda.Front(
            dims=d, inv_fns=[lambda st: st.term[:, 0] >= 0],
            constraint=None, **kw)
    with pytest.raises(ValueError, match="no device code for constraint"):
        chunk_front_cuda.Front(
            dims=d, inv_fns=[], constraint=lambda st: st.term[:, 0] >= 0,
            **kw)
    for big in (RaftDims(n_servers=3, n_values=2, max_log=17, n_msg_slots=8),
                RaftDims(n_servers=8, n_values=2, max_log=16,
                         n_msg_slots=256)):
        with pytest.raises(ValueError, match="exceed the kernel"):
            chunk_front_cuda.Front(
                dims=big, v2=None, inv_fns=[], constraint=None, B=16,
                K=256, device="cpu")
    noleader = load_config(os.path.join(REPO, "configs/MCraft_noleader.cfg"))
    chunk_front_cuda.check_dims(noleader.dims)


def test_check_dims_raises_exactly_past_the_shared_memory():
    """``check_dims`` accepts the main path's and the other-dims phase's
    dims and raises exactly where the masks or the lanes launch would need
    more than 232,448 bytes of shared memory a block (chip_smoke.py holds
    ``lanes_smem`` against the launcher's own figure on the card)."""
    main = load_config(BOUNDED).dims
    # sw = 473, W = 12, 19 edits a lane: 16 rows of 1,904 B of ints, 8 byte
    # rows of 496 B, 64 lanes' 19 edits of 4 + 2 B and 12-int message rows,
    # 624 ints.
    assert chunk_front_cuda.lanes_smem(main) == (
        16 * 1904 + 8 * 496 + 64 * 19 * 6 + 64 * 12 * 4 + 624 * 4)
    for d in (main, RaftDims(n_servers=3, n_values=2, max_log=4,
                             n_msg_slots=40),
              RaftDims(n_servers=5, n_values=1, max_log=2, n_msg_slots=64)):
        chunk_front_cuda.check_dims(d)
    outcomes = set()
    for n, log in ((3, 16), (8, 4), (5, 8)):
        for m in range(1, chunk_front_cuda.MAX_SLOTS + 1):
            d = RaftDims(n_servers=n, n_values=2, max_log=log, n_msg_slots=m)
            over = max(chunk_front_cuda.masks_smem(d),
                       chunk_front_cuda.lanes_smem(d)) \
                > chunk_front_cuda.MAX_SMEM
            outcomes.add(over)
            if over:
                with pytest.raises(ValueError, match="exceed the kernel"):
                    chunk_front_cuda.check_dims(d)
            else:
                chunk_front_cuda.check_dims(d)
    assert outcomes == {False, True}
