"""Host copies, the packed row and the fingerprint: port vs JAX package.

Every comparison is exact: rows are bytes, fingerprints 32-bit lanes.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tla_tpu.models import schema as jschema
from raft_tla_tpu.models import smoke
from raft_tla_tpu.models.dims import RaftDims as JDims
from raft_tla_tpu.models.pystate import init_state as j_init_state
from raft_tla_tpu.models.pystate import probe_states
from raft_tla_tpu.ops import fingerprint as jfp
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch.models import schema as tschema
from raft_tla_tpu_torch.models.dims import RaftDims as TDims
from raft_tla_tpu_torch.models.pystate import PyState as TPyState
from raft_tla_tpu_torch.models.pystate import init_state as t_init_state
from raft_tla_tpu_torch.ops import fingerprint as tfp
from raft_tla_tpu_torch.utils.cfg import load_config as t_load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JD = JDims(n_servers=3, n_values=2, max_log=3, n_msg_slots=32)
TD = TDims(n_servers=3, n_values=2, max_log=3, n_msg_slots=32)


def to_port(s):
    return TPyState(**{f.name: getattr(s, f.name)
                       for f in dataclasses.fields(s)})


@pytest.fixture(scope="module")
def states():
    return (probe_states(JD) + smoke.random_states(JD, 300, seed=5)
            + [j_init_state(JD)])


def _jax_rows(states):
    return np.stack([jschema.flatten_state(jschema.encode_state(s, JD), JD)
                     for s in states])


def _port_batch(states):
    return tschema.stack_states(
        [tschema.encode_state(to_port(s), TD) for s in states], "cpu")


def test_dims_copy_matches():
    for n, v, L, m in ((3, 2, 3, 32), (5, 2, 5, 32), (1, 1, 2, 8)):
        a, b = JDims(n, v, L, m), TDims(n, v, L, m)
        assert a.family_sizes == b.family_sizes
        assert a.family_offsets == b.family_offsets
        assert a.msg_width == b.msg_width
        assert [a.describe_instance(g) for g in range(a.n_instances)] == \
            [b.describe_instance(g) for g in range(b.n_instances)]
        assert jschema.state_width(a) == tschema.state_width(b)
    assert dataclasses.astuple(j_init_state(JD)) == \
        dataclasses.astuple(t_init_state(TD))


def test_flatten_rows_byte_equal_and_round_trip(states):
    want = _jax_rows(states)
    st = _port_batch(states)
    got = tschema.flatten_state(st, TD).numpy()
    assert got.dtype == np.uint8 and (got == want).all()
    back = tschema.unflatten_state(torch.as_tensor(want), TD)
    for x, s in enumerate(states):
        one = tschema.StateBatch(*(f[x] for f in back))
        assert tschema.decode_state(one, TD) == to_port(s)
    # The JAX unflatten of the same rows gives the same int fields.
    jst = jax.vmap(jschema.unflatten_state, (0, None))(jnp.asarray(want),
                                                       JD)
    for name, a, b in zip(back._fields, back, jst):
        assert (a.numpy() == np.asarray(b)).all(), name


def test_pack_guard_matches(states):
    edge = [s.replace(current_term=(255, 256, 1)) for s in states[:5]]
    edge += [s.replace(current_term=(128, 1, 1)) for s in states[5:10]]
    allst = states + edge
    guard = jax.jit(jax.vmap(jschema.build_pack_guard(JD)))
    want = np.asarray(guard(jax.tree.map(jnp.asarray, jschema.stack_states(
        [jschema.encode_state(s, JD) for s in allst]))))
    got = tschema.pack_ok(_port_batch(allst), TD).numpy()
    assert (got == want).all() and not want.all() and want.any()


def test_fmix32_matches_numpy_uint32():
    rng = np.random.RandomState(1)
    x = rng.randint(0, 1 << 32, 100_000, dtype=np.uint64).astype(np.uint32)
    want = x.copy()
    with np.errstate(over="ignore"):
        want ^= want >> np.uint32(16)
        want *= np.uint32(0x85EBCA6B)
        want ^= want >> np.uint32(13)
        want *= np.uint32(0xC2B2AE35)
        want ^= want >> np.uint32(16)
    got = tfp.fmix32(torch.as_tensor(x.astype(np.int64))).numpy()
    assert (got == want.astype(np.int64)).all()
    assert (np.asarray(jfp.fmix32(jnp.asarray(x))) == want).all()
    assert tfp.mul32(0xFFFFFFFF, 0xFFFFFFFF) == 1


def test_fingerprints_equal(states):
    jf = jax.jit(jax.vmap(jfp.build_fingerprint(JD)))
    jst = jax.tree.map(
        jnp.asarray, jschema.stack_states(
            [jschema.encode_state(s, JD) for s in states]))
    jh, jl = (np.asarray(a).astype(np.int64) for a in jf(jst))
    th, tl = tfp.build_fingerprint(TD, "cpu")(_port_batch(states))
    assert (th.numpy() == jh).all() and (tl.numpy() == jl).all()
    # Fingerprints of the packed rows (what the engines hash) agree too.
    rows = torch.as_tensor(_jax_rows(states))
    rh, rl = tfp.build_fingerprint(TD, "cpu")(
        tschema.unflatten_state(rows, TD))
    assert (rh.numpy() == jh).all() and (rl.numpy() == jl).all()


def test_fingerprint_constants_shared():
    from raft_tla_tpu_torch.interop import fingerprint_constants
    c = fingerprint_constants(TD)
    rng = np.random.RandomState(0x7A57)
    d = 3 * (7 + 2 * 3) + 2 * 9
    for lane in (0, 1):
        c_ord = rng.randint(0, 1 << 32, d, dtype=np.uint64) \
            .astype(np.uint32) | 1
        c_msg = rng.randint(0, 1 << 32, TD.msg_width, dtype=np.uint64) \
            .astype(np.uint32) | 1
        seed = int(rng.randint(1, 1 << 32, dtype=np.uint64) | 1)
        assert (c[lane][0] == c_ord).all() and (c[lane][1] == c_msg).all()
        assert c[lane][2] == seed & 0xFFFFFFFF


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "configs", "*.cfg"))), ids=os.path.basename)
def test_cfg_copy_matches(path):
    want = j_load_config(path)
    got = t_load_config(path)
    wd, gd = want.dims, got.dims
    assert (wd.n_servers, wd.n_values, wd.max_log, wd.n_msg_slots) == \
        (gd.n_servers, gd.n_values, gd.max_log, gd.n_msg_slots)
    # The dims class (the reconfiguration variant for TargetConfigs) and
    # its targets.
    assert type(wd).__name__ == type(gd).__name__
    assert getattr(wd, "targets", None) == getattr(gd, "targets", None)
    assert wd.family_sizes == gd.family_sizes
    assert jschema.state_width(wd) == tschema.state_width(gd)
    assert dataclasses.astuple(want.bounds) == dataclasses.astuple(got.bounds)
    for f in ("invariants", "constraints", "check_deadlock", "max_seconds",
              "max_diameter", "exit_conditions", "server_names",
              "value_names", "backend"):
        assert getattr(want, f) == getattr(got, f), f
