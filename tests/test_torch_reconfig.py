"""The joint-consensus reconfiguration variant: port vs the JAX package.

``configs/reconfig3.cfg`` (``ReconfigDims``: 12 families, 474-byte rows
with value high-byte planes) through the port's schema, v2 masks and
``lane_out``, the v4 front's plain version, both plans of the engine, the
checkpoint, the CLI and the swarm, each against the JAX package on the
same inputs, exactly.  From Init the variant's space equals
MCraft_bounded's through level 10 (no leader exists that shallow), so the
cases start from leader roots (``scripts/leader_bench.py``
``leader_states(dims, bounds, 0)``) and from the four states of
``tests/test_reconfig.py`` that hold a membership change in each of its
phases, where config entries are appended, replicated and committed.
"""

import dataclasses
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tla_tpu.engine.bfs import BFSEngine as JEngine
from raft_tla_tpu.engine.bfs import EngineConfig as JConfig
from raft_tla_tpu.engine.swarm import SwarmEngine as JSwarm
from raft_tla_tpu.models import oracle as orc
from raft_tla_tpu.models import reconfig as jrc
from raft_tla_tpu.models import schema as jschema
from raft_tla_tpu.models.actions2 import build_v2 as j_build_v2
from raft_tla_tpu.models.dims import LEADER
from raft_tla_tpu.models.invariants import build_constraint as j_constraint
from raft_tla_tpu.models.invariants import build_type_ok as j_type_ok
from raft_tla_tpu.models.invariants import constraint_py
from raft_tla_tpu.models.invariants import type_ok_py as j_type_ok_py
from raft_tla_tpu.models.pystate import PyState as JPyState
from raft_tla_tpu.models.pystate import init_state as j_init_state
from raft_tla_tpu.models.safety import SAFETY_INVARIANTS as J_SAFETY
from raft_tla_tpu.ops.chunk_front_pallas import build_front as j_build_front
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch import cli
from raft_tla_tpu_torch.engine import checkpoint as ckpt
from raft_tla_tpu_torch.engine.bfs import BFSEngine, EngineConfig
from raft_tla_tpu_torch.engine.check import resolve_invariants
from raft_tla_tpu_torch.engine.swarm import SwarmEngine
from raft_tla_tpu_torch.models import oracle as por
from raft_tla_tpu_torch.models import reconfig as trc
from raft_tla_tpu_torch.models import schema as tschema
from raft_tla_tpu_torch.models.actions2 import V2Unavailable, build_v2
from raft_tla_tpu_torch.models.dims import RaftDims
from raft_tla_tpu_torch.models.invariants import (build_constraint,
                                                  build_inv_id,
                                                  build_no_leader,
                                                  build_type_ok, type_ok_py)
from raft_tla_tpu_torch.models.invariants import \
    constraint_py as tconstraint_py
from raft_tla_tpu_torch.models.pystate import PyState
from raft_tla_tpu_torch.models.safety import SAFETY_INVARIANTS
from raft_tla_tpu_torch.ops import chunk_front_cuda
from raft_tla_tpu_torch.ops.chunk_front import LIVE_ONLY, FrontOut
from raft_tla_tpu_torch.utils.cfg import load_config

from tests.test_torch_front import assert_equal_fronts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECONFIG = os.path.join(REPO, "configs/reconfig3.cfg")
D4_DISTINCT = 3733           # tests/test_reconfig.py, the leader roots to D4
#: TypeOK and raft.tla's nine, in configs/MCraft_safety.cfg's order.
SUITE_NAMES = ["TypeOK", "MessagesInv", "LeaderVotesQuorum",
               "CandidateTermNotInLog", "ElectionSafety", "LogMatching",
               "VotesGrantedInv", "QuorumLogInv", "MoreUpToDateCorrect",
               "LeaderCompleteness"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(s):
    return PyState(*dataclasses.astuple(s))


def to_jax(s):
    return JPyState(*dataclasses.astuple(s))


@pytest.fixture(scope="module")
def setups():
    return j_load_config(RECONFIG), load_config(RECONFIG)


def leader_roots(jsetup):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from leader_bench import leader_states
    return leader_states(jsetup.dims, jsetup.bounds, 0)


def rich_seeds(dims):
    """tests/test_reconfig.py's seeds: a term-2 leader r0 with a membership
    change pending, its joint entry committed, finalized, and a second
    change started."""
    def leader_state(log=(), commit=0):
        return j_init_state(dims).replace(
            role=(LEADER, 0, 0), current_term=(2, 1, 1),
            votes_granted=(0b111, 0, 0), log=(tuple(log), (), ()),
            commit_index=(commit, 0, 0),
            next_index=((len(log) + 1,) * 3, (1,) * 3, (1,) * 3))
    jv, fv = jrc.joint_value, jrc.final_value
    return [leader_state(log=((2, jv(7, 3)),)),
            leader_state(log=((2, jv(7, 3)),), commit=1),
            leader_state(log=((2, fv(3)), (2, 1))),
            leader_state(log=((2, fv(3)), (2, jv(3, 7))), commit=1)]


@pytest.fixture(scope="module")
def states(setups):
    """Rich seeds and their one-level offspring, the leader roots and
    three levels of theirs (joint values in log lanes and in AEReq and
    RVResp value columns)."""
    jsetup = setups[0]
    dims, bounds = jsetup.dims, jsetup.bounds
    rich = orc.bfs(rich_seeds(dims), dims, constraint=constraint_py(bounds),
                   check_deadlock=False, max_levels=1)
    lead = orc.bfs(leader_roots(jsetup), dims,
                   constraint=constraint_py(bounds), check_deadlock=False,
                   max_levels=3)
    picked = sorted(lead.parent, key=hash)[::7][:150]
    out = list(rich.parent) + picked
    assert any(v >= jrc.CFG_BASE for s in out for log in s.log
               for _t, v in log)
    return out


def port_batch(states, dims):
    return tschema.stack_states(
        [tschema.encode_state(to_port(s), dims) for s in states], "cpu")


# -- schema ------------------------------------------------------------------

@pytest.mark.parametrize("L", [3, 5, 2, 1])
def test_rows_and_width_equal_jax(states, L):
    """flatten/unflatten at the cfg's max_log 3 (474 B) and at 5, 2 (column
    8 both an AEReq and an RVResp value column) and 1 (column 8 after the
    mlog values), with joint value 5891 and the final value of {r1, r2}."""
    jd = jrc.ReconfigDims(3, 1, max_log=L, n_msg_slots=24, targets=(3, 7))
    td = trc.ReconfigDims(3, 1, max_log=L, n_msg_slots=24, targets=(3, 7))
    assert trc.joint_value(7, 3) == jrc.joint_value(7, 3) == 5891
    assert trc.final_value(3) == jrc.final_value(3) == 4099
    assert tschema.state_width(td) == jschema.state_width(jd)
    if L == 3:
        assert tschema.state_width(td) == 474
    def fits(s):
        return all(len(x) <= L for x in s.log) and all(
            len(m[5]) <= L for m, _c in s.messages if m[0] == 1)

    sts = [s for s in states if fits(s)]
    base = j_init_state(jd)
    for v in (5891, 4099, jrc.joint_value(7, 7), 36735):
        sts.append(base.replace(log=(((1, v),), (), ()), messages=frozenset({
            ((2, 0, 1, 1, 0, 0, ((1, v),), 0), 1),
            ((1, 1, 0, 1, 1, ((1, v),) * L), 1)})))
    want = np.stack([jschema.flatten_state(jschema.encode_state(s, jd), jd)
                     for s in sts])
    st = port_batch(sts, td)
    rows = tschema.flatten_state(st, td)
    assert rows.shape == (len(sts), tschema.state_width(td))
    assert np.array_equal(rows.numpy(), want)
    back = tschema.unflatten_state(rows, td)
    for a, b in zip(back, st):
        assert torch.equal(a, b)
    got = [tschema.decode_state(tschema.StateBatch(*(f[x] for f in back)),
                                td) for x in range(len(sts))]
    assert got == [to_port(s) for s in sts]


def test_pack_guard_and_the_eight_server_rejection(setups):
    jsetup, setup = setups
    jd, td = jsetup.dims, setup.dims
    for mod in (jrc, trc):
        with pytest.raises(ValueError, match="at most 7 servers"):
            mod.ReconfigDims(8, 1, targets=(3,))
        with pytest.raises(ValueError, match="at least one target"):
            mod.ReconfigDims(3, 1)
        with pytest.raises(ValueError, match="not a nonempty subset"):
            mod.ReconfigDims(3, 1, targets=(8,))
    base = j_init_state(jd)
    ok = base.replace(log=(((1, 65535),), (), ()))
    bad = base.replace(log=(((1, 65536),), (), ()))
    msg_bad = base.replace(messages=frozenset({
        ((2, 0, 1, 1, 0, 0, ((1, 70000),), 0), 1)}))
    for s, fits in ((ok, True), (bad, False), (msg_bad, False)):
        e = tschema.encode_state(to_port(s), td)
        if fits:
            tschema.check_packable(e, td)
            jschema.check_packable(jschema.encode_state(s, jd), jd)
        else:
            with pytest.raises(ValueError, match="packable"):
                tschema.check_packable(e, td)
            with pytest.raises(ValueError, match="packable"):
                jschema.check_packable(jschema.encode_state(s, jd), jd)
    sts = [ok, bad, msg_bad, base]
    guard = jax.vmap(jschema.build_pack_guard(jd))
    jst = jax.tree.map(jnp.asarray, jschema.stack_states(
        [jschema.encode_state(s, jd) for s in sts]))
    want = np.asarray(guard(jst))
    assert want.tolist() == [True, False, False, True]
    assert tschema.pack_ok(port_batch(sts, td), td).tolist() == want.tolist()


def test_grid_and_type_ok_equal_jax(setups, states):
    jsetup, setup = setups
    jd, td = jsetup.dims, setup.dims
    assert td.family_names == jd.family_names
    assert td.family_sizes == jd.family_sizes and td.n_instances == 114
    for g in range(td.n_instances):
        assert td.instance_info(g) == jd.instance_info(g)
        assert td.describe_instance(g) == jd.describe_instance(g)
    base = j_init_state(jd)
    bad = [base.replace(log=(((1, v),), (), ()))
           for v in (4096, 4096 + (8 << 8) + 1, 4096 + 8, 2, 0x10000 + 4099)]
    sts = states + bad
    want = np.asarray(jax.vmap(j_type_ok(jd))(jax.tree.map(
        jnp.asarray, jschema.stack_states(
            [jschema.encode_state(s, jd) for s in sts]))))
    assert want[:len(states)].all() and not want[len(states):].any()
    got = build_type_ok(td)(port_batch(sts, td))
    assert got.tolist() == want.tolist()
    assert [type_ok_py(to_port(s), td) for s in sts] == \
        [j_type_ok_py(s, jd) for s in sts]
    for v in (1, 2, 4099, 5891, 36735, 4096, 65535):
        assert td.value_ok_py(v) == jd.value_ok_py(v)
    for s in states:
        for i in range(3):
            for mask in range(8):
                assert td.quorum_py(to_port(s), i, mask) == \
                    jd.quorum_py(s, i, mask)


# -- the v2 pipeline ---------------------------------------------------------

@pytest.fixture(scope="module")
def jax_v2(setups, states):
    jd = setups[0].dims
    jv2 = j_build_v2(jd)
    G = jd.n_instances

    @jax.jit
    @jax.vmap
    def v2_all(st):
        en, ovf = jv2.masks(st)
        ph = jv2.parent_hash(st)
        h, l, succ = jax.vmap(jv2.lane_out, (None, None, 0))(
            st, ph, jnp.arange(G, dtype=jnp.int32))
        rows = jax.vmap(jschema.flatten_state, (0, None))(succ, jd)
        return en, ovf, h, l, rows

    jst = jax.tree.map(jnp.asarray, jschema.stack_states(
        [jschema.encode_state(s, jd) for s in states]))
    return jax.tree.map(np.asarray, v2_all(jst))


def test_masks_and_lane_out_equal_jax_build_v2(setups, states, jax_v2):
    td = setups[1].dims
    en_w, ovf_w, h_w, l_w, rows_w = jax_v2
    st = port_batch(states, td)
    v2 = build_v2(td, "cpu")
    en, ovf = v2.masks(st)
    assert np.array_equal(en.numpy(), en_w)
    assert np.array_equal(ovf.numpy(), ovf_w)
    fam_off = td.family_offsets
    assert en_w[:, fam_off[10]:fam_off[11]].any()          # Initiate
    assert en_w[:, fam_off[11]:].any()                     # Finalize
    x, g = torch.as_tensor(en_w.copy()).nonzero(as_tuple=True)
    ph = v2.parent_hash(st)
    kph = type(ph)(*(f.index_select(0, x) for f in ph))
    kh, kl, succ = v2.lane_out(tschema.gather_states(st, x), kph, g)
    xs, gs = x.numpy(), g.numpy()
    assert np.array_equal(kh.numpy(), h_w[xs, gs].astype(np.int64))
    assert np.array_equal(kl.numpy(), l_w[xs, gs].astype(np.int64))
    assert np.array_equal(tschema.flatten_state(succ, td).numpy(),
                          rows_w[xs, gs])
    # Without hashes, the same successors.
    _h, _l, succ2 = v2.lane_out(tschema.gather_states(st, x), None, g,
                                hashes=False)
    assert all(torch.equal(a, b) for a, b in zip(succ, succ2))


def test_masks_without_guards_only_kernels_and_v2_refusals(setups, states):
    """A variant without build_extra_masks_v2 takes its extra kernels'
    successors and their pack guard: the same masks.  One without v2
    kernels raises V2Unavailable, a short mask list ValueError."""
    td = setups[1].dims
    fields = {f.name: getattr(td, f.name) for f in dataclasses.fields(td)}

    class NoMasks(trc.ReconfigDims):
        def build_extra_masks_v2(self):
            return None

    class NoV2(trc.ReconfigDims):
        def build_extra_v2(self, fp):
            return None

    class ShortMasks(trc.ReconfigDims):
        def build_extra_masks_v2(self):
            return super().build_extra_masks_v2()[:1]

    st = port_batch(states, td)
    want = build_v2(td, "cpu").masks(st)
    got = build_v2(NoMasks(**fields), "cpu").masks(st)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    with pytest.raises(V2Unavailable):
        build_v2(NoV2(**fields), "cpu")
    with pytest.raises(ValueError, match="returned 1 kernels"):
        build_v2(ShortMasks(**fields), "cpu")


# -- the v4 front ------------------------------------------------------------

def test_front_plain_equals_jax_build_front(setups):
    """A window of the rich seeds' offspring and the leader roots' states
    to depth 4 (both extra families enabled in it) through the JAX front
    (interpret mode) and the port's front on the CPU (front_plain)."""
    jsetup, setup = setups
    jd, td = jsetup.dims, setup.dims
    bounds = constraint_py(jsetup.bounds)
    lead = orc.bfs(leader_roots(jsetup), jd, constraint=bounds,
                   check_deadlock=False, max_levels=4)
    rich = orc.bfs(rich_seeds(jd), jd, constraint=bounds,
                   check_deadlock=False, max_levels=1)
    B, K = 32, 512
    window = (sorted(rich.parent, key=hash)[:16]
              + sorted(lead.parent, key=hash)[::97])[:B]
    rows = tschema.flatten_state(port_batch(window, td), td)
    valid = torch.ones(B, dtype=torch.bool)
    valid[5] = False
    jf = j_build_front(dims=jd, v2=j_build_v2(jd),
                       constraint=j_constraint(jd, jsetup.bounds),
                       inv_fns=[j_type_ok(jd)], B=B, G=jd.n_instances, K=K,
                       interpret=True)
    tf = chunk_front_cuda.Front(
        dims=td, v2=build_v2(td, "cpu"), inv_fns=[build_type_ok(td)],
        constraint=build_constraint(td, setup.bounds), B=B, K=K,
        device="cpu")
    assert tf.reconfig and not tf.suite
    want = jax.device_get(jf(jnp.asarray(rows.numpy()),
                             jnp.asarray(valid.numpy())))
    got = tf(rows, valid)
    total = int(got.total)
    for name, w, g in zip(FrontOut._fields, want, got):
        w, g = np.asarray(w), g.numpy()
        if name in ("kh", "kl", "parent_hi", "parent_lo"):
            w = w.astype(np.int64)
        if name in LIVE_ONLY:
            w, g = w[:total], g[:total]
        assert np.array_equal(w, g), name
    acts = got.lane_id[:total].numpy() % td.n_instances
    offs = td.family_offsets
    assert ((acts >= offs[10]) & (acts < offs[11])).any()
    assert (acts >= offs[11]).any()


def test_front_refuses_what_the_variant_builds_lack(setups):
    """The variant's builds take TypeOK and NoLeaderElected
    (``reconfig``) and the safety suite (``reconfig_suite``, build 8 of
    the launch table); another variant and more than 32 targets are
    refused."""
    td, bounds = setups[1].dims, setups[1].bounds
    kw = dict(v2=build_v2(td, "cpu"), constraint=build_constraint(td, bounds),
              B=16, K=2048, device="cpu")
    suite = SAFETY_INVARIANTS["ElectionSafety"](td)
    fr = chunk_front_cuda.Front(dims=td, inv_fns=[build_type_ok(td), suite],
                                **kw)
    assert fr.reconfig and fr.suite and fr.build_name == "reconfig_suite"
    assert fr._builds() == (5, 1, 6, 8)
    assert fr.record() == {"build": "reconfig_suite",
                           "predicates": [1, 6], "launches": {}}
    fr = chunk_front_cuda.Front(dims=td, inv_fns=[build_no_leader(td)],
                                **kw)
    assert fr.reconfig and fr._n_targets == 2
    assert fr.build_name == "reconfig" and fr._builds() == (5, 1, 6, 7)

    class OtherVariant(RaftDims):
        @property
        def extra_families(self):
            return (("Nop", 1),)

    with pytest.raises(ValueError, match="no device code for the variant"):
        chunk_front_cuda.check_dims(OtherVariant(3, 1, 3, 24))
    many = trc.ReconfigDims(7, 1, 3, 8, targets=tuple(range(1, 34)))
    with pytest.raises(ValueError, match="at most 32"):
        chunk_front_cuda.check_dims(many)


def suite_fns(names, dims, package):
    """The registry predicates ``names`` of one package: TypeOK and the
    suite's."""
    if package == "jax":
        return [j_type_ok(dims) if n == "TypeOK" else J_SAFETY[n](dims)
                for n in names]
    return [build_type_ok(dims) if n == "TypeOK" else SAFETY_INVARIANTS[n](dims)
            for n in names]


@pytest.mark.parametrize("order", ["cfg", "reversed"])
def test_front_plain_with_the_suite_equals_jax_build_front(setups, order):
    """The suite on the variant: windows of the rich seeds' offspring
    (crafted states mid-change), of the leader roots' states to depth 3
    (config entries in logs and in messages, joint and final, after a
    legal election) and of ``models/reconfig.py random_states`` (config
    values, some of them invalid, in a third of the entries), through the
    JAX front (interpret mode) with the JAX suite and the port's front on
    the CPU (``front_plain``) with the port's, field by field; the list in
    the cfg's order and the nine in reverse.  Between the two orders the
    random windows fail every predicate first somewhere, the elected ones
    none."""
    jsetup, setup = setups
    jd, td = jsetup.dims, setup.dims
    names = SUITE_NAMES if order == "cfg" else SUITE_NAMES[:0:-1]
    bounds = constraint_py(jsetup.bounds)
    lead = orc.bfs(leader_roots(jsetup), jd, constraint=bounds,
                   check_deadlock=False, max_levels=3)
    rich = orc.bfs(rich_seeds(jd), jd, constraint=bounds,
                   check_deadlock=False, max_levels=1)
    B, K = 16, 512
    crafted = [to_port(s) for s in sorted(rich.parent, key=hash)[:B]]
    elected = [to_port(s) for s in sorted(lead.parent, key=hash)[::29][:B]]
    for states in (crafted, elected):
        assert any(v >= trc.CFG_BASE for s in states for log in s.log
                   for _t, v in log)
    jf = j_build_front(dims=jd, v2=j_build_v2(jd),
                       constraint=j_constraint(jd, jsetup.bounds),
                       inv_fns=suite_fns(names, jd, "jax"), B=B,
                       G=jd.n_instances, K=K, interpret=True)
    tf = chunk_front_cuda.Front(
        dims=td, v2=build_v2(td, "cpu"), inv_fns=suite_fns(names, td, "port"),
        constraint=build_constraint(td, setup.bounds), B=B, K=K,
        device="cpu")
    assert tf.build_name == "reconfig_suite"
    first = {"crafted": set(), "elected": set(), "random": set()}
    windows = [("crafted", crafted), ("elected", elected),
               ("random", trc.random_states(td, B, seed=5)),
               ("random", trc.random_states(td, B, seed=6)),
               ("random", trc.random_states(td, B, seed=7))]
    for kind, parents in windows:
        rows = torch.zeros((B, tschema.state_width(td)), dtype=torch.uint8)
        rows[:len(parents)] = tschema.flatten_state(tschema.stack_states(
            [tschema.encode_state(s, td) for s in parents], "cpu"), td)
        valid = (torch.arange(B) % 6 != 5) & (torch.arange(B) < len(parents))
        want = jax.device_get(jf(jnp.asarray(rows.numpy()),
                                 jnp.asarray(valid.numpy())))
        got = tf(rows, valid)
        assert_equal_fronts(want, got)
        first[kind].update(got.inv[:int(got.total)].tolist())
    assert first["elected"] == {-1}, first
    # Between the two orders every predicate fails first somewhere: in the
    # cfg's order all but the two rarest, which the reversed list puts
    # first.
    failed = {names[i] for i in first["random"] if i >= 0}
    rare = {"cfg": {"MoreUpToDateCorrect", "LeaderCompleteness"},
            "reversed": {"VotesGrantedInv"}}[order]
    assert failed >= set(names) - rare, (order, failed)


# -- the engine, the checkpoint, the CLI -------------------------------------

def port_engine(setup, **kw):
    base = dict(batch=128, queue_capacity=1 << 14, seen_capacity=1 << 17,
                check_deadlock=False)
    base.update(kw)
    return BFSEngine(setup.dims, constraint=build_constraint(
        setup.dims, setup.bounds), invariants={
            "TypeOK": build_type_ok(setup.dims)},
        config=EngineConfig(**base), device="cpu")


def jax_engine(jsetup, **kw):
    base = dict(batch=128, queue_capacity=1 << 14, seen_capacity=1 << 17,
                record_trace=True, check_deadlock=False,
                statespace_report=False)
    base.update(kw)
    return JEngine(jsetup.dims, constraint=j_constraint(
        jsetup.dims, jsetup.bounds), invariants={
            "TypeOK": j_type_ok(jsetup.dims)}, config=JConfig(**base))


def level_file(ckdir, level):
    return os.path.join(str(ckdir), f"level_{level:05d}.npz")


@pytest.fixture(scope="module")
def jax_d4(setups, tmp_path_factory):
    """The JAX engine from the leader roots to D4, a snapshot a level."""
    ckdir = str(tmp_path_factory.mktemp("jax_reconfig"))
    res = jax_engine(setups[0], max_diameter=4, checkpoint_dir=ckdir).run(
        leader_roots(setups[0]))
    assert res.distinct == D4_DISTINCT
    return res, ckdir


def keys(path):
    with np.load(path) as z:
        return set(zip(z["seen_hi"].tolist(), z["seen_lo"].tolist()))


@pytest.mark.parametrize("pipeline,method", [("v3", "fused"),
                                             ("v4", "fused"),
                                             ("v4", "kernel")])
def test_leader_roots_to_d4_equal_jax(setups, jax_d4, tmp_path, pipeline,
                                      method):
    jres, jdir = jax_d4
    ckdir = str(tmp_path / "port")
    roots = [to_port(s) for s in leader_roots(setups[0])]
    res = port_engine(setups[1], max_diameter=4, pipeline=pipeline,
                      enqueue_method=method, checkpoint_dir=ckdir).run(roots)
    assert (res.distinct, res.generated, res.levels) == \
        (jres.distinct, jres.generated, jres.levels)
    assert res.action_counts == jres.action_counts
    assert res.action_counts["InitiateReconfig"] > 0
    assert keys(level_file(ckdir, 4)) == keys(level_file(jdir, 4))
    # The snapshots of the two packages hold the same frontier rows.
    with np.load(level_file(ckdir, 2)) as a, \
            np.load(level_file(jdir, 2)) as b:
        assert a["frontier"].shape[1] == 474
        assert np.array_equal(a["frontier"], b["frontier"])


def test_snapshots_cross_between_the_packages(setups, jax_d4, tmp_path):
    jres, jdir = jax_d4
    ck = ckpt.load(level_file(jdir, 2))
    assert type(ck.dims) is trc.ReconfigDims and ck.dims.targets == (3, 7)
    res = port_engine(setups[1], max_diameter=4).run(
        resume=level_file(jdir, 2))
    assert (res.distinct, res.generated, res.levels) == \
        (jres.distinct, jres.generated, jres.levels)
    pdir = str(tmp_path / "port")
    port_engine(setups[1], max_diameter=2, checkpoint_dir=pdir).run(
        [to_port(s) for s in leader_roots(setups[0])])
    back = jax_engine(setups[0], max_diameter=4).run(
        resume=level_file(pdir, 2))
    assert (back.distinct, back.levels) == (jres.distinct, jres.levels)


def test_v4_with_the_suite_equals_v3_and_counts_joint(setups):
    """reconfig3 with the ten invariants from the leader roots to D4: v4
    (both tails) equals the v3 plan, with no violation; v4's ``built`` is
    the distinct states less the roots and ``joint`` the port oracle's
    count of those in which some server's latest config entry is joint."""
    jsetup, setup = setups
    dims = setup.dims
    invs = resolve_invariants(dataclasses.replace(setup,
                                                  invariants=SUITE_NAMES))
    roots = [to_port(s) for s in leader_roots(jsetup)]
    got = {}
    for pipeline, method in (("v3", "fused"), ("v4", "fused"),
                             ("v4", "kernel")):
        eng = BFSEngine(dims, invariants=invs,
                        constraint=build_constraint(dims, setup.bounds),
                        config=EngineConfig(
                            batch=128, queue_capacity=1 << 14,
                            seen_capacity=1 << 17, check_deadlock=False,
                            max_diameter=4, pipeline=pipeline,
                            enqueue_method=method), device="cpu")
        res = eng.run(roots)
        assert res.violation is None and res.invariants == SUITE_NAMES
        got[pipeline, method] = res
    v3 = got["v3", "fused"]
    assert v3.distinct == D4_DISTINCT and (v3.built, v3.joint) == (0, 0)
    ores = por.bfs(roots, dims, constraint=tconstraint_py(setup.bounds),
                   check_deadlock=False, max_levels=4)
    joint = sum(1 for s in ores.parent if s not in roots and any(
        trc.config_of_py(log, dims.n_servers)[0] for log in s.log))
    assert joint > 0
    for key in (("v4", "fused"), ("v4", "kernel")):
        res = got[key]
        assert (res.distinct, res.generated, res.levels,
                res.action_counts) == (v3.distinct, v3.generated, v3.levels,
                                       v3.action_counts), key
        assert (res.built, res.joint) == (res.distinct - len(roots),
                                          joint), key
        assert res.front["build"] == "reconfig_suite"


def test_rich_seeds_to_d3_equal_the_jax_engine(setups):
    """The four seeds to D3 on both plans: distinct, generated, levels and
    family counts the JAX engine's, FinalizeReconfig among them."""
    jsetup, setup = setups
    seeds = rich_seeds(jsetup.dims)
    want = jax_engine(jsetup, max_diameter=3).run(seeds)
    assert want.action_counts["FinalizeReconfig"] > 0
    for pipeline in ("v3", "v4"):
        res = port_engine(setup, max_diameter=3, pipeline=pipeline).run(
            [to_port(s) for s in seeds])
        assert res.violation is None
        assert (res.distinct, res.generated, res.levels) == \
            (want.distinct, want.generated, want.levels)
        assert res.action_counts == want.action_counts


def test_cli_checks_reconfig3_from_init(setups, capsys):
    jsetup = setups[0]
    ores = orc.bfs([j_init_state(jsetup.dims)], jsetup.dims,
                   invariants={"TypeOK": j_type_ok_py},
                   constraint=constraint_py(jsetup.bounds), max_levels=3)
    for pipeline in ("v3", "v4"):
        rc = cli.main(["check", RECONFIG, "--device", "cpu",
                       "--max-diameter", "3", "--pipeline", pipeline])
        out = capsys.readouterr().out
        assert rc == 0, out
        assert f"distinct states    {ores.distinct_states}\n" in out
        assert f"states generated   {ores.generated_states}\n" in out
        assert "InitiateReconfig" in out


# -- the swarm and chip_smoke.py's roots -------------------------------------

def test_swarm_equals_the_jax_swarm(setups):
    """64 walks, depth 16, chunk 8, seed 3, from the leader roots: the
    visited multiset and the counts of the JAX swarm (hunt off)."""
    jsetup, setup = setups
    roots = leader_roots(jsetup)
    kw = dict(walks=64, max_depth=16, chunk=8, ring=8,
              collect_fingerprints=True)
    want = JSwarm(jsetup.dims, invariants={"TypeOK": j_type_ok(jsetup.dims)},
                  constraint=j_constraint(jsetup.dims, jsetup.bounds),
                  hunt=False, **kw).run(roots, seed=3, num_steps=32)
    got = SwarmEngine(setup.dims,
                      invariants={"TypeOK": build_type_ok(setup.dims)},
                      constraint=build_constraint(setup.dims, setup.bounds),
                      device="cpu", **kw).run(
        [to_port(s) for s in roots], seed=3, num_steps=32)

    def fps(r):
        f = r.visited_fingerprints
        return f[np.lexsort((f[:, 1], f[:, 0]))]

    assert (got.steps, got.visited, got.traces, got.diameter,
            got.stop_reason) == (want.steps, want.visited, want.traces,
                                 want.diameter, want.stop_reason)
    assert got.steps == 64 * 32
    assert np.array_equal(fps(got), fps(want))


def test_chip_smoke_leader_roots_equal_leader_states(setups):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jsetup, setup = setups
    got = mod.leader_roots(setup.dims)
    assert got == [to_port(s) for s in leader_roots(jsetup)]
    st = port_batch([to_jax(s) for s in got], setup.dims)
    assert build_inv_id([build_type_ok(setup.dims)])(st).tolist() == \
        [-1] * len(got)
