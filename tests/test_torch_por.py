"""The port's POR table record, admission and masked runs vs the JAX package.

Base Raft certifies no instance, so, as in ``tests/test_por.py``, the
masking machinery is driven by a forged table that certifies every
DuplicateMessage instance.  The table goes through ``load_table`` /
``check_table`` of both packages, then the port's v3 and v4 engines run
against the JAX engine with the same table.  All comparisons are exact
(integers and strings: tolerance 0).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from raft_tla_tpu.analysis import por as jpor
from raft_tla_tpu.engine.bfs import BFSEngine as JEngine
from raft_tla_tpu.engine.bfs import EngineConfig as JConfig
from raft_tla_tpu.models.invariants import Bounds as JBounds
from raft_tla_tpu.models.invariants import build_constraint as j_constraint
from raft_tla_tpu.models.invariants import build_type_ok as j_type_ok
from raft_tla_tpu.models.pystate import init_state as j_init_state
from raft_tla_tpu.utils.cfg import load_config as j_load_config
from raft_tla_tpu_torch import cli
from raft_tla_tpu_torch.analysis import por
from raft_tla_tpu_torch.engine.bfs import (BFSEngine, EngineConfig,
                                           por_device_arrays)
from raft_tla_tpu_torch.engine.check import (engine_config_from_backend,
                                             make_engine)
from raft_tla_tpu_torch.engine.chunk import build_chunk_body
from raft_tla_tpu_torch.models.dims import RaftDims
from raft_tla_tpu_torch.models.invariants import (Bounds, build_constraint,
                                                  build_type_ok)
from raft_tla_tpu_torch.models.pystate import init_state
from raft_tla_tpu_torch.utils.cfg import load_config

from tests.test_por import BOUNDS as J_BOUNDS
from tests.test_por import DIMS as J_DIMS
from tests.test_por import forged_dup_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")
DIMS = RaftDims(n_servers=3, n_values=2, max_log=4, n_msg_slots=8)
BOUNDS = Bounds(max_term=2, max_log_len=1, max_msg_count=1)


def to_port(table) -> por.PorTable:
    return por.PorTable.from_json(table.to_json())


def empty_table(dims=J_DIMS):
    G = dims.n_instances
    return jpor.PorTable(model=repr(dims), n_instances=G,
                         ample_mask=np.zeros(G, bool),
                         priority=np.arange(G, dtype=np.int32),
                         predicates=("TypeOK", "CONSTRAINT"))


# ---------------------------------------------------------------------------
# The record and its admission


def test_model_signature_is_shared():
    assert repr(DIMS) == repr(J_DIMS)
    assert (DIMS.n_instances, DIMS.family_names) == \
        (J_DIMS.n_instances, J_DIMS.family_names)
    assert (BOUNDS.max_term, BOUNDS.max_log_len, BOUNDS.max_msg_count) == \
        (J_BOUNDS.max_term, J_BOUNDS.max_log_len, J_BOUNDS.max_msg_count)


@pytest.mark.parametrize("make", [forged_dup_table, empty_table])
def test_artifact_crosses_both_ways_with_one_fingerprint(make, tmp_path):
    jt = make()
    a, b = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jt.save(a)
    pt = por.load_table(a)                     # JAX writes, the port reads
    assert pt.fingerprint == jt.fingerprint
    assert pt.certified == jt.certified
    assert np.array_equal(pt.ample_mask, jt.ample_mask)
    assert pt.priority.dtype == np.int32
    assert np.array_equal(pt.priority, jt.priority)
    pt.save(b)                                 # the port writes, JAX reads
    assert open(a).read() == open(b).read()
    assert jpor.load_table(b).fingerprint == jt.fingerprint


def test_edited_mask_is_refused_by_both(tmp_path):
    path = tmp_path / "por.json"
    doc = forged_dup_table().to_json()
    doc["ample_mask"][0] = 1                   # the fingerprint now lies
    path.write_text(json.dumps(doc))
    for mod in (por, jpor):
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            mod.load_table(str(path))
    doc = forged_dup_table().to_json()
    doc["version"] = 1
    doc.pop("granularity")
    for mod in (por, jpor):
        with pytest.raises(ValueError, match="coarser footprint"):
            mod.PorTable.from_json(doc)
    with pytest.raises(ValueError, match=r"\[n_instances\]"):
        por.PorTable(model="m", n_instances=4, ample_mask=np.zeros(3, bool),
                     priority=np.zeros(4, np.int32), predicates=())


@pytest.mark.parametrize("case,match", [
    ("wrong_model", "certified for model"),
    ("missing_predicate", "NoLeaderElected"),
    ("missing_constraint", "CONSTRAINT")])
def test_admission_refusals_equal_jax(case, match):
    other = dict(n_servers=2, n_values=1, max_log=2, n_msg_slots=4)
    for mod, dims, other_dims in (
            (por, DIMS, RaftDims(**other)),
            (jpor, J_DIMS, type(J_DIMS)(**other))):
        table = forged_dup_table()
        table = table if mod is jpor else to_port(table)
        mod.check_table(table, dims, invariant_names=["TypeOK"],
                        has_constraint=True)              # admitted
        with pytest.raises(ValueError, match=match):
            if case == "wrong_model":
                mod.check_table(table, other_dims)
            elif case == "missing_predicate":
                mod.check_table(table, dims,
                                invariant_names=["TypeOK",
                                                 "NoLeaderElected"])
            else:
                bare = forged_dup_table(predicates=("TypeOK",))
                bare = bare if mod is jpor else to_port(bare)
                mod.check_table(bare, dims, invariant_names=["TypeOK"],
                                has_constraint=True)


def port_engine(pipeline, table=None, dims=DIMS, bounds=BOUNDS, **kw):
    base = dict(batch=32, queue_capacity=1 << 12, seen_capacity=1 << 15,
                check_deadlock=False, max_diameter=3, pipeline=pipeline,
                por_table=table)
    base.update(kw)
    return BFSEngine(dims, invariants={"TypeOK": build_type_ok(dims)},
                     constraint=build_constraint(dims, bounds),
                     config=EngineConfig(**base), device="cpu")


def test_engine_refuses_what_admission_refuses(tmp_path):
    path = tmp_path / "por.json"
    doc = forged_dup_table().to_json()
    doc["ample_mask"][0] = 1
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        port_engine("v3", str(path))
    with pytest.raises(ValueError, match="CONSTRAINT"):
        port_engine("v4", to_port(forged_dup_table(predicates=("TypeOK",))))
    with pytest.raises(ValueError, match="certified for model"):
        port_engine("v3", to_port(forged_dup_table()),
                    dims=RaftDims(n_servers=3, n_values=2, max_log=4,
                                  n_msg_slots=16))
    # por=True certifies in process (analysis/por.py): nothing on the
    # Raft alphabet, and the table passes the same admission.
    eng = port_engine("v3", por=True)
    assert eng._por_table is not None and eng._por_table.certified == 0


def test_chunk_body_rejects_malformed_por_arrays():
    G = DIMS.n_instances

    def build(mask, pri):
        return build_chunk_body(dims=DIMS, v2=None, inv_fns=None,
                                constraint=None, B=8, K=256,
                                record_trace=False, device="cpu",
                                por_mask=mask, por_priority=pri)

    with pytest.raises(ValueError, match="instance grid"):
        build(torch.zeros(G - 1, dtype=torch.bool),
              torch.zeros(G - 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="bool/int32"):
        build(torch.zeros(G, dtype=torch.int32),
              torch.zeros(G, dtype=torch.int32))
    with pytest.raises(ValueError, match="given together"):
        build(torch.zeros(G, dtype=torch.bool), None)


# ---------------------------------------------------------------------------
# Masked runs against the JAX engine


def jax_run(dims, bounds, table, depth, **kw):
    eng = JEngine(dims, invariants={"TypeOK": j_type_ok(dims)},
                  constraint=j_constraint(dims, bounds),
                  config=JConfig(batch=32, queue_capacity=1 << 12,
                                 seen_capacity=1 << 15, check_deadlock=False,
                                 max_diameter=depth, record_trace=True,
                                 statespace_report=False, por_table=table,
                                 **kw))
    res = eng.run([j_init_state(dims)])
    fps = set(int(x) for x in eng.trace.export()[0]) | set(eng.trace.roots)
    return res, fps


@pytest.fixture(scope="module")
def jax_small():
    """tests/test_por.py's model to L3 on the JAX engine: full, and
    reduced by the forged table."""
    return (jax_run(J_DIMS, J_BOUNDS, None, 3),
            jax_run(J_DIMS, J_BOUNDS, forged_dup_table(), 3))


def port_fps(eng):
    return set(int(x) for x in eng.trace.export()[0]) | set(eng.trace.roots)


@pytest.mark.parametrize("pipeline", ["v3", "v4"])
def test_forged_table_run_equals_jax(jax_small, pipeline):
    (jfull, jfull_fps), (jred, jred_fps) = jax_small
    eng = port_engine(pipeline, to_port(forged_dup_table()))
    red = eng.run([init_state(DIMS)])
    assert red.por_instances == jred.por_instances == DIMS.n_msg_slots
    assert (red.distinct, red.generated, red.levels, red.diameter) == \
        (jred.distinct, jred.generated, jred.levels, jred.diameter)
    assert red.action_counts == jred.action_counts
    assert red.action_pruned == {n: v["pruned"]
                                 for n, v in jred.coverage.items()}
    assert sum(red.action_pruned.values()) > 0
    assert red.action_pruned["DuplicateMessage"] == 0
    assert red.distinct < jfull.distinct and red.generated < jfull.generated
    # Reduced is a subset of full, by trace fingerprints, and the same
    # set of states as the JAX engine's reduced run.
    assert port_fps(eng) == jred_fps
    assert port_fps(eng) <= jfull_fps


@pytest.mark.parametrize("pipeline", ["v3", "v4"])
def test_uncertified_table_gives_the_unreduced_run(jax_small, pipeline):
    (jfull, jfull_fps), _ = jax_small
    table = to_port(empty_table())
    assert por_device_arrays(table, "cpu") == (None, None)
    eng = port_engine(pipeline, table)
    res = eng.run([init_state(DIMS)])
    off = port_engine(pipeline).run([init_state(DIMS)])
    assert res.por_instances == 0
    assert (res.distinct, res.generated, res.levels, res.action_counts) == \
        (off.distinct, off.generated, off.levels, off.action_counts) == \
        (jfull.distinct, jfull.generated, jfull.levels, jfull.action_counts)
    assert sum(res.action_pruned.values()) == 0
    assert port_fps(eng) == jfull_fps


def test_forged_table_on_mcraft_bounded_v3_v4_and_jax(tmp_path):
    """The forged table of tests/test_torch_front.py (MCraft_bounded's own
    dims, 32 message slots) through the artifact file and the cfg
    directive, on both plans and every tail."""
    jsetup = j_load_config(BOUNDED)
    path = str(tmp_path / "por.json")
    forged_dup_table(jsetup.dims).save(path)
    jred, jfps = jax_run(jsetup.dims, jsetup.bounds, path, 4)
    cfg = tmp_path / "por.cfg"
    cfg.write_text(open(BOUNDED).read() + f"\n\\* TPU: POR_TABLE = {path}\n")
    setup = load_config(str(cfg))
    base = engine_config_from_backend(setup)
    assert base.por_table == path
    seen = set()
    for pipeline, method in (("v3", "fused"), ("v4", "fused"),
                             ("v3", "kernel"), ("v4", "window")):
        eng = make_engine(setup, dataclasses.replace(
            base, batch=64, queue_capacity=1 << 13, seen_capacity=1 << 14,
            check_deadlock=False, max_diameter=4, pipeline=pipeline,
            enqueue_method=method), device="cpu")
        res = eng.run([init_state(setup.dims)])
        assert res.por_instances == jred.por_instances == 32
        assert (res.distinct, res.generated, res.levels) == \
            (jred.distinct, jred.generated, jred.levels)
        assert res.action_pruned == {n: v["pruned"]
                                     for n, v in jred.coverage.items()}
        assert port_fps(eng) == jfps
        seen.add((res.distinct, res.generated,
                  tuple(sorted(res.action_pruned.items()))))
    assert len(seen) == 1 and jred.distinct < 527


def test_cli_por_table(tmp_path, capsys):
    path = str(tmp_path / "por.json")
    to_port(forged_dup_table(j_load_config(BOUNDED).dims)).save(path)
    args = ["check", BOUNDED, "--device", "cpu", "--max-diameter", "4",
            "--no-trace"]
    assert cli.main(args) == 0
    full = capsys.readouterr().out
    assert "distinct states    527" in full and "POR" not in full
    assert cli.main(args + ["--por-table", path, "--pipeline", "v4"]) == 0
    out = capsys.readouterr().out
    assert "POR                32 certified instances" in out
    assert "distinct states    527" not in out
