"""The chunk step's two launches (``ops/step_glue_cuda.py``) against their
plain versions (``engine/chunk.py`` ``ChunkStep.cond``, ``window``,
``update`` and the ``finish`` stage).

On the CPU: the step runs the plain versions and launches nothing, the
wrappers raise on any device but the card, and the launches take the
step's own cond words and family table.

On the card (marker ``cuda``; each test skips without one): the begin
launch against ``cond`` + ``window`` at every alignment of the batch's
first row, the queue's end and each word of the cond; the end launch
against ``finish`` + ``update`` on built batches (the cond false, a
progress limit, two violating lanes, a violation already recorded,
deadlocked rows, overflow and a probe failure, POR-pruned lanes, the
reconfiguration variant's and TPUraft's shapes), all bit for bit; each
step of a v4 run with the trace on against the plain step (the state,
the next queue, the trace buffer, the seen set); whole runs with the
launches against runs with the plain versions on the card
(the trace on, v3, v1, a POR table, a deadlock, the variant, TPUraft),
and MCraft_bounded to L7 on v4 against the CPU, its launches counted.
This file imports no JAX: the card's machine has none, so run it there
without the suite's conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_step_glue.py
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from raft_tla_tpu_torch.engine import chunk as chunk_mod
from raft_tla_tpu_torch.engine.bfs import KERNEL_MODULES, EngineConfig
from raft_tla_tpu_torch.engine.check import initial_states, make_engine
from raft_tla_tpu_torch.engine.chunk import (ST_COUNT, ST_DEAD, ST_OFFSET,
                                             ST_OVF, ST_STEPS, ST_TCOUNT,
                                             ST_VIOL, ChunkState, ChunkStep)
from raft_tla_tpu_torch.models.schema import state_width
from raft_tla_tpu_torch.obs.profile import kernel_modules
from raft_tla_tpu_torch.ops import fpset, step_glue_cuda
from raft_tla_tpu_torch.ops.chunk_front import FrontOut
from raft_tla_tpu_torch.utils.cfg import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = {"mcraft": ("MCraft_bounded.cfg", 2048, 32768),
        "tpuraft": ("TPUraft.cfg", 8192, 131072),
        "reconfig": ("reconfig3.cfg", 2048, 32768)}


def cfg_path(name):
    return os.path.join(REPO, "configs", CFGS[name][0])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the step's launches are CUDA "
                    "kernels, built with nvcc there")
    return torch.device("cuda")


def make_step(name, device, *, B=None, K=None, record_trace=False,
              check_deadlock=True, por=False):
    """A ``ChunkStep`` of the named cfg's dims (no front: the glue alone
    is under test), with its ``dims``."""
    _, B0, K0 = CFGS[name]
    dims = load_config(cfg_path(name)).dims
    B, K = B or B0, K or K0
    G = dims.n_instances
    kw = {}
    if por:
        rng = np.random.default_rng(7)
        kw = dict(por_mask=torch.as_tensor(rng.random(G) < 0.3,
                                           device=device),
                  por_priority=torch.as_tensor(
                      rng.permutation(G).astype(np.int32), device=device))
    Q = 4 * K
    step = ChunkStep(dims=dims, B=B, K=K, Q=Q, QTH=Q - K,
                     TQ=Q + K if record_trace else 0,
                     record_trace=record_trace,
                     check_deadlock=check_deadlock, device=device, v2=None,
                     inv_fns=None, constraint=None, **kw)
    return step, dims


def fresh_state(step, dims, device, gen):
    """A ``ChunkState`` whose counters hold small random values and whose
    cond holds (no violation, overflow, failure or deadlock yet)."""
    sw = state_width(dims)
    cs = chunk_mod.chunk_state(len(dims.family_sizes), sw, device)
    st = torch.randint(0, 50, cs.st.shape, generator=gen,
                       dtype=torch.int32)
    for w in (ST_VIOL, ST_OVF, chunk_mod.ST_FAIL, ST_DEAD, ST_TCOUNT,
              ST_STEPS, ST_OFFSET):
        st[w] = 0
    st[step.CUR], st[step.CUR + 1], st[step.CUR + 2] = 10**6, 10**6, 1
    cs.st.copy_(st)
    cs.vrow.copy_(torch.randint(0, 256, (sw,), generator=gen,
                                dtype=torch.uint8))
    cs.drow.copy_(torch.randint(0, 256, (sw,), generator=gen,
                                dtype=torch.uint8))
    cs.vfp.copy_(torch.randint(0, 2**32, (2,), generator=gen))
    return cs


def clone_state(cs):
    return ChunkState(*(t.clone() for t in cs))


def seen_set(device, size, capacity=1 << 12):
    seen = fpset.empty(capacity, device)
    seen.size.fill_(size)
    return seen


# --------------------------------------------------------------------------
# On the CPU


def test_step_on_cpu_takes_the_plain_versions():
    before = (step_glue_cuda.step_begin.launches,
              step_glue_cuda.step_end.launches)
    setup = load_config(cfg_path("mcraft"))
    engine = make_engine(setup, EngineConfig(
        batch=64, queue_capacity=1 << 12, seen_capacity=1 << 14,
        max_diameter=4, pipeline="v4", record_trace=True), device="cpu")
    res = engine.run(initial_states(setup))
    assert (res.distinct, res.generated, res.levels) == (
        527, 1191, [1, 3, 18, 79, 318])
    assert (step_glue_cuda.step_begin.launches,
            step_glue_cuda.step_end.launches) == before
    assert step_glue_cuda.step_begin in KERNEL_MODULES
    assert step_glue_cuda.step_end in KERNEL_MODULES
    assert kernel_modules() == KERNEL_MODULES


@pytest.mark.parametrize("engine_cls", ["single", "mesh"])
def test_steps_make_their_glue_only_when_asked(engine_cls):
    """A step makes its launches' shared state (``ChunkStep.glue``) at
    its first use on the card, so the CPU step and the mesh's steps,
    which run the plain parts one by one, never make it."""
    setup = load_config(cfg_path("mcraft"))
    engine = make_engine(setup, EngineConfig(
        batch=64, queue_capacity=1 << 12, seen_capacity=1 << 14,
        max_diameter=3, pipeline="v4", record_trace=False), device="cpu",
        engine_cls=engine_cls, devices=["cpu"] * 2)
    res = engine.run(initial_states(setup))
    assert res.levels == [1, 3, 18, 79]
    steps = engine._steps if engine_cls == "mesh" else [engine._step]
    assert steps and all("glue" not in vars(s) for s in steps)
    glue = steps[0].glue
    assert (glue.B, glue.scratch) == (64, None)
    assert "glue" in vars(steps[0])


@pytest.mark.parametrize("fails", [False, True])
def test_a_capture_gives_back_the_launches_it_recorded(monkeypatch, fails):
    """The launches a capture records run at each replay, and never when
    the capture fails (out of device memory mid-step, before the end
    launch): either way the capture leaves the wrappers' counts as it
    found them, so a run counts one begin launch a step and a burst."""
    from raft_tla_tpu_torch.engine import bfs
    setup = load_config(cfg_path("mcraft"))
    engine = make_engine(setup, EngineConfig(
        batch=64, queue_capacity=1 << 12, seen_capacity=1 << 14,
        max_diameter=1, pipeline="v4", record_trace=False), device="cpu")
    engine._warm, engine._pool = True, object()
    graph = object()

    def capture(fn, device, pool):
        step_glue_cuda.step_begin.launches += 1
        if fails:
            raise torch.cuda.OutOfMemoryError("out of memory mid-step")
        step_glue_cuda.step_end.launches += 1
        return graph

    monkeypatch.setattr(bfs, "capture_graph", capture)
    before = [m.launches for m in KERNEL_MODULES]
    if fails:
        with pytest.raises(torch.cuda.OutOfMemoryError):
            engine._capture(lambda: None, None)
    else:
        assert engine._capture(lambda: None, None) == (graph, [
            (step_glue_cuda.step_begin, 1), (step_glue_cuda.step_end, 1)])
    assert [m.launches for m in KERNEL_MODULES] == before


@pytest.mark.parametrize("wrapper", ["step_begin", "step_cond", "step_end"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_glue_wrappers_raise_off_the_card(wrapper, device):
    """Given a batch as the CPU step makes it, each wrapper raises for
    its device before it launches anything."""
    step, dims = make_step("mcraft", "cpu", B=8, K=256)
    glue = step.glue
    assert glue.scratch is None                 # made on the card only
    gen = torch.Generator().manual_seed(3)
    cs = ChunkState(*(t.to(device) for t in fresh_state(step, dims, "cpu",
                                                         gen)))
    fo, new, fail, count, valid, rows = built_batch(step, dims, device, gen)
    seen = seen_set(device, 5)
    a = torch.ones(1, dtype=torch.bool, device=device)
    calls = {
        "step_begin": lambda: step_glue_cuda.step_begin(glue, rows, seen,
                                                        cs.st),
        "step_cond": lambda: step_glue_cuda.step_cond(glue, seen, cs.st),
        "step_end": lambda: step_glue_cuda.step_end(
            glue, a, rows, valid, fo, new, fail, count, seen, cs)}
    before = (step_glue_cuda.step_begin.launches,
              step_glue_cuda.step_end.launches)
    with pytest.raises(ValueError, match="unsupported device"):
        calls[wrapper]()
    assert (step_glue_cuda.step_begin.launches,
            step_glue_cuda.step_end.launches) == before


@pytest.mark.parametrize("holds", [True, False])
def test_more_writes_the_cond_on_cpu(holds):
    step, dims = make_step("mcraft", "cpu", B=8, K=256)
    cs = fresh_state(step, dims, "cpu", torch.Generator().manual_seed(1))
    if not holds:
        cs.st[ST_OVF] = 1
    seen = seen_set("cpu", 3)
    cs.st[step.CUR + 2] = 7
    step.more(seen, cs)
    assert int(cs.st[step.CUR + 2]) == int(holds)
    assert bool(step.cond(seen, cs)) == holds


@pytest.mark.parametrize("record_trace,check_deadlock,por", [
    (False, True, False), (True, True, False), (False, False, True),
    (True, False, False)])
def test_glue_takes_the_steps_cond_words_and_families(record_trace,
                                                      check_deadlock, por):
    step, dims = make_step("reconfig", "cpu", B=8, K=256,
                           record_trace=record_trace,
                           check_deadlock=check_deadlock, por=por)
    glue = step.glue
    assert list(glue.words) == step._idx.tolist()
    assert list(glue.lims)[2:] == step._lim.tolist()
    assert (glue.cur, glue.count_word) == (step.CUR, step.count_word)
    assert (ST_DEAD in list(glue.words)) == check_deadlock
    assert (ST_TCOUNT in list(glue.words)) == record_trace
    assert glue.por == por
    assert (glue.G, glue.F, glue.sw) == (dims.n_instances,
                                         len(dims.family_sizes),
                                         state_width(dims))
    fam = glue.family_of.tolist()
    for f, (off, sz) in enumerate(zip(dims.family_offsets,
                                      dims.family_sizes)):
        assert fam[off:off + sz] == [f] * sz


# --------------------------------------------------------------------------
# Built batches (the end launch's inputs as the front and the tail give
# them)


def built_batch(step, dims, device, gen, *, P=None, n_viol=2, dead_rows=(),
                ovf_p=0.002, fail=False, n_valid=None):
    """``(fo, new, fail, count, valid, rows)`` of a batch: the front's
    outputs (en, ovf clear from row P on; lane ids of the enabled lanes
    of rows below P in flat order, spread ids past them), the tail's
    novel flags, fail and count, the window's valid flags and rows."""
    glue = step.glue
    B, G, K, sw = glue.B, glue.G, glue.K, glue.sw
    P = B if P is None else P
    n_valid = B if n_valid is None else n_valid

    def rand(shape, p):
        return torch.rand(shape, generator=gen) < p

    valid = torch.arange(B) < n_valid
    en = rand((B, G), 0.6 * K / (B * G)) & valid[:, None]
    ovf = rand((B, G), ovf_p) & valid[:, None]
    for b in dead_rows:
        en[b] = False
        ovf[b] = False
    en[P:] = False
    ovf[P:] = False
    pruned = rand((B, G), 0.05)
    flat = en.reshape(-1).nonzero().squeeze(1)
    total = min(flat.shape[0], K)
    lane_id = torch.randint(0, B * G, (K,), generator=gen,
                            dtype=torch.int32)
    lane_id[:total] = flat[:total].to(torch.int32)
    live = torch.arange(K) < total
    new = rand(K, 0.5) & live
    inv = torch.where(rand(K, 0.3), torch.randint(-50, 50, (K,),
                                                  generator=gen),
                      torch.full((K,), -1))
    inv[new] = -1
    lanes = new.nonzero().squeeze(1)
    if n_viol and lanes.numel() >= 4:
        pick = lanes[torch.randperm(lanes.numel(), generator=gen)[:n_viol]]
        inv[pick] = torch.randint(0, 3, (n_viol,), generator=gen)
    kh = torch.randint(0, 2**32, (K,), generator=gen)
    kl = torch.randint(0, 2**32, (K,), generator=gen)
    krows = torch.randint(0, 256, (K, sw), generator=gen, dtype=torch.uint8)
    rows = torch.randint(0, 256, (B, sw), generator=gen, dtype=torch.uint8)
    pt = torch.tensor([P, total], dtype=torch.int32)
    fo = FrontOut(en=en, ovf=ovf, pruned=pruned, P=pt[0], total=pt[1],
                  lane_id=lane_id, kvalid=live, kh=kh, kl=kl, krows=krows,
                  cons_ok=torch.ones(K, dtype=torch.bool), inv=inv,
                  parent_hi=None, parent_lo=None)
    dev = torch.device(device)
    fo = FrontOut(*(None if t is None else t.to(dev) for t in fo))
    count = torch.tensor([12345], dtype=torch.int32, device=dev)[0]
    return (fo, new.to(dev), torch.tensor(fail, device=dev), count,
            valid.to(dev), rows.to(dev))


def end_both(step, dims, device, gen, *, a=True, st_words=None, **kw):
    """The end launch and ``finish`` + ``update`` on the same batch and
    state: ``(kernel's ChunkState, plain's, the scratch after)``."""
    cs = fresh_state(step, dims, device, gen)
    for w, v in (st_words or {}).items():
        cs.st[w] = v
    fo, new, fail, count, valid, rows = built_batch(step, dims, device, gen,
                                                    **kw)
    at = torch.tensor([a], device=device)
    valid = valid & at
    seen = seen_set(device, 987654)
    plain = clone_state(cs)
    out = step.body.stages.finish(valid, fo, new, fail, count)
    step.update(out, rows, at, seen, None, plain)
    got = clone_state(cs)
    step_glue_cuda.step_end(step.glue, at, rows, valid, fo, new, fail,
                            count, seen, got)
    torch.cuda.synchronize()
    return got, plain, step.glue.scratch.clone()


def assert_state_equal(got, want):
    for name, g, w in zip(ChunkState._fields, got, want):
        assert torch.equal(g, w), (name, g, w)


END_CASES = {
    "a_false": ("mcraft", dict(a=False)),
    "progress_limited": ("mcraft", dict(P=700)),
    "two_violations": ("mcraft", dict(n_viol=2)),
    "violation_already_recorded": ("mcraft",
                                   dict(st_words={ST_VIOL: 1})),
    "deadlocked_rows": ("mcraft", dict(dead_rows=(5, 900, 901), P=1500,
                                       n_valid=1400)),
    "dead_already_recorded": ("mcraft", dict(dead_rows=(3,),
                                             st_words={ST_DEAD: 2})),
    "overflow_and_fail": ("mcraft", dict(ovf_p=0.02, fail=True)),
    "por_pruned": ("mcraft", dict(P=1234)),
    "reconfig": ("reconfig", dict(P=1800, dead_rows=(7,))),
    "tpuraft": ("tpuraft", dict(P=6000, dead_rows=(17, 4000))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(END_CASES))
def test_end_launch_equals_finish_and_update(card, case):
    name, kw = END_CASES[case]
    step, dims = make_step(name, card, por=case == "por_pruned")
    empty = step.glue.scratch.clone()
    gen = torch.Generator().manual_seed(sorted(END_CASES).index(case))
    for _ in range(3):                       # and the scratch reset between
        got, want, scratch = end_both(step, dims, card, gen, **kw)
        assert_state_equal(got, want)
        assert torch.equal(scratch, empty)
    st = want.st.cpu()
    if case == "two_violations":
        assert int(st[ST_VIOL]) == 1
    if case == "deadlocked_rows":
        assert int(st[ST_DEAD]) == 1
    if case == "a_false":
        assert int(st[ST_STEPS]) == 0


# --------------------------------------------------------------------------
# The begin launch


def begin_both(step, dims, device, qcur, seen, cs):
    a = step.cond(seen, cs)
    rows, valid = step.window(qcur, cs, a)
    ga, grows, gvalid = step_glue_cuda.step_begin(step.glue, qcur, seen,
                                                  cs.st)
    torch.cuda.synchronize()
    assert torch.equal(ga, a)
    assert torch.equal(grows, rows)
    assert torch.equal(gvalid, valid)
    more = clone_state(cs)
    step_glue_cuda.step_cond(step.glue, seen, more.st)
    want = cs.st.clone()
    want[step.CUR + 2] = int(a)
    assert torch.equal(more.st, want)
    return bool(a)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CFGS))
def test_begin_launch_equals_cond_and_window(card, name):
    step, dims = make_step(name, card, record_trace=True)
    B, K, sw = step.glue.B, step.glue.K, step.glue.sw
    gen = torch.Generator().manual_seed(11)
    n_rows = 3 * B + 5
    qcur = torch.randint(0, 256, (n_rows, sw), generator=gen,
                         dtype=torch.uint8).to(card)
    seen = seen_set(card, 100, capacity=1 << 12)
    base = fresh_state(step, dims, card, gen)
    base.st[step.CUR] = 2 * B + 3
    # Every alignment of the batch's first row (sw is odd), the level's
    # end inside the batch, rows past the queue's end (clamped).
    for off in list(range(17)) + [B + 9, 2 * B - 1, n_rows - B + 3,
                                  n_rows - 2]:
        cs = clone_state(base)
        cs.st[ST_OFFSET] = off
        cs.st[step.CUR] = max(off + 1, 2 * B + 3)
        assert begin_both(step, dims, card, qcur, seen, cs)
    # Each word of the cond at its limit and one past it.
    Q, TQ = step.Q, step.TQ
    limits = [(ST_OFFSET, int(base.st[step.CUR]) - 1),
              (ST_STEPS, int(base.st[step.CUR + 1]) - 1),
              (ST_COUNT, Q - K), (ST_VIOL, 0), (ST_OVF, 0),
              (chunk_mod.ST_FAIL, 0), (ST_DEAD, 0), (ST_TCOUNT, TQ - K)]
    for word, lim in limits:
        for v, holds in ((lim, True), (lim + 1, False)):
            cs = clone_state(base)
            cs.st[word] = v
            assert begin_both(step, dims, card, qcur, seen, cs) == holds
    for size, holds in ((seen.capacity // 2, True),
                        (seen.capacity // 2 + 1, False)):
        assert begin_both(step, dims, card, qcur, seen_set(card, size),
                          clone_state(base)) == holds


# --------------------------------------------------------------------------
# Whole runs


def plain_glue(engine):
    """Have ``engine`` run its steps with the plain versions on the card
    (each step dispatched itself, no graph)."""
    step = engine._step

    def plain(qcur, seen, qnext, tbuf, cs):
        a = step.cond(seen, cs)
        rows, valid = step.window(qcur, cs, a)
        out = step.body(rows, valid, seen, qnext,
                        cs.st.narrow(0, ST_COUNT, 1), step.Q, None,
                        cs.st.narrow(0, step.BUILT, 2))
        step.update(out, rows, a, seen, tbuf, cs)

    def more(seen, cs):
        cs.st.narrow(0, step.CUR + 2, 1).copy_(step.cond(seen, cs))

    engine._runner = lambda qcur, qnext, seen, res: (
        lambda: plain(qcur, seen, qnext, engine._tbuf, engine._cs))
    step.more = more


def summary(engine, res):
    v = res.violation
    trace = None
    if engine.config.record_trace:
        fps, par, act = engine.trace.export()
        trace = sorted(zip(fps.tolist(), par.tolist(), act.tolist()))
    return (res.distinct, res.generated, res.levels, res.action_counts,
            res.action_pruned, res.stop_reason, res.batches,
            v and (v.invariant, v.fingerprint, repr(v.state)),
            res.deadlock and repr(res.deadlock), trace)


def forged_por_table(dims):
    from raft_tla_tpu_torch.analysis.por import PorTable
    G = dims.n_instances
    mask = np.zeros(G, bool)
    off = dims.family_offsets[dims.family_names.index("DuplicateMessage")]
    mask[off:off + dims.n_msg_slots] = True
    return PorTable(model=repr(dims), n_instances=G, ample_mask=mask,
                    priority=np.arange(G, dtype=np.int32),
                    predicates=("TypeOK", "CONSTRAINT"))


@contextlib.contextmanager
def deadlocking():
    """The v2 masks with one more guard: nothing is enabled once a term
    reached 3, so the run deadlocks (Raft's Restart is always enabled)."""
    from raft_tla_tpu_torch.engine import bfs as tbfs
    build = tbfs.build_v2

    def build_v2(dims, device):
        v2 = build(dims, device)

        def guarded(st, masks=v2.masks):
            en, ovf = masks(st)
            live = (st.term.max(1).values < 3)[:, None]
            return en & live, ovf & live

        return v2._replace(masks=guarded)

    tbfs.build_v2 = build_v2
    try:
        yield
    finally:
        tbfs.build_v2 = build


RUNS = {
    "v4_trace_violation": ("MCraft_noleader.cfg", dict(
        pipeline="v4", record_trace=True, max_diameter=10)),
    "v3_split_tail": ("MCraft_bounded.cfg", dict(
        pipeline="v3", enqueue_method="kernel", max_diameter=8)),
    "v1": ("MCraft_bounded.cfg", dict(pipeline="v1", max_diameter=6)),
    "v4_por_table": ("MCraft_bounded.cfg", dict(pipeline="v4",
                                                max_diameter=8)),
    "v3_deadlock": ("MCraft_bounded.cfg", dict(pipeline="v3",
                                               max_diameter=12)),
    "reconfig_v4": ("reconfig3.cfg", dict(pipeline="v4", max_diameter=4)),
    "tpuraft_v4": ("TPUraft.cfg", dict(
        pipeline="v4", batch=512, queue_capacity=1 << 16,
        seen_capacity=1 << 18, max_diameter=5)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RUNS))
def test_runs_with_the_launches_equal_runs_with_the_plain_versions(card,
                                                                   case):
    cfg, kw = RUNS[case]
    setup = load_config(os.path.join(REPO, "configs", cfg))
    base = dict(batch=2048, queue_capacity=1 << 18, seen_capacity=1 << 20,
                record_trace=False)
    base.update(kw)
    if case == "v4_por_table":
        base["por_table"] = forged_por_table(setup.dims)
    out = []
    for plain in (False, True):
        with deadlocking() if case == "v3_deadlock" else \
                contextlib.nullcontext():
            engine = make_engine(setup, EngineConfig(**base), device=card)
        if plain:
            plain_glue(engine)
        res = engine.run(initial_states(setup))
        out.append(summary(engine, res))
    assert out[0] == out[1]
    if case == "v4_trace_violation":
        assert out[0][7] is not None
    if case == "v3_deadlock":
        assert out[0][8] is not None
    if case == "v4_por_table":
        assert sum(out[0][4].values()) > 0


@pytest.mark.cuda
def test_each_step_equals_the_plain_step(card):
    """Every step of a v4 run with the trace on, against the plain step on
    copies of everything it writes: the state, the next queue (all its
    rows) and the trace buffer bit for bit, the seen set's keys as a set
    (where the insert's concurrent claims put a key is not part of its
    contract)."""
    setup = load_config(cfg_path("mcraft"))
    engine = make_engine(setup, EngineConfig(
        batch=2048, queue_capacity=1 << 16, seen_capacity=1 << 20,
        max_diameter=7, pipeline="v4", record_trace=True), device=card)
    step = engine._step
    equal = []

    def runner(qcur, qnext, seen, res):
        def run():
            cs, tbuf = engine._cs, engine._tbuf
            copies = [t.clone() for t in (*cs, qnext, tbuf, seen.keys,
                                          seen.size)]
            pcs, (pq, ptb) = ChunkState(*copies[:4]), copies[4:6]
            pseen = seen._replace(keys=copies[6], size=copies[7])
            a = step.cond(pseen, pcs)
            rows, valid = step.window(qcur, pcs, a)
            out = step.body(rows, valid, pseen, pq,
                            pcs.st.narrow(0, ST_COUNT, 1), step.Q, None,
                            pcs.st.narrow(0, step.BUILT, 2))
            step.update(out, rows, a, pseen, ptb, pcs)
            step(qcur, seen, qnext, tbuf, cs)
            got = (*cs, qnext, tbuf, seen.keys.sort().values, seen.size)
            want = copies[:6] + [pseen.keys.sort().values, copies[7]]
            equal.append([n for n, g, w in zip(
                ChunkState._fields + ("qnext", "tbuf", "keys", "size"),
                got, want) if not torch.equal(g, w)])
        return run

    engine._runner = runner
    res = engine.run(initial_states(setup))
    assert res.levels == [1, 3, 18, 79, 318, 1218, 4433, 15510]
    assert len(equal) == res.steps and not any(equal), equal


@pytest.mark.cuda
def test_v4_to_l7_on_the_card_equals_the_cpu_and_counts_its_launches(card):
    setup = load_config(cfg_path("mcraft"))
    config = EngineConfig(batch=2048, queue_capacity=1 << 18,
                          seen_capacity=1 << 20, max_diameter=7,
                          pipeline="v4", record_trace=False)
    engine = make_engine(setup, config, device=card)
    bursts = []
    dispatch = engine._dispatch

    def counted(run, n, seen):
        bursts.append(n)
        return dispatch(run, n, seen)

    engine._dispatch = counted
    before = (step_glue_cuda.step_begin.launches,
              step_glue_cuda.step_end.launches)
    res = engine.run(initial_states(setup))
    begin = step_glue_cuda.step_begin.launches - before[0]
    end = step_glue_cuda.step_end.launches - before[1]
    assert res.levels == [1, 3, 18, 79, 318, 1218, 4433, 15510]
    assert (res.distinct, res.generated) == (37054, 99489)
    assert end == res.steps
    assert begin == res.steps + len(bursts)
    cpu = make_engine(setup, config, device="cpu").run(
        initial_states(setup))
    assert (cpu.distinct, cpu.generated, cpu.levels, cpu.action_counts) == (
        res.distinct, res.generated, res.levels, res.action_counts)
