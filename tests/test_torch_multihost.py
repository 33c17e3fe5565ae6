"""The port's multi-controller mesh (``raft_tla_tpu_torch/parallel/
multihost.py``) on the CPU: pairs of processes, two CPU shards each, one
global mesh of four shards over a gloo process group.

The scenarios of ``tests/test_multihost.py`` on ``tests/mh_bfs_worker.py``'s
and ``tests/mh_sim_worker.py``'s dims and bounds: both controllers
exhaust the 2-server model to the oracle's 4,779 / 25 / 12,584 with the
levels and family counts of the port's one-process mesh at n = 4; the
traced NoLeader hunt gives both controllers the same replayed trace, and
(no spill at these sizes) the violation of the one-process mesh and of
the JAX ``MeshBFSEngine`` at n = 4, with two trace pieces of one run id
and a new id for a second run into the same directory; a piece group
written at ``max_diameter`` 12 resumes on two controllers and on the
port's single engine to the pins; a queue budget stops both controllers
at the same chunk; the two-process ``MeshSimulator`` equals the
one-process one at n = 4, walk for walk; the CLI's launch contract
(``--engine single`` and a traced ``check`` refused with the JAX texts,
``check --no-trace`` printing the same counts on both controllers) and
the TRACE_DIR directive.  Also the agreement primitives and the group
exchange against the one-process exchange.

The worker is this file run as a script (``--worker``, the scenario in
``MH_SCENARIO``); it imports nothing of JAX.  Every pair runs under
``communicate(timeout=...)``, so a collective that hangs fails one test.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from raft_tla_tpu_torch.engine import checkpoint as ckpt_mod  # noqa: E402
from raft_tla_tpu_torch.engine.bfs import (BFSEngine,  # noqa: E402
                                           EngineConfig)
from raft_tla_tpu_torch.engine.check import (  # noqa: E402
    UNPORTED_DIRECTIVES, engine_config_from_backend, make_engine)
from raft_tla_tpu_torch.models.dims import LEADER, RaftDims  # noqa: E402
from raft_tla_tpu_torch.models.invariants import (  # noqa: E402
    Bounds, build_constraint, build_type_ok)
from raft_tla_tpu_torch.models.pystate import init_state  # noqa: E402
from raft_tla_tpu_torch.models.schema import (  # noqa: E402
    encode_state, flatten_state, stack_states)
from raft_tla_tpu_torch.parallel import multihost as mh  # noqa: E402
from raft_tla_tpu_torch.parallel.mesh import MeshBFSEngine  # noqa: E402
from raft_tla_tpu_torch.parallel.simulate import MeshSimulator  # noqa: E402
from raft_tla_tpu_torch.utils.cfg import load_config  # noqa: E402

BOUNDED = os.path.join(REPO, "configs/MCraft_bounded.cfg")

# tests/mh_bfs_worker.py.
DIMS = RaftDims(n_servers=2, n_values=1, max_log=2, n_msg_slots=8)
BOUNDS = Bounds(max_term=2, max_log_len=1, max_msg_count=1, max_in_flight=1)
PIN = (4779, 25, 12584)
LOCAL = 2                   # CPU shards a process
PAIR_TIMEOUT = 240          # seconds a pair may take
# Queue rows of the traced hunt: enough that no shard spills before the
# violation, so every placement equals the one-process mesh's.
NO_SPILL_QUEUE = 1 << 14

# tests/mh_sim_worker.py.
SIM_DIMS = RaftDims(n_servers=3, n_values=2, max_log=4, n_msg_slots=24)
SIM_BOUNDS = Bounds(max_term=2, max_log_len=1, max_msg_count=1)


def state_hex(state, dims=DIMS) -> str:
    """A state's packed row, as hex: equal states, equal strings."""
    row = flatten_state(stack_states([encode_state(state, dims)], "cpu"),
                        dims)
    return bytes(row[0].numpy()).hex()


def no_leader(st):
    return (st.role != LEADER).all(1)


def bfs_engine(devices, env) -> MeshBFSEngine:
    """``tests/mh_bfs_worker.py``'s engine, its options from ``env``."""
    trace = bool(env.get("MH_TRACE"))
    invariants = {"TypeOK": build_type_ok(DIMS)}
    if trace:
        invariants["NoLeader"] = no_leader
    budget = env.get("MH_QUEUE_BUDGET")
    return MeshBFSEngine(
        DIMS, invariants=invariants,
        constraint=build_constraint(DIMS, BOUNDS),
        config=EngineConfig(
            batch=32, queue_capacity=int(env.get("MH_QUEUE", 1 << 10)),
            seen_capacity=1 << 14, check_deadlock=False,
            record_trace=trace, sync_every=4, statespace_report=False,
            checkpoint_dir=env.get("MH_CKPT_DIR"),
            trace_dir=env.get("MH_TRACE_DIR"),
            max_diameter=(int(env["MH_MAX_DIAMETER"])
                          if env.get("MH_MAX_DIAMETER") else None),
            exit_conditions=((("queue", float(budget)),) if budget
                             else ())),
        devices=devices)


def bfs_summary(eng, res) -> dict:
    out = {"distinct": res.distinct, "generated": res.generated,
           "diameter": res.diameter, "levels": res.levels,
           "stop_reason": res.stop_reason, "chunks": res.chunks,
           "steps": res.steps, "spills": res.spills,
           "actions": res.action_counts, "n": eng.n_dev,
           "violation": None}
    if res.violation is not None:
        steps = eng.replay(res.violation.fingerprint)
        assert steps[-1][1] == res.violation.state
        out["violation"] = res.violation.invariant
        out["fp"] = res.violation.fingerprint
        out["state"] = state_hex(res.violation.state)
        out["trace"] = [[g, state_hex(s)] for g, s in steps]
    return out


def sim_root(dims=SIM_DIMS):
    """``tests/mh_sim_worker.py``'s root: a candidate one vote short."""
    return dataclasses.replace(
        init_state(dims), role=(1, 0, 0), current_term=(2, 2, 2),
        voted_for=(1, 1, 1), votes_responded=(0b001, 0, 0),
        votes_granted=(0b001, 0, 0),
        messages=frozenset({((1, 1, 0, 2, 1, ()), 1)}))


def sim_run(devices) -> dict:
    sim = MeshSimulator(
        SIM_DIMS, invariants={"NoLeader": no_leader},
        constraint=build_constraint(SIM_DIMS, SIM_BOUNDS),
        batch=16, depth=24, chunk=8, devices=devices)
    res = sim.run([sim_root()], num_steps=1 << 16, seed=7)
    return {"n": sim.n_dev, "steps": res.steps, "traces": res.traces,
            "chunks": res.chunks, "violation": res.violation_invariant,
            "trace": [[g, state_hex(s, SIM_DIMS)]
                      for g, s in res.violation_trace or []]}


# ---------------------------------------------------------------------------
# The worker (this file run as a script)


def worker() -> None:
    torch.set_num_threads(1)
    env = os.environ
    mh.initialize(timeout_seconds=PAIR_TIMEOUT - 30)
    out = {"process": mh.process_index(), "count": mh.process_count(),
           "transport": mh.transport()}
    devices = ["cpu"] * LOCAL
    if env["MH_SCENARIO"] == "sim":
        out.update(sim_run(devices))
    else:
        runs = int(env.get("MH_RUNS", "1"))
        for k in range(runs):
            eng = bfs_engine(devices, env)
            if env.get("MH_RESUME"):
                res = eng.run(resume=ckpt_mod.latest(env["MH_RESUME"]))
            else:
                res = eng.run([init_state(DIMS)])
            out.setdefault("runs", []).append(bfs_summary(eng, res))
            if eng.config.record_trace:
                out.setdefault("run_ids", []).append(eng._trace_run_id)
        out.update(out["runs"][0])
    print(json.dumps(out))


# ---------------------------------------------------------------------------
# Spawning pairs


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pair(argvs, extra_env=None, timeout=PAIR_TIMEOUT):
    """Two processes of one group (``argvs[i]`` for rank i, after the
    interpreter); ``[(returncode, stdout, stderr)]`` in rank order."""
    port = free_port()
    procs = []
    for rank, argv in enumerate(argvs):
        env = dict(os.environ, RAFT_COORDINATOR=f"127.0.0.1:{port}",
                   RAFT_NUM_PROCESSES="2", RAFT_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        env.update(extra_env or {})
        procs.append(subprocess.Popen(
            [sys.executable] + argv, env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        pytest.fail("a multi-process pair timed out (collective deadlock?)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def worker_pair(scenario, **env):
    """Both controllers' JSON results of one worker scenario."""
    outs = run_pair([[os.path.abspath(__file__), "--worker"]] * 2,
                    dict(env, MH_SCENARIO=scenario))
    res = []
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{err[-3000:]}"
        res.append(json.loads(out.strip().splitlines()[-1]))
    a, b = res
    assert (a["process"], b["process"], a["count"]) == (0, 1, 2)
    assert a["transport"] == b["transport"] == "gloo"
    return a, b


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KEYS = ("distinct", "generated", "diameter", "levels", "stop_reason",
        "actions", "violation")


def one_process(env=None) -> dict:
    eng = bfs_engine(["cpu"] * 2 * LOCAL, env or {})
    return bfs_summary(eng, eng.run([init_state(DIMS)]))


# ---------------------------------------------------------------------------
# The scenarios


def test_two_controllers_exhaust_to_the_pins():
    a, b = worker_pair("bfs")
    assert a["n"] == b["n"] == 2 * LOCAL
    for k in KEYS + ("chunks", "steps"):
        assert a[k] == b[k], (k, a, b)
    assert (a["distinct"], a["diameter"], a["generated"]) == PIN
    assert a["stop_reason"] == "exhausted" and a["violation"] is None
    one = one_process()
    for k in KEYS:
        assert a[k] == one[k], k


@pytest.fixture(scope="module")
def jax_mesh_violation():
    """The JAX ``MeshBFSEngine`` at n = 4 on the traced NoLeader hunt:
    (fingerprint, state row hex)."""
    if os.cpu_count() == 1:
        pytest.skip("the JAX mesh's virtual devices crash jaxlib's CPU "
                    "client on single-core hosts (tests/test_mesh.py:15-30)")
    import jax
    import jax.numpy as jnp
    from raft_tla_tpu.engine.bfs import EngineConfig as JConfig
    from raft_tla_tpu.models.dims import RaftDims as JDims
    from raft_tla_tpu.models.invariants import Bounds as JBounds
    from raft_tla_tpu.models.invariants import build_constraint as jcons
    from raft_tla_tpu.models.invariants import build_type_ok as jtype_ok
    from raft_tla_tpu.models.pystate import init_state as j_init
    from raft_tla_tpu.parallel.mesh import MeshBFSEngine as JMesh
    jd = JDims(**dataclasses.asdict(DIMS))
    j = JMesh(jd, invariants={"TypeOK": jtype_ok(jd),
                              "NoLeader": lambda st: jnp.all(st.role != 2)},
              constraint=jcons(jd, JBounds(**dataclasses.asdict(BOUNDS))),
              config=JConfig(batch=32, queue_capacity=NO_SPILL_QUEUE,
                             seen_capacity=1 << 14, check_deadlock=False,
                             sync_every=4, statespace_report=False),
              devices=jax.devices()[:2 * LOCAL])
    res = j.run([j_init(jd)])
    st = dataclasses.astuple(res.violation.state)
    from raft_tla_tpu_torch.models.pystate import PyState
    return res.violation.fingerprint, state_hex(PyState(*st))


def test_traced_violation_on_both_controllers(tmp_path, jax_mesh_violation):
    d = str(tmp_path / "tr")
    a, b = worker_pair("bfs", MH_TRACE="1", MH_TRACE_DIR=d, MH_RUNS="2",
                       MH_QUEUE=str(NO_SPILL_QUEUE))
    for k in KEYS + ("fp", "state", "trace"):
        assert a[k] == b[k], (k, a, b)
    assert a["violation"] == "NoLeader" and a["stop_reason"] == "violation"
    assert len(a["trace"]) >= 5 and a["spills"] == 0
    one = one_process({"MH_TRACE": "1", "MH_QUEUE": NO_SPILL_QUEUE})
    assert one["spills"] == 0
    for k in KEYS + ("fp", "state", "trace"):
        assert a[k] == one[k], k
    assert (a["fp"], a["state"]) == jax_mesh_violation
    # Two pieces a run, one agreed id each; the second run into the same
    # directory agreed a new one and replayed the same trace.
    assert a["run_ids"] == b["run_ids"] and len(set(a["run_ids"])) == 2
    assert a["runs"][1]["trace"] == a["trace"]
    names = sorted(os.listdir(d))
    assert names == sorted(f"trace_run_{i:08x}.p{p}of2.npz"
                           for i in a["run_ids"] for p in (0, 1))


def test_snapshot_pieces_resume_on_two_controllers_and_one(tmp_path):
    ck = str(tmp_path / "ck")
    a, b = worker_pair("bfs", MH_CKPT_DIR=ck, MH_MAX_DIAMETER="12")
    assert a["stop_reason"] == b["stop_reason"] == "diameter_budget"
    names = os.listdir(ck)
    assert "level_00012.p0of2.npz" in names
    assert "level_00012.p1of2.npz" in names
    assert "events.p0of2.jsonl" in names and "events.p1of2.jsonl" in names
    assert not any(n.startswith("level_") and ".p" not in n for n in names)
    assert ckpt_mod.latest(ck).endswith("level_00012.p0of2.npz")
    a2, b2 = worker_pair("bfs", MH_RESUME=ck)
    for k in KEYS:
        assert a2[k] == b2[k], (k, a2, b2)
    assert (a2["distinct"], a2["diameter"], a2["generated"]) == PIN
    single = BFSEngine(DIMS, invariants={"TypeOK": build_type_ok(DIMS)},
                       constraint=build_constraint(DIMS, BOUNDS),
                       config=EngineConfig(
                           batch=32, queue_capacity=1 << 10,
                           seen_capacity=1 << 14, check_deadlock=False,
                           record_trace=False, statespace_report=False),
                       device="cpu").run(resume=ckpt_mod.latest(ck))
    assert (single.distinct, single.diameter, single.generated) == PIN
    assert single.levels == a2["levels"]
    # Retention counts only intact groups: with level 12's group torn,
    # keep=1 keeps level 11's and deletes every older piece.
    os.remove(os.path.join(ck, "level_00012.p1of2.npz"))
    assert ckpt_mod.latest(ck).endswith("level_00011.p0of2.npz")
    ckpt_mod.gc(ck, 1)
    assert sorted(n for n in os.listdir(ck) if n.startswith("level_")) == [
        "level_00011.p0of2.npz", "level_00011.p1of2.npz",
        "level_00012.p0of2.npz"]


def test_queue_budget_stops_both_at_one_chunk():
    a, b = worker_pair("bfs", MH_QUEUE_BUDGET="150")
    for k in KEYS + ("chunks", "steps"):
        assert a[k] == b[k], (k, a, b)
    assert a["stop_reason"] == "queue_budget"
    assert a["distinct"] < PIN[0]


def test_mesh_simulator_pair_equals_one_process():
    a, b = worker_pair("sim")
    for k in ("n", "steps", "traces", "chunks", "violation", "trace"):
        assert a[k] == b[k], (k, a, b)
    one = sim_run(["cpu"] * 2 * LOCAL)
    for k in ("n", "steps", "traces", "chunks", "violation", "trace"):
        assert a[k] == one[k], k
    assert a["violation"] == "NoLeader" and len(a["trace"]) >= 3


# ---------------------------------------------------------------------------
# The CLI's launch contract and the TRACE_DIR directive


def test_cli_launch_contract_refusals():
    """Rank 0 asks for the single engine, rank 1 for a traced check: the
    JAX CLI's usage errors, after the group formed."""
    cli = ["-m", "raft_tla_tpu_torch", "check", BOUNDED, "--device", "cpu"]
    (rc0, _o0, e0), (rc1, _o1, e1) = run_pair(
        [cli + ["--engine", "single"], cli])
    assert rc0 == rc1 == 2
    assert ("multi-host mode (RAFT_COORDINATOR) requires --engine mesh "
            "or auto") in e0
    assert "multi-host check requires --no-trace" in e1


def test_cli_check_no_trace_on_two_controllers():
    cli = ["-m", "raft_tla_tpu_torch", "check", BOUNDED, "--device", "cpu",
           "--no-trace", "--max-diameter", "4", "--batch", "64",
           "--progress-interval", "0", "--no-report"]
    outs = run_pair([cli, cli])
    counts = []
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
        assert "mesh of 2 over 2 processes (gloo), process" in out
        counts.append([ln for ln in out.splitlines()
                       if ln.startswith(("distinct", "states generated",
                                         "levels", "stop reason"))])
    assert counts[0] == counts[1]
    assert "distinct states    527" in counts[0]


def test_trace_dir_directive_is_honoured(tmp_path):
    assert "TRACE_DIR" not in UNPORTED_DIRECTIVES
    d = str(tmp_path / "pieces")
    cfg = tmp_path / "c.cfg"
    cfg.write_text(open(BOUNDED).read() + f"\n\\* TPU: TRACE_DIR = {d}\n")
    setup = load_config(str(cfg))
    assert engine_config_from_backend(setup).trace_dir == d
    eng = make_engine(setup, device="cpu", engine_cls="mesh")
    assert eng.config.trace_dir == d


# ---------------------------------------------------------------------------
# The exchange and the primitives, in one process


def test_group_exchange_layout_equals_the_list_exchange():
    """``GroupExchange``'s reshapes around ``all_to_all_single``, with the
    collective replaced by its effect on m simulated processes, land each
    block where the one-process exchange puts it."""
    m, L, k = 2, 2, 3
    n = m * L
    gen = torch.Generator().manual_seed(5)
    blocks = [torch.randint(0, 1 << 40, (n, k), generator=gen)
              for _ in range(n)]
    nov = [torch.randint(0, 2, (n, k), generator=gen).bool()
           for _ in range(n)]
    from raft_tla_tpu_torch.parallel.mesh import ListExchange
    lst = ListExchange([torch.device("cpu")] * n)
    exes = []
    for _r in range(m):
        ex = mh.GroupExchange.__new__(mh.GroupExchange)
        ex.devices, ex.L, ex.n, ex.m = [torch.device("cpu")] * L, L, n, m
        ex.d0, ex._staged = torch.device("cpu"), False
        exes.append(ex)

    def a2a_all(xs):
        # all_to_all_single over m ranks: rank r's chunk q goes to q.
        return [torch.stack([xs[p][q] for p in range(m)]) for q in range(m)]

    for op, data, want in (("to_owners", blocks, lst.to_owners(blocks)),
                           ("to_sources", nov, lst.to_sources(nov))):
        sent = []
        for r, ex in enumerate(exes):
            ex._a2a = lambda x, _s=sent: (_s.append(x), x)[1]
            getattr(ex, op)(data[r * L:(r + 1) * L])
        got_in = a2a_all(sent)
        for r, ex in enumerate(exes):
            ex._a2a = lambda x, _y=got_in[r]: _y
            got = getattr(ex, op)(data[r * L:(r + 1) * L])
            for i in range(L):
                assert torch.equal(got[i], want[r * L + i])


# The agreement primitives in one process group of two, each result
# printed as one JSON line.
AGREEMENT_SCRIPT = (
    "import json, torch\n"
    "from raft_tla_tpu_torch.parallel import multihost as mh\n"
    "mh.initialize(timeout_seconds=60)\n"
    "r = mh.process_index()\n"
    "out = dict(any=mh.build_any()(r == 1), none=mh.build_any()(False),"
    " min=mh.build_min()(10 - r), sum=mh.build_sum()(1 << 31),"
    " budget=mh.build_budget_agree()(r == 0, 7 + r))\n"
    "g, a, b = mh.lowest_flagged([False, r == 1], [0, 1],"
    " [torch.tensor([r]), torch.tensor([10 + r])])\n"
    "out['lowest'] = [g, int(a), b.tolist()]\n"
    "out['none_flagged'] = mh.lowest_flagged([False], [0])[0]\n"
    "out['rows'] = mh.gather_rows(torch.tensor([[r, 2 * r]])).tolist()\n"
    "print(json.dumps(out))\n")

# Warnings c10d prints on a healthy loopback group (the store's server
# cannot name a client socket): not a fault of the teardown.
KNOWN_C10D = ("The hostname of the client socket cannot be retrieved",)


def agreement_pair():
    outs = run_pair([["-c", AGREEMENT_SCRIPT]] * 2)
    res = []
    for rc, out, err in outs:
        assert rc == 0, err[-2000:]
        res.append(json.loads(out.strip().splitlines()[-1]))
    return res, [err for _rc, _out, err in outs]


def test_agreement_primitives_in_a_pair():
    """One process group of two: each primitive's replicated value."""
    res, _errs = agreement_pair()
    assert res[0] == res[1]
    r = res[0]
    assert r["any"] is True and r["none"] is False and r["min"] == 9
    assert r["sum"] == 2 * (((1 << 31) - 1) // 2)       # the JAX cap
    assert r["budget"] == [True, 7]
    assert r["lowest"] == [3, 1, [11]]
    assert r["none_flagged"] is None
    assert r["rows"] == [[0, 0], [1, 2]]


def test_group_teardown_five_pairs_back_to_back():
    """The group's teardown (``multihost.shutdown`` at exit): five pairs
    in a row, each rank exiting 0 with nothing on stderr but the known
    c10d warnings (a controller that dropped rank 0's store under its
    peer aborted with ``terminate called without an active
    exception``)."""
    for _ in range(5):
        res, errs = agreement_pair()
        assert res[0] == res[1]
        for err in errs:
            left = [ln for ln in err.splitlines()
                    if ln.strip() and not any(k in ln for k in KNOWN_C10D)]
            assert not left, err[-2000:]


def test_cli_leaves_only_a_group_it_formed():
    """``cli.main`` inside a group its caller formed runs under that
    group and leaves it formed (the caller's later runs still need it)."""
    code = (
        "import contextlib, io, json\n"
        "from raft_tla_tpu_torch import cli\n"
        "from raft_tla_tpu_torch.parallel import multihost as mh\n"
        "mh.initialize(timeout_seconds=60)\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        f"    rc = cli.main(['check', {BOUNDED!r}, '--device', 'cpu',\n"
        "                   '--no-trace', '--max-diameter', '2'])\n"
        "print(json.dumps([rc, mh.is_multiprocess(), mh.build_sum()(1)]))\n")
    for rc, out, err in run_pair([["-c", code]] * 2):
        assert rc == 0, err[-2000:]
        assert json.loads(out.strip().splitlines()[-1]) == [0, True, 2]


def test_initialize_again_after_shutdown():
    """A second group in the same process after ``shutdown``, the
    teardown registered once.  The second group rendezvouses on a port
    of its own: a client that reconnects to the first port can still
    find rank 0's old store there, which is closing."""
    code = (
        "import json, os\n"
        "from raft_tla_tpu_torch.parallel import multihost as mh\n"
        "out = []\n"
        "for coord in (os.environ['RAFT_COORDINATOR'],\n"
        "              os.environ['MH_COORDINATOR2']):\n"
        "    mh.initialize(coordinator=coord, timeout_seconds=60)\n"
        "    out.append([mh.process_count(), mh.build_sum()(len(out) + 1)])\n"
        "    mh.shutdown()\n"
        "    out.append(mh.is_multiprocess())\n"
        "print(json.dumps(out))\n")
    second = f"127.0.0.1:{free_port()}"
    for rc, out, err in run_pair([["-c", code]] * 2,
                                 {"MH_COORDINATOR2": second}):
        assert rc == 0, err[-2000:]
        assert json.loads(out.strip().splitlines()[-1]) == [
            [2, 2], False, [2, 6], False]


if __name__ == "__main__" and "--worker" in sys.argv:
    worker()
