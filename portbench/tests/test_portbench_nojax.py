"""No module a run loads has the top-level name of JAX or of the JAX
package, compared as whole names."""

import json
import os
import subprocess
import sys

from conftest import REPO, make_tree
from portbench import harness


def test_whole_top_level_names():
    names = ["raft_tla_tpu_torch", "raft_tla_tpu_torch.engine.bfs",
             "jaxtyping", "raft_tla_tpu_tools", "portbench.run",
             "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "raft_tla_tpu", "raft_tla_tpu.engine.bfs"]
    assert harness.foreign_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "raft_tla_tpu", "raft_tla_tpu.engine.bfs"]


SCRIPT = r"""
import json, sys, time
sys.path.insert(0, {repo!r})
import portbench.run as run_mod
from portbench.reference import compare, control, oracle
from portbench import devtrace, harness
imported = harness.foreign_modules(sys.modules)
args = run_mod.parse(["--workload", "mcraft_tiny.bfs_l5", "--seed", "7",
                      "--seconds", "0.2", "--trace", "1"])
result, compared = run_mod.execute(args, device="cpu", root={root!r},
                                   t0=time.perf_counter())
assert "raft_tla_tpu_torch" in sys.modules
print(json.dumps({{"imported": imported,
                  "after_run": harness.foreign_modules(sys.modules),
                  "correct": result["correct"]}}))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    root = make_tree(str(tmp_path))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(repo=REPO, root=root)],
        capture_output=True, text=True, env=env, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"imported": [], "after_run": [], "correct": True}
