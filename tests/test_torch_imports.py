"""The PyTorch port stands alone: no jax, nothing of the JAX package, and
no silent CPU fall back when the card is asked for."""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "raft_tla_tpu_torch")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import raft_tla_tpu_torch
for m in pkgutil.walk_packages(raft_tla_tpu_torch.__path__,
                               "raft_tla_tpu_torch."):
    if m.name != "raft_tla_tpu_torch.__main__":
        importlib.import_module(m.name)
import raft_tla_tpu_torch.cli
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "raft_tla_tpu"
             or m.startswith("raft_tla_tpu."))
print("BAD", bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return env


def test_port_imports_neither_jax_nor_the_jax_package():
    # A subprocess: this test process already imported jax (conftest).
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def _port_sources():
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_static_scan_finds_no_jax_imports():
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|raft_tla_tpu)\b"
                     r"(?!_torch)", re.M)
    hits = []
    for path in _port_sources():
        with open(path) as f:
            for m in pat.finditer(f.read()):
                hits.append(f"{os.path.relpath(path, REPO)}: {m.group(0)}")
    assert not hits, hits


@pytest.mark.parametrize("rel", [
    "ops/enqueue.py", "ops/enqueue_cuda.py", "engine/checkpoint.py",
    "analysis/por.py", "analysis/__init__.py", "analysis/lane_map.py",
    "analysis/report.py", "analysis/interp.py", "analysis/effects.py",
    "analysis/bounds.py", "analysis/lint.py", "engine/spillpool.py",
    "engine/chunk.py", "engine/trace.py", "models/safety.py",
    "models/smoke.py", "models/reconfig.py", "obs/__init__.py",
    "obs/metrics.py", "obs/events.py", "obs/coverage.py", "obs/report.py",
    "engine/explain.py", "parallel/__init__.py", "parallel/mesh.py",
    "parallel/simulate.py", "parallel/multihost.py", "obs/tracing.py",
    "obs/flight.py", "obs/expose.py", "obs/history.py", "obs/profile.py",
    "obs/roofline.py", "obs/perf.py", "obs/hunt.py", "native/__init__.py",
    "resilience/__init__.py", "resilience/faults.py",
    "resilience/supervisor.py", "serving/__init__.py", "serving/jobs.py",
    "serving/manager.py", "server.py", "clients.py"])
def test_split_tail_modules_are_covered(rel):
    """The modules of the split tail, the checkpoints, the POR table and
    the static analyzer (lane map, report, graph evaluator, effects,
    bounds, lint), the
    level loop's chunk, spill pool and trace store, the safety suite, the
    smoke roots, the reconfiguration variant, observability (with the
    span tracer, flight recorder, Prometheus exposition, history, chunk
    profiler, roofline, perf accounting and hunt), the native trace
    store's loader, the counterexample explainer, the mesh and its
    process group, resilience (fault injection, the supervisor), the job
    layer, the checker service and its clients are among
    the scanned sources,
    import on a machine without a card, and name neither jax nor the JAX
    package in an import."""
    import importlib
    path = os.path.join(PORT, rel)
    assert path in set(_port_sources())
    name = "raft_tla_tpu_torch." + rel[:-3].replace("/", ".")
    mod = importlib.import_module(name.removesuffix(".__init__"))
    src = open(path).read()
    assert not re.search(r"^\s*(?:import|from)\s+(jax|jaxlib|raft_tla_tpu)\b"
                         r"(?!_torch)", src, re.M)
    assert mod.__file__ == path


def test_the_clients_import_no_torch():
    """``python -m raft_tla_tpu_torch submit|jobs|watch`` never imports
    torch (so never touches the device), and offers the engine's plans."""
    probe = ("import sys\n"
             "from raft_tla_tpu_torch import clients\n"
             "print(clients.COMMANDS, 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip() == "('submit', 'jobs', 'watch') False"
    from raft_tla_tpu_torch import cli, clients
    assert clients.PIPELINES == cli.PIPELINES


def test_every_kernel_source_has_its_loader():
    """Each ``csrc/<name>.cu`` in the build list exists and one wrapper
    module loads it at call time (never at import)."""
    from raft_tla_tpu_torch.utils import build
    assert "enqueue" in build.SOURCES
    wrappers = "".join(open(p).read() for p in _port_sources()
                       if os.sep + "ops" + os.sep in p)
    for name in build.SOURCES:
        assert os.path.exists(os.path.join(PORT, "csrc", f"{name}.cu")), name
        assert f'build.library("{name}")' in wrappers, name


def test_cuda_requested_without_cuda_raises(monkeypatch):
    from raft_tla_tpu_torch.engine.check import make_engine
    from raft_tla_tpu_torch.utils.cfg import load_config
    from raft_tla_tpu_torch.utils.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    setup = load_config(os.path.join(REPO, "configs/MCraft_bounded.cfg"))
    with pytest.raises(RuntimeError, match="cuda"):
        make_engine(setup)                     # the default is the card
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         env={k: v for k, v in env.items()
                              if k != "PYTHONPATH"},
                         capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
