"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The run loads and warms up (``setup_s``),
measures for ``--seconds`` (the cell's traffic kind, ``traffic/<kind>.py``),
profiles a steady sub-window when ``--trace 1``, gives the program's device
memory back, decides ``correct`` against the plain reference
(``reference/``) and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``compared``, each number compared
beside its limit (also the last lines of standard error).  With
``--trace 0`` the metrics are the cell's end-to-end ones, with ``--trace 1``
its per-layer ones (``BENCHMARK.json``).  It measures the PyTorch and CUDA
port alone: no card, fewer cards than the cell asks for, or a JAX module
loaded in the process, and it exits non-zero with no result.

What a run writes stays inside the checkout, under ``.portbench/``: the
window's checks (``run/checks.json``: each check's clock, answer and
phases), the engine's span file of a traced run, and the caches named in
``CACHES``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import devtrace, harness  # noqa: E402
from portbench.reference.compare import is_correct  # noqa: E402

#: Build and kernel caches a library of the program may use, each at a
#: fixed path inside the checkout (the port's own kernels build into
#: ``raft_tla_tpu_torch/_build/``, also inside it).
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}

#: Exit codes of a run that prints no result.
NO_CARD, FOREIGN_MODULES = 3, 4


class Run:
    """What a run knows: the cell, its configuration, the window's checks,
    the traced sub-window; metric readers read it (``metrics/*.py``)."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device: str, root: str):
        self.cell = cell
        self.config = cell["config_data"]
        self.params = cell.get("params", {})
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.root = device, root
        self.out_dir = os.path.join(root, ".portbench", "run")
        self.setup_s = None
        self.checks = []
        self.profile = None
        self.row_bytes = None
        self.n_roots = None
        self.device_kind = None
        self.peaks = harness.read_json(os.path.join(harness.HERE,
                                                    "peaks.json"))
        # (part, perf_counter when it ended) of the set-up
        self.marks = []

    def mark(self, part: str) -> None:
        self.marks.append((part, time.perf_counter()))

    def setup_parts(self, t0: float) -> dict:
        """Seconds of each part of the set-up, in order."""
        out, at = {}, t0
        for part, t in self.marks:
            out[part] = t - at
            at = t
        return out


def parse(argv=None):
    ap = argparse.ArgumentParser(description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_count() -> int:
    import torch
    if not torch.cuda.is_available():
        return 0
    return torch.cuda.device_count()


def power_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"


def execute(args, device: str = "cuda", root: str = ROOT, t0: float = T0,
            marks=()):
    """Everything after the look for a card: ``(result, compared)``, or
    ``(None, foreign module names)`` when a JAX module got loaded.
    ``marks`` are the set-up's parts before it (``Run.marks``)."""
    bench = harness.load_benchmark(root)
    base = os.path.join(root, "portbench")
    cell = harness.load_workload(args.workload, base)
    run = Run(cell, args.seed, args.seconds, bool(args.trace), device, root)
    run.marks.extend(marks)
    os.makedirs(run.out_dir, exist_ok=True)
    kind = harness.traffic_kind(cell["kind"], base)
    state = kind.prepare(run)
    run.setup_s = time.perf_counter() - t0
    parts = run.setup_parts(t0)
    run.checks = kind.window(state, run, args.seconds)
    with open(os.path.join(run.out_dir, "checks.json"), "w") as f:
        json.dump(run.checks, f)
    if run.trace:
        run.profile = kind.profile(state, run)
    peak = 0
    if device != "cpu":
        import torch
        peak = torch.cuda.max_memory_allocated()
        run.device_kind = torch.cuda.get_device_name(0)
        print(f"card: {power_line()}", flush=True)
    metrics = harness.metrics_block(bench, args.workload, run.trace, run, base)
    kind.release(state, run)
    compared = kind.judge(run)
    foreign = harness.foreign_modules(sys.modules)
    if foreign:
        return None, foreign
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": run.device_kind or device, "count": cell["chips"],
           "memory_peak_bytes": peak}
    judged = len(run.checks) + (len(run.profile.checks)
                                if run.profile is not None else 0)
    result = {"correct": is_correct(compared), "attempted": judged,
              "failed": int(compared.get("checks_wrong", (0, 0))[0]),
              "metrics": metrics, "device": dev}
    prof = run.profile
    if prof is not None and prof.marks:
        dev["busy_s"] = prof.busy_us / 1e6
        dev["window_s"] = prof.window_us / 1e6
        result["breakdown"] = {
            "device_ops": devtrace.top_ops(prof.dev),
            "idle_gaps": devtrace.gaps_by_span(prof.idle_gaps(),
                                               prof.spans)}
    result["setup_parts"] = parts
    result["compared"] = harness.compared_block(compared)
    return result, compared


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, ".portbench", "cache", sub)
    marks = [("interpreter", time.perf_counter())]
    cell = harness.load_workload(args.workload)
    have = card_count()
    marks.append(("torch", time.perf_counter()))
    if have < cell["chips"]:
        print(f"portbench: the cell asks for {cell['chips']} card(s), "
              f"CUDA shows {have}; no result", file=sys.stderr)
        return NO_CARD
    result, compared = execute(args, marks=marks)
    if result is None:
        print("portbench: modules of JAX or the JAX package loaded: "
              + ", ".join(compared), file=sys.stderr)
        return FOREIGN_MODULES
    print(f"setup parts (s): {result['setup_parts']}", file=sys.stderr)
    for line in harness.compared_lines(compared):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
