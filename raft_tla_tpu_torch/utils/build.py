"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a plain-C shared library
``_build/lib<name>-<hash>.so`` (``nvcc -gencode arch=compute_90a,code=
sm_90a -O3 -shared -Xcompiler -fPIC``); the hash covers the source and
every header in ``csrc/``, so an edited kernel rebuilds and an unchanged
one loads the library already built.  ``build_all`` starts one ``nvcc``
per source at once and waits for all of them.

Nothing here runs when a module is imported: the CPU tests import every
module of the port and this machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

#: Kernel sources, one shared library each.
SOURCES = ("compact", "fpset", "fused_tail", "chunk_front", "enqueue")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "kernels build from csrc/ at first use")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def lib_path(name: str) -> Path:
    return BUILD / f"lib{name}-{_digest(name)}.so"


def _start(name: str):
    out = lib_path(name)
    tmp = BUILD / f".{out.stem}.{os.getpid()}.so"
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together.  Returns ``{name: seconds}`` for the
    sources it compiled; raises with the compiler's output on failure."""
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    running = {n: _start(n) for n in names if not lib_path(n).exists()}
    took, errors = {}, []
    for n, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        took[n] = time.time() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            build_all([name])
            _libs[name] = ctypes.CDLL(str(lib_path(name)))
        return _libs[name]


#: What ``kernel_info`` reports of one launch.
INFO_KEYS = ("grid", "block", "dynamic_smem", "registers", "local_bytes",
             "static_smem", "max_threads")


def kernel_info(name: str, which: int, *args: int) -> dict:
    """Launch ``which`` of ``csrc/<name>.cu``'s entry point at the sizes
    ``args``: its grid, block and dynamic shared memory as the launcher
    computes them, and the registers, spill bytes, static shared memory
    and thread limit its kernel was built with (``cudaFuncGetAttributes``
    through the library's ``<name>_kernel_info``)."""
    fn = getattr(library(name), f"{name}_kernel_info")
    out = (ctypes.c_int * len(INFO_KEYS))()
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * (1 + len(args))
                   + [ctypes.POINTER(ctypes.c_int)])
    check(fn(which, *args, out), f"{name}_kernel_info")
    return dict(zip(INFO_KEYS, out))


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
