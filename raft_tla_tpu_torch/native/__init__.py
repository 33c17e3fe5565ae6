"""Host code in C++, bound with ctypes: the predecessor-trace store.

The JAX package's ``native/``, kept as the port's own copy.
``trace_store.cpp`` (an open-addressing hash map of ``fp -> (parent fp,
action id)``, the first record of a fingerprint wins) is compiled at
first use with ``g++ -O2 -shared -fPIC -std=c++17`` into
``_build/libtracestore-<hash>.so`` (the hash covers the source and the
flags, so an edited source rebuilds).  ``load()`` returns the library, or
raises ``NativeUnavailable`` with the compiler's own message: a caller
that falls back says so.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "trace_store.cpp"
BUILD = HERE.parent / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    """The native store could not be built or loaded (the message says
    why)."""


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD / f"libtracestore-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise NativeUnavailable("no C++ compiler (g++ or $CXX) to build "
                                f"{SOURCE.name}")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, text=True,
                       timeout=120)
    except subprocess.CalledProcessError as e:
        raise NativeUnavailable(f"{cxx} failed on {SOURCE.name}: "
                                f"{e.stderr.strip()[-800:]}") from None
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeUnavailable(f"{cxx} failed on {SOURCE.name}: "
                                f"{type(e).__name__}: {e}") from None
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The store's library, built at first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeUnavailable(f"cannot load {path.name}: {e}") \
                from None
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.ts_create.restype = ctypes.c_void_p
        lib.ts_create.argtypes = [ctypes.c_uint64]
        lib.ts_destroy.argtypes = [ctypes.c_void_p]
        lib.ts_size.restype = ctypes.c_uint64
        lib.ts_size.argtypes = [ctypes.c_void_p]
        lib.ts_add_batch.argtypes = [ctypes.c_void_p, u64p, u64p, i32p,
                                     ctypes.c_uint64]
        lib.ts_get.restype = ctypes.c_int
        lib.ts_get.argtypes = [ctypes.c_void_p, ctypes.c_uint64, u64p, i32p]
        lib.ts_export.restype = ctypes.c_uint64
        lib.ts_export.argtypes = [ctypes.c_void_p, u64p, u64p, i32p,
                                  ctypes.c_uint64]
        _lib = lib
        return lib
