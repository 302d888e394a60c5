"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface.  At first use it is
compiled with nvcc for Hopper (`sm_90a`) into
`build/kernels/<name>-<hash of the source>.so` under the repository root,
and loaded with ctypes; a changed source gets a new name, so a stale
library is never loaded.  `ptxas -v` output (registers, shared memory,
spills) is kept beside the library as `<name>-<hash>.log`.

Nothing here runs at import: a CPU-only machine imports the package and
never builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# K1 (ops/ms_join.py), K4 and K5 (ops/radix_join.py)
NAMES = ("stair_counts", "slot_fill", "probe_counts")

_lock = threading.Lock()  # guards _libs and _name_locks
_libs: dict = {}
_name_locks: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc on PATH or "
                           "CUDA_HOME) to build the package's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _build(name: str) -> Path:
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name} "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: concurrent builders race benignly
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use.  Builds
    of different kernels may run at once (one lock per name)."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        with _lock:
            lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            with _lock:
                _libs[name] = lib
        return lib


def load_all(names) -> dict:
    """Build and load several kernels with one nvcc each, all started
    together: {name: seconds until that one was loaded}."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()

    def one(name: str) -> float:
        load(name)
        return time.perf_counter() - t0

    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(one, names)))
