"""ctypes binding of the native loader (loader.cpp): mmap + exact column
stats, the counterpart of `sigmod2018_tpu/storage/native/__init__.py`.

The library is built with g++ at first use, never at import, into
`build/native/loader-<hash of the source>.so` under the repository root,
so a changed source gets a new name and a stale library is never loaded.
Each build writes a file of its own and renames it into place, so
processes that build at once leave one whole library.  A failed build or
self-test raises with the compiler's output: nothing falls back to NumPy
behind the caller's back.  S18_NATIVE=0 (`EngineConfig.native`) selects
the NumPy path instead (`Catalog.from_files(native=False)`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from ..catalog import ColumnStats
from ..relation import Relation

SOURCE = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = SOURCE.parents[3] / "build" / "native"
COMPILE = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17")


class _S18Relation(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.c_void_p),
        ("num_tuples", ctypes.c_uint64),
        ("num_cols", ctypes.c_uint64),
        ("map_base", ctypes.c_void_p),
        ("map_len", ctypes.c_uint64),
    ]


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"loader-{digest}.so"


def build() -> Path:
    """The library's path, compiled first if it is not there.  Raises
    RuntimeError when g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f"{out.name}.",
                               suffix=".tmp")
    os.close(fd)
    try:
        try:
            proc = subprocess.run([*COMPILE, "-o", tmp, str(SOURCE),
                                   "-lpthread"], capture_output=True,
                                  text=True, timeout=300)
        except FileNotFoundError as exc:
            raise RuntimeError(
                "g++ not found on PATH: cannot build the native loader "
                "(S18_NATIVE=0 selects the NumPy path)") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building {SOURCE.name} "
                               f"(rc {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builds race benignly
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _selftest(lib: ctypes.CDLL) -> None:
    """Load and stat a tiny relation in-process (as the reference
    package does), so a bad binary fails here and not while serving."""
    fd, path = tempfile.mkstemp(suffix=".s18")
    try:
        with os.fdopen(fd, "wb") as f:
            # 2 rows x 2 columns: [5, 7] and [5, 9]
            f.write(np.array([2, 2, 5, 7, 5, 9], dtype=np.uint64).tobytes())
        rel = _S18Relation()
        rc = lib.s18_load(path.encode(), ctypes.byref(rel))
        if rc != 0:
            raise RuntimeError(f"native loader self-test: s18_load "
                               f"returned {rc}")
        raw = (ctypes.c_uint64 * 12)()
        lib.s18_stats(rel.data, 2, 2, raw, 1)
        lib.s18_unload(ctypes.byref(rel))
    finally:
        os.unlink(path)
    want = [5, 7, 2, 2, 1, 5, 5, 9, 2, 2, 1, 5]
    if list(raw) != want:
        raise RuntimeError(f"native loader self-test: stats {list(raw)}, "
                           f"expected {want}")


_lock = threading.Lock()
_lib = None


def load() -> ctypes.CDLL:
    """The loaded library, built and self-tested on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.s18_load.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(_S18Relation)]
            lib.s18_load.restype = ctypes.c_int
            lib.s18_unload.argtypes = [ctypes.POINTER(_S18Relation)]
            lib.s18_unload.restype = None
            lib.s18_stats.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
            lib.s18_stats.restype = None
            _selftest(lib)
            _lib = lib
        return _lib


def load_relations_native(paths: Sequence[str]
                          ) -> List[Tuple[Relation, List[ColumnStats]]]:
    """mmap every relation and compute its column stats natively:
    [(Relation, [ColumnStats])] in `paths` order.

    Columns are read-only zero-copy views of the mapping, which is
    unmapped when the last view is freed.  Relations are stat'ed at once
    from a thread each (ctypes releases the interpreter lock), each
    relation's columns by as many native workers as it has columns."""
    lib = load()
    mapped = []
    for path in paths:
        rel = _S18Relation()
        rc = lib.s18_load(os.fspath(path).encode(), ctypes.byref(rel))
        if rc != 0:
            raise ValueError(f"{path}: native load failed ({rc})")
        t, c = int(rel.num_tuples), int(rel.num_cols)
        name = os.path.basename(path)
        if t == 0 or c == 0:
            lib.s18_unload(ctypes.byref(rel))
            mapped.append((Relation([np.empty(0, dtype=np.uint64)
                                     for _ in range(c)], name=name),
                           None, 0, c))
            continue
        buf = (ctypes.c_uint64 * (t * c)).from_address(rel.data)
        weakref.finalize(buf, lib.s18_unload, ctypes.pointer(rel))
        arr = np.frombuffer(buf, dtype=np.uint64).reshape(c, t)
        arr.flags.writeable = False  # the mapping is PROT_READ
        mapped.append((Relation([arr[i] for i in range(c)], name=name),
                       rel.data, t, c))

    def stats(item) -> List[ColumnStats]:
        _, data, t, c = item
        if data is None:  # empty: the NumPy path's stats
            return [ColumnStats(0, 0, 0, 0) for _ in range(c)]
        raw = (ctypes.c_uint64 * (6 * c))()
        lib.s18_stats(data, t, c, raw, c)
        return [ColumnStats(*raw[6 * i:6 * i + 6]) for i in range(c)]

    with ThreadPoolExecutor(max_workers=max(1, len(mapped)),
                            thread_name_prefix="s18stats") as pool:
        all_stats = list(pool.map(stats, mapped))
    return [(m[0], s) for m, s in zip(mapped, all_stats)]
