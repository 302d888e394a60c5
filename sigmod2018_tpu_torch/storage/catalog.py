"""Catalog: the set of loaded relations + exact per-column statistics.

Statistics are the reference package's (`sigmod2018_tpu/storage/catalog.py`):
min/max, row count, exact distinct count and a 1-bucket most-common-value
sketch.  They feed only the planner, so they never affect a result.
`Catalog.from_files` takes them from the on-disk stats cache, else from
the native loader (storage/native: mmap + multithreaded sort-unique in
C++), else from NumPy (one sort-unique pass per column), in that order.

`identity_digest` and `prep_cache_dir` key the prep artifacts kept on
disk across processes: the stats here, the compiled engine's learned
size classes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import sys
import tempfile
from typing import List, Optional, Sequence

import numpy as np

from .relation import Relation, load_relation


@dataclasses.dataclass
class ColumnStats:
    """l/u = min/max value, f = row count, d = distinct count, plus the
    MCV sketch: fmax = multiplicity of the most common value, mode = that
    value (it keeps the join estimate from missing Zipf hot keys)."""

    l: int
    u: int
    f: int
    d: int
    fmax: int = 1
    mode: int = 0

    def copy(self) -> "ColumnStats":
        return ColumnStats(self.l, self.u, self.f, self.d, self.fmax,
                           self.mode)


def compute_column_stats(col: np.ndarray) -> ColumnStats:
    n = int(col.shape[0])
    if n == 0:
        return ColumnStats(0, 0, 0, 0)
    uniq, counts = np.unique(col, return_counts=True)
    top = int(np.argmax(counts))
    return ColumnStats(int(uniq[0]), int(uniq[-1]), n, int(uniq.size),
                       int(counts[top]), int(uniq[top]))


def identity_digest(paths: Sequence[str]) -> Optional[str]:
    """Identity of a relation set: sha1 over (basename, size, mtime_ns)
    per file, as in the reference package.  None when a file cannot be
    stat'ed."""
    h = hashlib.sha1()
    try:
        for p in paths:
            st = os.stat(p)
            h.update(f"{os.path.basename(p)}:{st.st_size}:"
                     f"{st.st_mtime_ns}\n".encode())
    except OSError:
        return None
    return h.hexdigest()


def prep_cache_dir() -> Optional[str]:
    """Directory of the prep artifacts, or None when disabled:
    S18_PREP_CACHE=0 disables, S18_PREP_CACHE=<dir> relocates.  The
    default is the port's own, so the two packages never read each
    other's files."""
    loc = os.environ.get("S18_PREP_CACHE", "")
    if loc == "0":
        return None
    return loc or os.path.join(os.path.expanduser("~"), ".cache",
                               "sigmod2018_tpu_torch")


# ---------------------------------------------------------------------------
# Stats cache: the prep phase's costly artifact is the per-column exact
# stats.  They are kept in the prep cache as stats-torch-<identity
# digest>.npz, keyed by (basename, size, mtime) of every file, so a
# re-serve of the same relation set skips the scan; a rewritten file has
# another key.  The `torch` in the name keeps the two packages from
# reading each other's file when S18_PREP_CACHE points both at one
# directory.  S18_PREP_CACHE=0 reads and writes nothing.
# ---------------------------------------------------------------------------

_STAT_FIELDS = ("l", "u", "f", "d", "fmax", "mode")


def stats_cache_path(paths: Sequence[str]) -> Optional[str]:
    base = prep_cache_dir()
    digest = identity_digest(paths) if base else None
    if digest is None:
        return None
    return os.path.join(base, f"stats-torch-{digest}.npz")


def _stats_cache_load(paths: Sequence[str]
                      ) -> Optional[List[List[ColumnStats]]]:
    fp = stats_cache_path(paths)
    if fp is None or not os.path.exists(fp):
        return None
    try:
        with np.load(fp) as z:
            ncols = [int(n) for n in z["ncols"]]
            flat = {f: [int(v) for v in z[f]] for f in _STAT_FIELDS}
    except (OSError, KeyError, ValueError) as exc:
        print(f"stats cache {fp} not read: {exc!r}", file=sys.stderr)
        return None
    if len(ncols) != len(paths) or any(len(v) != sum(ncols)
                                       for v in flat.values()):
        return None
    stats, k = [], 0
    for nc in ncols:
        stats.append([ColumnStats(*(flat[f][k + c] for f in _STAT_FIELDS))
                      for c in range(nc)])
        k += nc
    return stats


def _stats_cache_store(paths: Sequence[str],
                       stats: List[List[ColumnStats]]) -> None:
    fp = stats_cache_path(paths)
    if fp is None:
        return
    # uint64: l, u and mode are key values and may pass 2^63
    flat = {f: np.array([getattr(s, f) for rel in stats for s in rel],
                        dtype=np.uint64) for f in _STAT_FIELDS}
    try:
        os.makedirs(os.path.dirname(fp), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(fp), suffix=".npz")
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, ncols=np.array([len(r) for r in stats],
                                        dtype=np.uint64), **flat)
        os.replace(tmp, fp)  # atomic: concurrent servers race benignly
    except OSError as exc:
        # Serving goes on: the next process only computes the stats again.
        print(f"stats cache not written: {exc!r}", file=sys.stderr)


class Catalog:
    """All loaded relations, indexed by relation id (file order on stdin).
    `source_paths` are the files they came from (empty when built in
    memory)."""

    def __init__(self, relations: Sequence[Relation],
                 compute_stats: bool = True):
        self.relations: List[Relation] = list(relations)
        self.stats: List[List[ColumnStats]] = []
        self.source_paths: List[str] = []
        if compute_stats:
            self.stats = [[compute_column_stats(col) for col in rel.columns]
                          for rel in self.relations]

    @staticmethod
    def from_files(paths: Sequence[str], compute_stats: bool = True,
                   native: bool = True) -> "Catalog":
        """The relations of `paths` with their stats: from the stats
        cache, else from the native loader (`native`, S18_NATIVE), else
        from NumPy; a computed set is written to the cache."""
        paths = [os.fspath(p) for p in paths]
        stats = _stats_cache_load(paths) if compute_stats else None
        if stats is not None or not compute_stats:
            relations = [load_relation(p) for p in paths]  # mmap only
        elif native:
            from .native import load_relations_native

            relations, stats = [], []
            for rel, rel_stats in load_relations_native(paths):
                relations.append(rel)
                stats.append(rel_stats)
            _stats_cache_store(paths, stats)
        else:
            relations = [load_relation(p) for p in paths]
            stats = [[compute_column_stats(col) for col in rel.columns]
                     for rel in relations]
            _stats_cache_store(paths, stats)
        cat = Catalog(relations, compute_stats=False)
        cat.stats = stats or []
        cat.source_paths = paths
        return cat

    def relation(self, rid: int) -> Relation:
        return self.relations[rid]

    def column(self, rid: int, cid: int) -> np.ndarray:
        return self.relations[rid].columns[cid]

    def dense_column(self, rid: int, cid: int) -> np.ndarray:
        """The column as an in-memory array, cached.  Base columns are
        np.memmap views, and NumPy fancy indexing through a memmap goes
        through its Python __getitem__ with extra copies; the host
        executors (engine/oracle.py, the NumPy half of
        engine/factorized.py) gather per query, so they read columns
        through here.  In-memory relations pass through without a copy."""
        cache = self.__dict__.setdefault("_dense_columns", {})
        hit = cache.get((rid, cid))
        if hit is None:
            raw = self.relations[rid].columns[cid]
            if isinstance(raw, np.memmap):
                # np.ascontiguousarray of a contiguous memmap is a VIEW:
                # force the copy into an anonymous array
                hit = np.array(raw, dtype=raw.dtype, copy=True)
            else:
                hit = np.ascontiguousarray(raw)
            cache[(rid, cid)] = hit
        return hit

    def column_stats(self, rid: int, cid: int) -> ColumnStats:
        return self.stats[rid][cid]

    def __len__(self) -> int:
        return len(self.relations)
