"""Catalog: the set of loaded relations + exact per-column statistics.

Statistics are the reference package's (`sigmod2018_tpu/storage/catalog.py`):
min/max, row count, exact distinct count and a 1-bucket most-common-value
sketch, all from one sort-unique pass per column on the host.  They feed
only the planner, so they never affect a result.  The native C++ loader
and the on-disk stats cache of the reference package are not ported yet.

`identity_digest` and `prep_cache_dir` key the prep artifacts kept on
disk across processes (the compiled engine's learned size classes).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
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
    def from_files(paths: Sequence[str],
                   compute_stats: bool = True) -> "Catalog":
        cat = Catalog([load_relation(p) for p in paths],
                      compute_stats=compute_stats)
        cat.source_paths = list(paths)
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
