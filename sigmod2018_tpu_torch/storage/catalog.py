"""Catalog: the set of loaded relations + exact per-column statistics.

Statistics are the reference package's (`sigmod2018_tpu/storage/catalog.py`):
min/max, row count, exact distinct count and a 1-bucket most-common-value
sketch, all from one sort-unique pass per column on the host.  They feed
only the planner, so they never affect a result.  The native C++ loader
and the on-disk stats cache of the reference package are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

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


class Catalog:
    """All loaded relations, indexed by relation id (file order on stdin)."""

    def __init__(self, relations: Sequence[Relation],
                 compute_stats: bool = True):
        self.relations: List[Relation] = list(relations)
        self.stats: List[List[ColumnStats]] = []
        if compute_stats:
            self.stats = [[compute_column_stats(col) for col in rel.columns]
                          for rel in self.relations]

    @staticmethod
    def from_files(paths: Sequence[str],
                   compute_stats: bool = True) -> "Catalog":
        return Catalog([load_relation(p) for p in paths],
                       compute_stats=compute_stats)

    def relation(self, rid: int) -> Relation:
        return self.relations[rid]

    def column(self, rid: int, cid: int) -> np.ndarray:
        return self.relations[rid].columns[cid]

    def column_stats(self, rid: int, cid: int) -> ColumnStats:
        return self.stats[rid][cid]

    def __len__(self) -> int:
        return len(self.relations)
