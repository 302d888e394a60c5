"""Columnar relation storage.

Binary file layout (the contest's, as `sigmod2018_tpu/storage/relation.py`
reads it):

    uint64 num_tuples | uint64 num_columns | col0[num_tuples] | col1[...] ...

all little-endian uint64, column-major.  Loading is zero-copy via
np.memmap; the engine copies columns to the device (padded) at prep.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np


@dataclasses.dataclass
class Relation:
    """An immutable in-memory (or memory-mapped) columnar uint64 table."""

    columns: List[np.ndarray]  # each shape [num_tuples], dtype uint64
    name: str = ""

    @property
    def num_tuples(self) -> int:
        return 0 if not self.columns else int(self.columns[0].shape[0])

    @property
    def num_columns(self) -> int:
        return len(self.columns)


def load_relation(path: str | os.PathLike) -> Relation:
    """mmap a binary relation file."""
    path = os.fspath(path)
    header = np.fromfile(path, dtype="<u8", count=2)
    if header.size < 2:
        raise ValueError(f"{path}: truncated relation header")
    num_tuples, num_cols = int(header[0]), int(header[1])
    expected = 16 + num_tuples * num_cols * 8
    actual = os.path.getsize(path)
    if actual < expected:
        raise ValueError(
            f"{path}: file size {actual} < expected {expected} "
            f"({num_tuples} tuples x {num_cols} cols)"
        )
    if num_tuples == 0 or num_cols == 0:
        return Relation(
            columns=[np.empty(0, dtype=np.uint64) for _ in range(num_cols)],
            name=os.path.basename(path),
        )
    mm = np.memmap(path, dtype="<u8", mode="r", offset=16,
                   shape=(num_cols, num_tuples))
    return Relation(columns=[mm[c] for c in range(num_cols)],
                    name=os.path.basename(path))


def store_relation(rel: Relation, path: str | os.PathLike) -> None:
    """Write the binary format."""
    with open(path, "wb") as f:
        np.array([rel.num_tuples, rel.num_columns], dtype="<u8").tofile(f)
        for col in rel.columns:
            np.ascontiguousarray(col, dtype="<u8").tofile(f)


def store_relation_csv(rel: Relation, path: str | os.PathLike) -> None:
    """Write one row per line, comma-separated."""
    with open(path, "w") as f:
        for i in range(rel.num_tuples):
            f.write(",".join(str(int(col[i])) for col in rel.columns))
            f.write("\n")


def dump_sql(rel: Relation, path: str | os.PathLike, table_name: str) -> None:
    """PostgreSQL DDL and a COPY line that reads `<table_name>.tbl` (the
    CSV of store_relation_csv)."""
    with open(path, "w") as f:
        cols = ", ".join(f"c{i} bigint" for i in range(rel.num_columns))
        f.write(f"CREATE TABLE {table_name} ({cols});\n")
        csv_name = f"{table_name}.tbl"
        f.write(f"copy {table_name} from '{csv_name}' delimiter ',' "
                f"NULL '';\n")


def make_identity_relation(num_tuples: int, num_columns: int,
                           name: str = "") -> Relation:
    """Every column is 0..num_tuples-1, so join results are predictable."""
    col = np.arange(num_tuples, dtype=np.uint64)
    return Relation(columns=[col.copy() for _ in range(num_columns)],
                    name=name)
