"""Selection operators: compare, mask compaction, gather, checksum.

Counterpart of `sigmod2018_tpu/ops/select.py`.  Arrays are padded to a
power-of-two size class and a live-prefix count `n_valid` (a Python int
or a 0-d integer tensor on the same device) marks the rows that exist.
Row ids are int32; values are u64 bit patterns in int64 (ops/u64.py).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from .u64 import as_i64, flip, flip_scalar

Count = Union[int, torch.Tensor]


def live_mask(P: int, n_valid: Count, device) -> torch.Tensor:
    return torch.arange(P, device=device) < n_valid


def compare_mask(values: torch.Tensor, n_valid: Count, op: str,
                 const: int) -> torch.Tensor:
    """Filter mask over the live prefix of a padded u64 column; `const`
    is the predicate's constant as a Python int (unsigned compare)."""
    if op == "=":
        m = values == as_i64(const)
    elif op == "<":
        m = flip(values) < flip_scalar(const)
    elif op == ">":
        m = flip(values) > flip_scalar(const)
    else:
        raise ValueError(f"bad comparator {op!r}")
    return m & live_mask(values.shape[0], n_valid, values.device)


def equal_mask(v1: torch.Tensor, v2: torch.Tensor,
               n_valid: Count) -> torch.Tensor:
    """Self-join / same-component-join mask: v1[i] == v2[i] on live rows."""
    return (v1 == v2) & live_mask(v1.shape[0], n_valid, v1.device)


def mask_positions(mask: torch.Tensor,
                   out_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable compaction of the True positions: (positions int32
    [out_size], count int32 0-d).  Slots past the count hold 0 (a safe
    gather index).  A cumsum gives each selected row its slot; the count
    stays on the device, so no host sync."""
    dest = torch.cumsum(mask, 0) - 1
    dest = torch.where(mask & (dest < out_size), dest, out_size)
    pos = torch.zeros(out_size + 1, dtype=torch.int32, device=mask.device)
    pos.scatter_(0, dest, torch.arange(mask.shape[0], dtype=torch.int32,
                                       device=mask.device))
    return pos[:out_size], mask.sum(dtype=torch.int32)


def gather_u64(col: torch.Tensor, rowids: torch.Tensor) -> torch.Tensor:
    """values[i] = col[rowids[i]]."""
    return col.index_select(0, rowids)


def gather_rows(row: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """row[positions] (positions index the first axis)."""
    return row[positions]


def take_cols(table: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Compact an [A, P] row-id matrix to table[:, positions]."""
    return table.index_select(1, positions)


def checksum(col: torch.Tensor, rowids: torch.Tensor,
             n_valid: Count) -> torch.Tensor:
    """Wrap-around u64 SUM of col over the gathered live prefix (int64
    0-d tensor holding the u64 bits)."""
    live = live_mask(rowids.shape[0], n_valid, rowids.device)
    return torch.where(live, col.index_select(0, rowids), 0).sum()


def checksum_many(cols: torch.Tensor, rowids: torch.Tensor,
                  n_valid: Count) -> torch.Tensor:
    """Batched checksum: cols [V, N] gathered by rowids [V, P] -> [V]
    wrap-around u64 sums (int64 holding the u64 bits) over the live
    prefix."""
    live = live_mask(rowids.shape[1], n_valid, rowids.device)
    vals = torch.gather(cols, 1, rowids.long())
    return torch.where(live[None, :], vals, 0).sum(dim=1)
