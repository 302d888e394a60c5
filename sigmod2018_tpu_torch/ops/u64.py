"""uint64 keys carried as int64 bit patterns.

PyTorch's uint64 dtype has no add, `<`, `>>` or searchsorted on the CPU,
so every u64 column lives in an int64 tensor holding the same 64 bits
(`np.ndarray.view(np.int64)`, zero-copy).  Three rules follow:

- equality is bit equality: compare the int64 tensors directly;
- unsigned order is the signed order of the FLIPPED value
  `x ^ (1 << 63)` (`flip`), so sorts and searchsorted run on flipped keys;
- wrap-around int64 sums and products are bit-identical to uint64 ones
  mod 2^64; a result formats as `int(v) & (2**64 - 1)`.

The pad key 2^64-1 is -1 as int64 (`PAD`); flipped, it is the int64 max,
so pads sort after every live key and a stable sort keeps live 2^64-1
keys ahead of them.

This module takes the place of `sigmod2018_tpu/ops/lsd.py`, whose u32
limb passes are a lowering for the TPU's sorter: here one stable sort of
the flipped keys gives both the order and the permutation.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK64 = (1 << 64) - 1
PAD = -1                 # 2^64-1 as an int64 bit pattern
_SIGN = -(1 << 63)       # int64 with only the sign bit set


def as_i64(value: int) -> int:
    """A u64 value (any Python int, taken mod 2^64) as its int64 pattern."""
    v = value & MASK64
    return v - (1 << 64) if v >= 1 << 63 else v


def flip(x: torch.Tensor) -> torch.Tensor:
    """int64 keys whose signed order is the unsigned order of `x`."""
    return torch.bitwise_xor(x, _SIGN)


def flip_scalar(value: int) -> int:
    """`flip` of one u64 value, as a Python int."""
    return (value & MASK64) + _SIGN


def sort_u64(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending unsigned sort: (sorted_keys, perm int64), ties by
    index — the permutation of the reference's `sort_u64_with(keys,
    (iota,))`."""
    fk, perm = torch.sort(flip(keys), stable=True)
    return flip(fk), perm


def ranks_u64(sorted_keys: torch.Tensor, queries: torch.Tensor,
              side: str = "left") -> torch.Tensor:
    """Per query, #elements of `sorted_keys` < q (side="left") or <= q
    (side="right") in unsigned order — `searchsorted_u64` of the
    reference.  int64."""
    return torch.searchsorted(flip(sorted_keys), flip(queries), side=side)
