"""Power-of-two size classes.

Every data-dependent length is bucketed to the next power of two, as in
the reference package (`sigmod2018_tpu/utils/padding.py`): device arrays
come in O(log max_rows) shapes, and a padded tail with a live-prefix
count replaces ragged lengths in every operator.
"""

from __future__ import annotations

import numpy as np


def size_class(n: int, min_pad: int = 128) -> int:
    n = max(int(n), 1)
    return max(min_pad, 1 << (n - 1).bit_length())


def pad_to(arr: np.ndarray, length: int, fill=0) -> np.ndarray:
    if arr.shape[0] == length:
        return arr
    if arr.shape[0] > length:
        raise ValueError(f"array of {arr.shape[0]} > pad target {length}")
    out = np.full((length,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out
