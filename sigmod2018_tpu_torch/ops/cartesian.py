"""Cross product of two disconnected intermediate components
(counterpart of `sigmod2018_tpu/ops/cartesian.py`): output slot t maps to
(t // n2, t % n2)."""

from __future__ import annotations

import torch


def cartesian_indices(n1: int, n2: int, out_size: int, device):
    t = torch.arange(out_size, device=device)
    n2s = max(n2, 1)
    valid = t < n1 * n2s
    i1 = torch.where(valid, t // n2s, 0).to(torch.int32)
    i2 = torch.where(valid, t % n2s, 0).to(torch.int32)
    return i1, i2
