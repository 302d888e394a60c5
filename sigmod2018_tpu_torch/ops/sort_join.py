"""Equi-join: sort-build + searchsorted-probe + range expansion.

Counterpart of `sigmod2018_tpu/ops/sort_join.py`:

  build:  stable sort of the build side's keys (pads forced to 2^64-1,
          which sort last; a live 2^64-1 key stays ahead of them)
  probe:  two searchsorted passes give each probe row its match range
          [lo, hi) in sorted-build coordinates, clamped to the live prefix
  emit:   ranges expand into dense (build_pos, probe_pos) pairs of a
          host-chosen power-of-two output size

Output cardinality is data-dependent: the probe returns the exact total
so the host sizes the emit (the one sync of an intermediate join).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .select import Count, live_mask
from .u64 import PAD, ranks_u64, sort_u64


def _ccum_total(cnt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ccum int64 inclusive cumsum, total int64 0-d) of per-row counts."""
    return torch.cumsum(cnt, 0, dtype=torch.int64), cnt.sum(dtype=torch.int64)


def match_ranges(sorted_keys: torch.Tensor, n_build: Count,
                 probe_keys: torch.Tensor, n_probe: Count):
    """(lo, hi, cnt) int64 per probe row against a build side sorted by
    join_build: [lo, hi) is the row's match range in sorted-build
    coordinates, clamped to the live prefix (pads sort last, so the clamp
    keeps exactly the live copies of a 2^64-1 key); cnt is 0 on dead
    probe rows."""
    lo = torch.clamp(ranks_u64(sorted_keys, probe_keys, "left"), max=n_build)
    hi = torch.clamp(ranks_u64(sorted_keys, probe_keys, "right"),
                     max=n_build)
    live = live_mask(probe_keys.shape[0], n_probe, probe_keys.device)
    return lo, hi, torch.where(live, hi - lo, 0)


def join_build(keys: torch.Tensor,
               n_valid: Count) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort the build side: (sorted_keys, perm int32), pads forced to
    2^64-1 so they sort last, ties broken by index."""
    live = live_mask(keys.shape[0], n_valid, keys.device)
    sk, perm = sort_u64(torch.where(live, keys, PAD))
    return sk, perm.to(torch.int32)


def join_probe_count(sorted_keys: torch.Tensor, n_build: Count,
                     probe_keys: torch.Tensor, n_probe: Count):
    """(lo int32, cnt int32, ccum int64, total int64 0-d): lo[i] = first
    match position in the sorted build array, cnt[i] = its number of
    matches, ccum = inclusive cumsum of cnt, total = ccum[-1]."""
    lo, _, cnt = match_ranges(sorted_keys, n_build, probe_keys, n_probe)
    return (lo.to(torch.int32), cnt.to(torch.int32), *_ccum_total(cnt))


def table_ranges(cumcnt: torch.Tensor, probe_keys: torch.Tensor,
                 n_probe: Count):
    """(lo, hi, cnt) against a prep-time key table: cumcnt[k] = #build
    rows with key < k for k in [0, u+2] (u = the column's exact max), so
    a probe key's range is two gathers.  Keys past the domain (unsigned
    k > u, which includes every negative int64 pattern) get [n, n)."""
    u = cumcnt.shape[0] - 3
    in_dom = (probe_keys >= 0) & (probe_keys <= u)
    pkc = torch.where(in_dom, probe_keys, u + 1)
    lo = cumcnt[pkc].to(torch.int64)
    hi = torch.where(in_dom, cumcnt[pkc + 1].to(torch.int64), lo)
    live = live_mask(probe_keys.shape[0], n_probe, probe_keys.device)
    return lo, hi, torch.where(live, hi - lo, 0)


def join_probe_count_table(cumcnt: torch.Tensor, probe_keys: torch.Tensor,
                           n_probe: Count):
    """join_probe_count against a prep-time key table — zero sorts.  The
    ranges are in the coordinates of the column's prep sort, so
    join_emit consumes them with that sort's perm."""
    lo, _, cnt = table_ranges(cumcnt, probe_keys, n_probe)
    return (lo.to(torch.int32), cnt.to(torch.int32), *_ccum_total(cnt))


def join_emit(perm: torch.Tensor, lo: torch.Tensor, ccum: torch.Tensor,
              total: int, out_size: int):
    """Expand match ranges into dense (build_pos, probe_pos) int32 pairs.

    build_pos indexes the original (unsorted, padded) build input,
    probe_pos the probe input; slots >= total hold 0.  Each non-empty
    probe row scatters its index (+1) at its first output slot (slots
    strictly increase, so no collisions) and a running max fills every
    slot with its owning row: O(out_size + Pp)."""
    dev = ccum.device
    Pp = ccum.shape[0]
    cnt = torch.diff(ccum, prepend=ccum.new_zeros(1))
    starts = ccum - cnt
    owner = torch.zeros(out_size + 1, dtype=torch.int64, device=dev)
    dest = torch.where((cnt > 0) & (starts < out_size), starts, out_size)
    owner.scatter_reduce_(0, dest, torch.arange(1, Pp + 1, device=dev),
                          reduce="amax")
    i = torch.clamp(torch.cummax(owner[:out_size], 0).values - 1, 0, Pp - 1)
    t = torch.arange(out_size, device=dev)
    valid = t < min(int(total), out_size)
    bidx = torch.where(valid, lo.index_select(0, i) + (t - starts[i]), 0)
    build_pos = torch.where(valid, perm.index_select(0, bidx), 0)
    probe_pos = torch.where(valid, i, 0)
    return build_pos.to(torch.int32), probe_pos.to(torch.int32)
