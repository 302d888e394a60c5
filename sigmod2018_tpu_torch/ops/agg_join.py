"""Final-join checksum fusion: aggregate pushdown into the probe.

Counterpart of `sigmod2018_tpu/ops/agg_join.py`.  When a join is the last
operator of a query, only its SUMs are needed:

    per probe row i with sorted-build match range [lo_i, hi_i):
        count        += hi_i - lo_i
        sum(b_col_v) += pref_v[hi_i] - pref_v[lo_i]   (prefix sums of the
                                                       build-side view col)
        sum(p_col_v) += (hi_i - lo_i) * p_col_v[i]

all wrap-around u64 (int64 bit patterns).  Shapes: build_cols [Vb, Pb],
probe_cols [Vp, Pp], V* may be 0.  Every member returns (count int64 0-d,
sums_build [Vb] int64, sums_probe [Vp] int64).  The members are used below
ops.radix_join.RADIX_MIN_ROWS; at scale the staircase member serves.
"""

from __future__ import annotations

import torch

from .select import Count, live_mask
from .sort_join import join_build, match_ranges, table_ranges


def _sums(lo, hi, cnt, pref, probe_cols, n_probe: Count):
    live = live_mask(cnt.shape[0], n_probe, cnt.device)
    sums_build = torch.where(live[None, :], pref[:, hi] - pref[:, lo],
                             0).sum(1)
    sums_probe = (cnt[None, :] * probe_cols).sum(1)
    return cnt.sum(), sums_build, sums_probe


def _prefix(sv: torch.Tensor) -> torch.Tensor:
    """[V, P] -> [V, P+1] exclusive-then-inclusive wrap-around prefix sums."""
    return torch.cat([sv.new_zeros(sv.shape[0], 1), torch.cumsum(sv, 1)], 1)


def _sorted_payload(build_cols, perm, n_build: Count):
    """Build-side view columns in key-sorted order, pads zeroed."""
    live = live_mask(perm.shape[0], n_build, perm.device)
    return torch.where(live[None, :], build_cols.index_select(1, perm), 0)


def join_checksum_fused_presorted(sorted_keys, perm, build_cols,
                                  n_build: Count, probe_keys, probe_cols,
                                  n_probe: Count):
    """Fused checksum join whose build side was sorted by join_build
    (at prep, or just now by join_checksum_fused)."""
    pref = _prefix(_sorted_payload(build_cols, perm, n_build))
    lo, hi, cnt = match_ranges(sorted_keys, n_build, probe_keys, n_probe)
    return _sums(lo, hi, cnt, pref, probe_cols, n_probe)


def join_checksum_fused(build_keys, build_cols, n_build: Count, probe_keys,
                        probe_cols, n_probe: Count):
    sk, perm = join_build(build_keys, n_build)
    return join_checksum_fused_presorted(sk, perm, build_cols, n_build,
                                         probe_keys, probe_cols, n_probe)


def join_checksum_fused_table(cumcnt, perm, build_cols, n_build: Count,
                              probe_keys, probe_cols, n_probe: Count):
    """Fused checksum join against a prep-time key table — zero sorts
    (ops/sort_join.py::table_ranges for the table contract)."""
    pref = _prefix(_sorted_payload(build_cols, perm, n_build))
    lo, hi, cnt = table_ranges(cumcnt, probe_keys, n_probe)
    return _sums(lo, hi, cnt, pref, probe_cols, n_probe)


def prefix_by_perm(vals, perm, n: Count) -> torch.Tensor:
    """Prep artifact for join_checksum_fused_table_pref: pref[i] = sum of
    the first i live rows of `vals` in key-sorted order.  Shape [P+1]."""
    return _prefix(_sorted_payload(vals[None, :], perm, n))[0]


def join_checksum_fused_table_pref(cumcnt, prefs, probe_keys, probe_cols,
                                   n_probe: Count):
    """Probe-only fused join: the rank table AND the build side's prefix
    sums ([V, Pb+1], engine device_prefix_table) are prep artifacts, so
    query-time work is gathers per probe row and nothing per build row."""
    lo, hi, cnt = table_ranges(cumcnt, probe_keys, n_probe)
    return _sums(lo, hi, cnt, prefs, probe_cols, n_probe)
