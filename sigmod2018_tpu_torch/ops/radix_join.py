"""Fused final-join dispatch (the dispatch half of
`sigmod2018_tpu/ops/radix_join.py`).

The member is chosen by padded size alone, never by device: the
staircase member (ops/ms_join.py) at scale, the sort / table members
(ops/agg_join.py) below.  The radix and equi-depth members and their
Pallas kernels (`_slotfill_kernel`, `_probe_kernel`) are not ported yet
(ROADMAP.md); forcing them raises.
"""

from __future__ import annotations

from .agg_join import (join_checksum_fused, join_checksum_fused_presorted,
                       join_checksum_fused_table,
                       join_checksum_fused_table_pref)
from .ms_join import ms_fused

# Fused joins whose larger padded side reaches this take the staircase
# member.
RADIX_MIN_ROWS = 1 << 18


def ms_member_selected(Pb: int, Pp: int, algo: str) -> bool:
    """True iff fused_join_auto picks the staircase member for these
    padded sizes (the engine then skips the prefix-table member)."""
    return algo == "ms" or (algo == "auto" and RADIX_MIN_ROWS <= max(Pb, Pp))


def fused_join_auto(keys_b, vals_b, n_b, keys_p, vals_p, n_p,
                    algo: str = "auto", presorted=None, table=None,
                    table_prefs=None, presorted_p=None):
    """The engine's fused-final-join entry: (count, sums_build [Vb],
    sums_probe [Vp]).

    `presorted` / `presorted_p`: a side's prep-time (sorted_keys, perm);
    `table`: the build side's prep-time (cumcnt rank table, perm);
    `table_prefs`: prefix tables of every build-side view ([V, Pb+1]),
    which make the table member probe-only (vals_b is then unused)."""
    if algo in ("radix", "qd"):
        raise NotImplementedError(
            f"join member {algo!r} is not ported to the torch package yet "
            f"(ROADMAP.md Queue 1, forceable join members)")
    if ms_member_selected(keys_b.shape[0], keys_p.shape[0], algo):
        return ms_fused(keys_b, vals_b, n_b, keys_p, vals_p, n_p,
                        presorted_b=presorted, presorted_p=presorted_p)
    if table is not None:
        cumcnt, perm = table
        if table_prefs is not None:
            return join_checksum_fused_table_pref(cumcnt, table_prefs,
                                                  keys_p, vals_p, n_p)
        return join_checksum_fused_table(cumcnt, perm, vals_b, n_b, keys_p,
                                         vals_p, n_p)
    if presorted is not None:
        sk, perm = presorted
        return join_checksum_fused_presorted(sk, perm, vals_b, n_b, keys_p,
                                             vals_p, n_p)
    return join_checksum_fused(keys_b, vals_b, n_b, keys_p, vals_p, n_p)
