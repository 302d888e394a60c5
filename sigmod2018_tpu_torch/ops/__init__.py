from .select import (
    compare_mask,
    equal_mask,
    mask_positions,
    gather_u64,
    take_cols,
    checksum,
)
from .sort_join import (join_build, join_probe_count,
                        join_probe_count_table, join_emit)
from .ms_join import (join_probe_count_auto, join_probe_count_ms, ms_fused,
                      staircase_counts, staircase_counts_plain)
from .agg_join import (join_checksum_fused, join_checksum_fused_presorted,
                       join_checksum_fused_table,
                       join_checksum_fused_table_pref, prefix_by_perm)
from .radix_join import fused_join_auto, ms_member_selected
from .cartesian import cartesian_indices

__all__ = [
    "compare_mask",
    "equal_mask",
    "mask_positions",
    "gather_u64",
    "take_cols",
    "checksum",
    "join_build",
    "join_probe_count",
    "join_probe_count_table",
    "join_emit",
    "join_probe_count_auto",
    "join_probe_count_ms",
    "ms_fused",
    "staircase_counts",
    "staircase_counts_plain",
    "join_checksum_fused",
    "join_checksum_fused_presorted",
    "join_checksum_fused_table",
    "join_checksum_fused_table_pref",
    "prefix_by_perm",
    "fused_join_auto",
    "ms_member_selected",
    "cartesian_indices",
]
