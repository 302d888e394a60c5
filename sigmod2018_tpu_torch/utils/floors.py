"""Per-call speed-of-light floors for the join family on one NVIDIA H100.

Counterpart of `sigmod2018_tpu/utils/floors.py`.  A floor is the least
time the card could take for one call: the bytes the call must read,
every input byte once, over the card's memory rate.  Keys and value
columns are 8-byte u64 (the port has no u32 key path).  Outputs are
left out, which keeps each figure a floor, if a looser one.

The operations do not bound these calls: a merge or a binary search
resolves a row with a few compares, far below the card's integer rate
for every byte it reads, so the reference's compare floor (the TPU's
vector pair rate) and its tile floor (the TPU's lane layout) have no
counterpart here.

`engine/trace.py` attaches these floors to the join-family ops of a
traced query; `kernel_bound` counts the kernels' bytes over the same
rate for chip_smoke.py's kernel table and tools/roofline.py.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

# H100 SXM device memory rate (NVIDIA's data sheet), at the full 700 W
HBM_BYTES_PER_S = 3.35e12
KEY_BYTES = 8

# ops of the port (ops/__init__.py) with the signature (keys_b, vals_b,
# n_b, keys_p, vals_p, n_p, ...): a fused final join with checksums
FUSED_OPS = ("fused_join_auto", "join_checksum_fused", "ms_fused")
# (sorted build keys, n_b, probe keys, n_p): an emitting join's counts
COUNT_OPS = ("join_probe_count", "join_probe_count_auto",
             "join_probe_count_ms")
# (key table, probe keys, n_p): the counts through a prep-time key table
TABLE_COUNT_OP = "join_probe_count_table"


def fused_join_floors(Pb: int, Pp: int, vb: int = 1, vp: int = 1,
                      build_key_bytes: int = KEY_BYTES) -> Dict[str, float]:
    """Floors of a fused checksum join: padded build/probe sizes Pb/Pp,
    vb/vp value columns per side, `build_key_bytes` per build row of
    keys (a key table's entries are 4-byte)."""
    bytes_min = build_key_bytes * Pb + KEY_BYTES * Pp \
        + 8 * (vb * Pb + vp * Pp)
    mem = bytes_min / HBM_BYTES_PER_S * 1e3
    return {"bytes_min": bytes_min, "mem_floor_ms": mem, "floor_ms": mem}


def emit_count_floors(Pb: int, Pp: int,
                      build_key_bytes: int = KEY_BYTES) -> Dict[str, float]:
    """Floors of an emitting join's counts: keys only, no value columns."""
    return fused_join_floors(Pb, Pp, 0, 0, build_key_bytes)


def kernel_bound(kernel: str, **n) -> tuple:
    """(ms, bytes): the least time the card could take for one call of a
    kernel, the bytes it must move over the memory rate, each input byte
    read once and each output byte written once.  Live rows only where
    the kernel reads only those (the work depends on the data):

    - K1 (n_b, n_p, Pp): live build and probe u64 keys read (none when
      a side is empty: every count is then 0), int32 cnt and lo written
      for all Pp probe rows;
    - K4 (K, B, SP, live): K u64 arrays' live rows read, int32 starts
      and cnts read, the [K, B, SP] u64 matrix written;
    - K5 (B, Sb, Sp, live_b, live_p): the windows' live u64 keys (the
      caller counts a bucket's only where both its windows hold keys) and
      the int32 [B, 2] windows read, int32 mc [B, Sb] and pc [B, Sp]
      written.

    Their operations (compares and adds, a few per byte moved) stay far
    below the card's integer rate, so bytes bound all three."""
    if kernel == "K1":
        keys = n["n_b"] + n["n_p"] if n["n_b"] and n["n_p"] else 0
        nbytes = 8 * keys + 8 * n["Pp"]
    elif kernel == "K4":
        nbytes = 8 * n["K"] * n["live"] + 8 * n["B"] \
            + 8 * n["K"] * n["B"] * n["SP"]
    elif kernel == "K5":
        nbytes = 8 * (n["live_b"] + n["live_p"]) + 16 * n["B"] \
            + 4 * n["B"] * (n["Sb"] + n["Sp"])
    else:
        raise ValueError(f"no bound for {kernel}")
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def _rows(x) -> int:
    """Value columns in a [V, P] stack (none when absent)."""
    return x.shape[0] if isinstance(x, torch.Tensor) and x.dim() == 2 else 0


def floors_for_op(name: str, args) -> Optional[Dict[str, float]]:
    """Floors of one traced op call from its positional tensor arguments,
    or None for an op outside the join family."""
    if name in FUSED_OPS:
        kb, vb, _, kp, vp = args[:5]
        return fused_join_floors(kb.shape[0], kp.shape[0], _rows(vb),
                                 _rows(vp))
    if name in COUNT_OPS:
        return emit_count_floors(args[0].shape[0], args[2].shape[0])
    if name == TABLE_COUNT_OP:
        table, keys_p = args[:2]
        return emit_count_floors(table.shape[0], keys_p.shape[0],
                                 table.element_size())
    return None
