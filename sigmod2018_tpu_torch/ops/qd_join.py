"""Equi-depth (quantile) partition join: the fused-join member forced with
`S18_JOIN=qd`.  Counterpart of `sigmod2018_tpu/ops/qd_join.py`.

Same contract as the radix member (ops/radix_join.py), but the partition
is the BUILD side's own order statistics instead of low key bits:

    bucket b  =  build rows [b*SPb, (b+1)*SPb)  of the key-sorted side.

The build side needs no slot fill: its plain key sort reshaped to
[B, SPb] is the partition, and every bucket holds exactly SPb rows.  Each
bucket row is prefixed by an H-row halo (the previous bucket's tail), so a
key run that straddles a bucket edge is still compared in one bucket.  The
probe side's plain sort is bucket-grouped already (quantile assignment
preserves order); its starts are ranks of the quantiles, and the slot fill
(K4) lays it out as in the radix member.  The dual-count kernel (K5)
compares the [B, H + SPb] build matrix with the [B, SPp] probe matrix.

A key multiplicity past H, a probe bucket past its slots, or a live key
2^64-1 (it aliases the pad key in the quantile vector) sends the join to
the radix member's exact sorted-merge branch.  The JAX package decides
that on the device inside a `lax.cond`; here it costs ONE host read per
forced qd join (the JAX version has none).  `BRANCHES` counts which
branch served.

Not carried over: the u32 limb matrices (one int64 halo matrix), the
key32 path and the plan's VMEM guard (the port's K5 has no such limit at
these widths: its shared-memory bound is on build slots per bucket,
SPb + H).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .radix_join import (ALIGN, MAX_SLOTS, PROBE_MAX_BUILD_SLOTS,
                         _as_count, _bump, _merge_on_sorted, _weighted_sums,
                         _windows, probe_counts, slot_fill)
from .select import Count, live_mask
from .u64 import PAD, ranks_u64, sort_u64

BRANCHES = {"kernel": 0, "merge": 0}


def qd_static_plan(Pb: int, Pp: int, SPb: int = 256,
                   H: int = 64) -> Tuple[int, int, int]:
    """(SPb, H, SPp) from the padded sizes: build bucket depth SPb (exact
    occupancy), halo H (the key multiplicity the kernel branch takes),
    probe slot width with the radix member's 2x margin and ALIGN slack.
    The JAX package's numbers."""
    from ..utils.padding import size_class

    SPb = min(SPb, Pb)
    while Pb % SPb:
        SPb //= 2
    B = Pb // SPb
    H = min(H, SPb)
    expected_p = -(-Pp // B)
    SPp = min(size_class(max(2 * expected_p, ALIGN), ALIGN) + ALIGN,
              MAX_SLOTS + ALIGN)
    if SPb + H > PROBE_MAX_BUILD_SLOTS:
        raise ValueError(f"qd build row of {SPb + H} slots past the probe "
                         f"kernel's {PROBE_MAX_BUILD_SLOTS}")
    return SPb, H, SPp


def _sort_side(keys: torch.Tensor, vals: torch.Tensor, n: Count):
    """One stable sort of the keys with pads forced to 2^64-1 behind the
    live prefix, carrying the value columns [V, P]: (keys_s, vals_s)."""
    live = live_mask(keys.shape[0], n, keys.device)
    ks, perm = sort_u64(torch.where(live, keys, PAD))
    return ks, vals.index_select(1, perm)


def _pstarts(kp: torch.Tensor, qb: torch.Tensor, n_p: Count) -> torch.Tensor:
    """Probe start of each quantile bucket: rank of the quantile in the
    sorted probe keys, clamped to the live count."""
    return torch.clamp(ranks_u64(kp, qb, "left"), max=n_p)


def _max_run_length(ks: torch.Tensor, n: Count) -> torch.Tensor:
    """Longest equal-key run in the live prefix of sorted `ks` (0-d)."""
    P = ks.shape[0]
    idx = torch.arange(P, device=ks.device)
    live = idx < n
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=ks.device),
                      ks[1:] == ks[:-1]]) & live
    start = torch.cummax(torch.where(same, 0, idx), 0).values
    return torch.where(live, idx - start + 1, 0).max()


def _halo_mat(ks: torch.Tensor, B: int, SPb: int, H: int) -> torch.Tensor:
    """Build matrix [B, H + SPb]: bucket b's SPb sorted keys prefixed by
    the last H keys of bucket b-1.  Bucket 0's halo is filler, outside
    its window."""
    main = ks.reshape(B, SPb)
    halo = torch.cat([torch.full((1, H), PAD, dtype=ks.dtype,
                                 device=ks.device), main[:-1, SPb - H:]])
    return torch.cat([halo, main], 1).contiguous()


def _qd_body(kb, vb, n_b: Count, kp, vp, n_p: Count, *, B: int, SPb: int,
             H: int, SPp: int):
    """Kernel branch over two sorted sides."""
    Pb = kb.shape[0]
    dev = kb.device
    pstart = _pstarts(kp, kb[::SPb], n_p)
    pend = torch.cat([pstart[1:], _as_count(n_p, dev)])
    ct_p = torch.clamp(pend - pstart, min=0)
    mats_p = slot_fill(pstart.to(torch.int32), ct_p.to(torch.int32),
                       [kp, *vp], SPp)                 # [1 + Vp, B, SPp]

    # Build windows [0 or H, H + live rows of the bucket): bucket 0's halo
    # is filler; every other halo row is a real match candidate (each key's
    # probe rows all land in one bucket, so nothing counts twice).
    b = torch.arange(B, device=dev)
    lo_b = torch.where(b == 0, H, 0)
    live_main = torch.clamp(_as_count(n_b, dev) - b * SPb, 0, SPb)
    mc, pc = probe_counts(_halo_mat(kb, B, SPb, H),
                          _windows(lo_b, H + live_main), mats_p[0],
                          _windows(torch.zeros_like(ct_p), ct_p))

    # Fold the halo counts onto their rows: halo slot j of bucket b is
    # sorted row b*SPb - H + j, the tail of bucket b-1.
    mc_main = mc[:, H:].to(torch.int64)
    mc_main[:-1, SPb - H:] += mc[1:, :H]
    cnt_rows = mc_main.reshape(Pb)
    return (cnt_rows.sum(), (cnt_rows[None, :] * vb).sum(1),
            _weighted_sums(pc, mats_p[1:]))


def qd_fused_static(keys_b, vals_b, n_b: Count, keys_p, vals_p, n_p: Count,
                    *, SPb: int, H: int, SPp: int):
    """Fused equi-depth join (count, sums_build [Vb], sums_probe [Vp]),
    exact wrap-around u64, sized by qd_static_plan.

    Why the halo suffices: let j be the last bucket whose quantile
    qb[j] <= k for a live probe key k.  Its match range [lo, hi) in the
    sorted build has hi <= (j+1)*SPb, and lo >= j*SPb - H + 1 when the
    multiplicity hi - lo <= H, so bucket j's window [j*SPb - H,
    (j+1)*SPb) covers every match and no other bucket sees key k.  A
    multiplicity past H, a probe bucket past SPp - ALIGN, or a live key
    2^64-1 takes the merge branch (one host read decides; BRANCHES counts
    it)."""
    kb, vb = _sort_side(keys_b, vals_b, n_b)
    kp, vp = _sort_side(keys_p, vals_p, n_p)
    Pb = kb.shape[0]
    B = Pb // SPb

    pstart = _pstarts(kp, kb[::SPb], n_p)
    pend = torch.cat([pstart[1:], _as_count(n_p, kb.device)])
    probe_occ = torch.clamp(pend - pstart, min=0).max()

    def has_max(ks, n):
        return (live_mask(ks.shape[0], n, ks.device) & (ks == PAD)).any()

    overflow = ((_max_run_length(kb, n_b) > H) | (probe_occ > SPp - ALIGN)
                | has_max(kb, n_b) | has_max(kp, n_p))
    if bool(overflow):  # the one host read
        branch = "merge"
        out = _merge_on_sorted(kb, vb, n_b, kp, vp, n_p)
    else:
        branch = "kernel"
        out = _qd_body(kb, vb, n_b, kp, vp, n_p, B=B, SPb=SPb, H=H, SPp=SPp)
    _bump(BRANCHES, branch)
    return out
