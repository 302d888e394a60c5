"""The radix member of the fused final join, the two kernels it shares
with the equi-depth member (ops/qd_join.py), and the fused-join dispatch.
Counterpart of `sigmod2018_tpu/ops/radix_join.py`.

The radix member (forced with `S18_JOIN=radix`):

  partition:  one stable sort per side of the bit-rotated key (the low
              `bits` key bits, the bucket, move to the top) carries the
              value columns; bucket starts are ranks of the bucket edges
  slot fill:  `slot_fill` copies bucket b's rows of each sorted array into
              row b of a [B, SP] matrix, slots [0, cnt_b) (kernel K4)
  probe:      `probe_counts` compares every live build slot of a bucket
              with every live probe slot and gives per-slot match counts
              of both sides in one pass (kernel K5)
  sums:       the counts weight the slot-filled value columns (the
              agg_join contract: exact wrap-around u64)

`slot_fill` and `probe_counts` are the kernels' wrappers: on CUDA tensors
they launch csrc/slot_fill.cu and csrc/probe_counts.cu (hand-written for
Hopper), on CPU tensors they run `slot_fill_plain` / `probe_counts_plain`,
the same contracts in plain PyTorch.  Which runs is decided only by the
tensors' device.

`radix_fused_static` sizes its slots from the padded input sizes alone.
Whether a bucket outgrew them is data: the JAX package decides it on the
device inside a `lax.cond`; eager PyTorch has no device-side branch, so
here it costs ONE host read of the occupancy flag per forced radix join
(the JAX version has none).  `BRANCHES` counts which branch served.  The
merge branch is the member's own exact sorted-merge, not a fallback.

Not carried over from the TPU kernels: the u32 hi/lo limb split and the
key32 single-limb path (keys stay int64 bit patterns), f32 counts, the
[S, B] lane-major layout (bucket-major [B, S] here), the VMEM super-group
split of `_counts_grouped` (one launch serves all buckets) and the
1024-aligned DMA start with `_pad_align` (a window starts at slot 0).
The slot widths keep the JAX plan's ALIGN slack so both packages size and
branch alike.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence, Tuple

import torch

from .agg_join import (join_checksum_fused, join_checksum_fused_presorted,
                       join_checksum_fused_table,
                       join_checksum_fused_table_pref)
from .ms_join import ms_fused
from .select import Count, live_mask
from .u64 import PAD, ranks_u64, sort_u64

ALIGN = 1024          # the JAX plan's per-row window slack (kept: same plans)
MAX_SLOTS = 1 << 13   # per-bucket slot cap of radix_join_checksum

# Fused joins whose larger padded side reaches this take the staircase
# member; forced radix builds prep artifacts for base columns this large.
RADIX_MIN_ROWS = 1 << 18

# Kernel launches since the last reset (plain-twin calls do not count),
# and which branch served each forced radix join.  Updated under
# _count_lock: run_protocol dispatches a batch from several threads.
LAUNCHES = {"slot_fill": 0, "probe_counts": 0}
BRANCHES = {"kernel": 0, "merge": 0}
_count_lock = threading.Lock()


def _bump(counter: dict, key: str) -> None:
    with _count_lock:
        counter[key] += 1


# ---------------------------------------------------------------------------
# Host-side plan (the JAX package's numbers)
# ---------------------------------------------------------------------------


def plan_bits(Pb: int) -> int:
    """The radix width static_radix_plan picks for a build side of padded
    size Pb (prep builds bits-matching artifacts with it)."""
    return max(6, min(14, (max(Pb // 512, 1) - 1).bit_length()))


def static_radix_plan(Pb: int, Pp: int) -> Tuple[int, int, int]:
    """(bits, SPb, SPp) from the padded sizes alone: ~512 expected build
    rows per bucket; each side's slot width carries a 2x occupancy margin
    plus ALIGN slack, capped at MAX_SLOTS + ALIGN."""
    from ..utils.padding import size_class

    bits = plan_bits(Pb)
    B = 1 << bits

    def sp(P: int) -> int:
        expected = -(-P // B)
        return min(size_class(max(2 * expected, ALIGN), ALIGN) + ALIGN,
                   MAX_SLOTS + ALIGN)

    return bits, sp(Pb), sp(Pp)


def choose_bits(n_build: int, n_probe: int) -> int:
    """radix_join_checksum's width: ~1024 build rows per bucket, clamped
    to [6, 14]."""
    target = max(n_build // 1024, 1)
    return max(6, min(14, (target - 1).bit_length()))


def radix_member_selected(Pb: int, Pp: int, algo: str) -> bool:
    """True iff fused_join_auto runs the radix member: only when forced."""
    return algo == "radix"


def ms_member_selected(Pb: int, Pp: int, algo: str) -> bool:
    """True iff fused_join_auto picks the staircase member for these
    padded sizes (the engine then skips the prefix-table member)."""
    return algo == "ms" or (algo == "auto" and RADIX_MIN_ROWS <= max(Pb, Pp))


# ---------------------------------------------------------------------------
# Sort side: rotated-key partition
# ---------------------------------------------------------------------------


def _rotate(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """Rotate u64 keys right by `bits`: the low bits (the bucket) move to
    the top, so one sort groups by bucket and orders by key inside it.
    Bijective, so equal rotated keys are equal keys.  `>>` on int64 is
    arithmetic, so the shifted-in sign bits are masked off."""
    if bits == 0:
        return keys
    return (keys << (64 - bits)) | ((keys >> bits) & ((1 << (64 - bits)) - 1))


def _as_count(n: Count, device) -> torch.Tensor:
    """A live count as an int64 [1] tensor on `device` (a fill, no sync)."""
    if isinstance(n, torch.Tensor):
        return n.to(torch.int64).reshape(1)
    return torch.full((1,), n, dtype=torch.int64, device=device)


def _bucket_starts(krot_s: torch.Tensor, n: Count,
                   bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(starts, cnts) int32 [B] of the buckets in the sorted rotated keys:
    starts are the ranks of the bucket edges b << (64 - bits), clamped to
    the live count n (pads and live 2^64-1 keys share the last bucket;
    the clamp keeps only the live ones)."""
    dev = krot_s.device
    edges = torch.arange(1 << bits, dtype=torch.int64, device=dev)
    if bits:
        edges = edges << (64 - bits)
    starts = torch.clamp(ranks_u64(krot_s, edges, "left"), max=n)
    ends = torch.cat([starts[1:], _as_count(n, dev)])
    return starts.to(torch.int32), (ends - starts).to(torch.int32)


def _sort_rotated(keys: torch.Tensor, n: Count, bits: int):
    """(krot_sorted, perm int64): one stable sort of the rotated keys
    with pads forced to 2^64-1 behind the live prefix (stability keeps a
    live 2^64-1 key ahead of them)."""
    live = live_mask(keys.shape[0], n, keys.device)
    return sort_u64(torch.where(live, _rotate(keys, bits), PAD))


def radix_prep_keys(keys: torch.Tensor, n: Count, bits: int):
    """Prep-time half of _prep_side for a base column: (krot_sorted [P],
    perm [P] int64, starts [B] int32, cnts [B] int32, max_occ int32 0-d).
    The perm pre-sorts the column's value columns (engine
    device_radix_val); the artifacts serve only joins whose plan_bits
    equals `bits`."""
    krot_s, perm = _sort_rotated(keys, n, bits)
    starts, cnts = _bucket_starts(krot_s, n, bits)
    return krot_s, perm, starts, cnts, cnts.max()


def _prep_side(keys: torch.Tensor, vals: torch.Tensor, n: Count, bits: int):
    """Sort one side by rotated key carrying its value columns [V, P]:
    (krot_sorted, vals_sorted, starts, cnts, max_occ)."""
    krot_s, perm, starts, cnts, max_occ = radix_prep_keys(keys, n, bits)
    return krot_s, vals.index_select(1, perm), starts, cnts, max_occ


# ---------------------------------------------------------------------------
# K4: slot fill
# ---------------------------------------------------------------------------


def _check_rows(name: str, t: torch.Tensor, dim: int, dtype) -> None:
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dim}-D {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def _check_device(tensors: Sequence[torch.Tensor]) -> torch.device:
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda") or any(t.device != dev
                                              for t in tensors):
        raise ValueError(f"expected every tensor on the CPU or on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    return dev


def _check_slot_fill(starts, cnts, srcs, SP: int) -> None:
    if not srcs:
        raise ValueError("slot_fill needs at least one source array")
    _check_rows("starts", starts, 1, torch.int32)
    _check_rows("cnts", cnts, 1, torch.int32)
    if starts.shape != cnts.shape:
        raise ValueError(f"starts {tuple(starts.shape)} and cnts "
                         f"{tuple(cnts.shape)} differ")
    N = srcs[0].shape[0]
    for k, s in enumerate(srcs):
        _check_rows(f"srcs[{k}]", s, 1, torch.int64)
        if s.shape[0] != N:
            raise ValueError(f"srcs[{k}] has {s.shape[0]} rows, srcs[0] {N}")
    if not 0 < SP < 1 << 31:
        raise ValueError(f"slot width {SP} outside [1, 2^31)")
    _check_device([starts, cnts, *srcs])


def slot_fill_plain(starts: torch.Tensor, cnts: torch.Tensor,
                    srcs: Sequence[torch.Tensor], SP: int) -> torch.Tensor:
    """K4's contract in plain PyTorch: out[k, b, s] = srcs[k][starts[b] +
    s] for s < cnts[b] (and inside the source), else 0.  [K, B, SP]."""
    src = torch.stack(list(srcs))
    N = src.shape[1]
    s = torch.arange(SP, device=src.device)
    idx = starts.to(torch.int64)[:, None] + s[None, :]
    valid = (s[None, :] < cnts[:, None]) & (idx >= 0) & (idx < N)
    if N == 0:
        return torch.zeros((src.shape[0],) + tuple(idx.shape),
                           dtype=src.dtype, device=src.device)
    got = src[:, torch.clamp(idx, 0, N - 1)]
    return torch.where(valid[None], got, 0)


def _slot_fill_lib():
    from ._kernels import load

    lib = load("slot_fill")
    fn = lib.s18_slot_fill
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), i, ctypes.c_longlong,
                       p, p, i, i, p, p]
        fn.restype = ctypes.c_int
        lib.s18_slot_fill_max_sources.restype = ctypes.c_int
        lib.s18_error_string.argtypes = [ctypes.c_int]
        lib.s18_error_string.restype = ctypes.c_char_p
    return lib


def _slot_fill_cuda(starts, cnts, srcs, SP: int) -> torch.Tensor:
    lib = _slot_fill_lib()
    dev = starts.device
    K, B, N = len(srcs), starts.shape[0], srcs[0].shape[0]
    out = torch.empty((K, B, SP), dtype=torch.int64, device=dev)
    if B == 0:
        return out
    group = lib.s18_slot_fill_max_sources()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k0 in range(0, K, group):
            part = srcs[k0:k0 + group]
            ptrs = (ctypes.c_void_p * len(part))(*[s.data_ptr()
                                                   for s in part])
            err = lib.s18_slot_fill(ptrs, len(part), N, starts.data_ptr(),
                                    cnts.data_ptr(), B, SP,
                                    out[k0].data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"slot_fill kernel launch failed: "
                                   f"{lib.s18_error_string(err).decode()}")
            _bump(LAUNCHES, "slot_fill")
    return out


def slot_fill(starts: torch.Tensor, cnts: torch.Tensor,
              srcs: Sequence[torch.Tensor], SP: int) -> torch.Tensor:
    """Bucket slot fill: [K, B, SP] int64 with row b of array k holding
    srcs[k][starts[b] : starts[b] + cnts[b]] in slots [0, cnts[b]) and 0
    in every other slot.

    starts, cnts: int32 [B]; srcs: K contiguous int64 arrays [N] (u64 bit
    patterns), all on one device.  CUDA tensors launch csrc/slot_fill.cu
    (or raise); CPU tensors run slot_fill_plain.  Replaces the Pallas
    kernel sigmod2018_tpu/ops/radix_join.py::_slotfill_kernel.  Bound by
    bytes on the card: it reads the live rows once and writes the whole
    matrix, coalesced."""
    srcs = list(srcs)
    _check_slot_fill(starts, cnts, srcs, SP)
    if starts.device.type == "cpu":
        return slot_fill_plain(starts, cnts, srcs, SP)
    return _slot_fill_cuda(starts, cnts, srcs, SP)


# ---------------------------------------------------------------------------
# K5: per-bucket dual match counts
# ---------------------------------------------------------------------------

# Build slots per bucket row that K5 stages in shared memory: 12 bytes a
# slot (key + counter) within a block's 227 KB on sm_90.
PROBE_MAX_BUILD_SLOTS = 232448 // 12

# probe_counts_plain's [chunk, Sb, Sp] equality tensor stays near this.
_PLAIN_PAIRS = 1 << 28


def _check_probe(kb, wb, kp, wp) -> None:
    _check_rows("kb", kb, 2, torch.int64)
    _check_rows("kp", kp, 2, torch.int64)
    _check_rows("wb", wb, 2, torch.int32)
    _check_rows("wp", wp, 2, torch.int32)
    B = kb.shape[0]
    if kp.shape[0] != B or wb.shape != (B, 2) or wp.shape != (B, 2):
        raise ValueError(f"bucket counts differ: kb {tuple(kb.shape)}, kp "
                         f"{tuple(kp.shape)}, wb {tuple(wb.shape)}, wp "
                         f"{tuple(wp.shape)}")
    _check_device([kb, wb, kp, wp])


def _window_mask(w: torch.Tensor, S: int) -> torch.Tensor:
    s = torch.arange(S, device=w.device)
    lo = torch.clamp(w[:, :1], 0, S)
    hi = torch.clamp(w[:, 1:], 0, S)
    return (s[None, :] >= lo) & (s[None, :] < hi)


def probe_counts_plain(kb: torch.Tensor, wb: torch.Tensor, kp: torch.Tensor,
                       wp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's contract in plain PyTorch.  One host read of the largest
    window ends bounds the compare to the slots any window reaches; it is
    chunked over buckets so the [chunk, nb, np] equality tensor stays
    near 2^28 elements."""
    B, Sb = kb.shape
    Sp = kp.shape[1]
    mc = torch.zeros((B, Sb), dtype=torch.int32, device=kb.device)
    pc = torch.zeros((B, Sp), dtype=torch.int32, device=kb.device)
    if B == 0:
        return mc, pc
    hb, hp = torch.stack([torch.clamp(wb[:, 1], 0, Sb).max(),
                          torch.clamp(wp[:, 1], 0, Sp).max()]).tolist()
    mb, mp = _window_mask(wb, Sb)[:, :hb], _window_mask(wp, Sp)[:, :hp]
    chunk = max(1, _PLAIN_PAIRS // max(hb * hp, 1))
    for b0 in range(0, B, chunk):
        sl = slice(b0, b0 + chunk)
        eq = ((kb[sl, :hb, None] == kp[sl, None, :hp])
              & mb[sl, :, None] & mp[sl, None, :])
        mc[sl, :hb] = eq.sum(2, dtype=torch.int32)
        pc[sl, :hp] = eq.sum(1, dtype=torch.int32)
    return mc, pc


def _probe_lib():
    from ._kernels import load

    lib = load("probe_counts")
    fn = lib.s18_probe_counts
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, i, p, i, p, p, p]
        fn.restype = ctypes.c_int
        lib.s18_error_string.argtypes = [ctypes.c_int]
        lib.s18_error_string.restype = ctypes.c_char_p
    return lib


def _probe_counts_cuda(kb, wb, kp, wp):
    lib = _probe_lib()
    dev = kb.device
    (B, Sb), Sp = kb.shape, kp.shape[1]
    mc = torch.empty((B, Sb), dtype=torch.int32, device=dev)
    pc = torch.empty((B, Sp), dtype=torch.int32, device=dev)
    if B == 0 or Sb == 0 or Sp == 0:
        return mc.zero_(), pc.zero_()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.s18_probe_counts(kb.data_ptr(), Sb, wb.data_ptr(),
                                   kp.data_ptr(), Sp, wp.data_ptr(), B,
                                   mc.data_ptr(), pc.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"probe_counts kernel launch failed: "
                           f"{lib.s18_error_string(err).decode()}")
    _bump(LAUNCHES, "probe_counts")
    return mc, pc


def probe_counts(kb: torch.Tensor, wb: torch.Tensor, kp: torch.Tensor,
                 wp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bucket match counts of both sides in one pass.

    kb [B, Sb], kp [B, Sp]: each bucket's build / probe keys (int64 u64
    bit patterns, bucket-major); wb, wp: int32 [B, 2] live windows
    [lo, hi) of each row.  Returns (mc int32 [B, Sb], pc int32 [B, Sp]):
    mc[b, i] = #live probe slots of bucket b equal to kb[b, i], pc[b, j]
    = #live build slots equal to kp[b, j], 0 outside the windows.

    CUDA tensors launch csrc/probe_counts.cu (or raise); CPU tensors run
    probe_counts_plain.  Replaces the Pallas kernel
    sigmod2018_tpu/ops/radix_join.py::_probe_kernel.  On the card one
    block per bucket stages the build window in shared memory and scans
    it for the probe window: bound by the nb x np compares per bucket.
    Sb is limited to PROBE_MAX_BUILD_SLOTS."""
    _check_probe(kb, wb, kp, wp)
    if kb.shape[1] > PROBE_MAX_BUILD_SLOTS:
        raise ValueError(f"{kb.shape[1]} build slots per bucket past the "
                         f"kernel's shared-memory limit of "
                         f"{PROBE_MAX_BUILD_SLOTS}")
    if kb.device.type == "cpu":
        return probe_counts_plain(kb, wb, kp, wp)
    return _probe_counts_cuda(kb, wb, kp, wp)


def _windows(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int32 [B, 2] windows [lo, hi) for probe_counts."""
    return torch.stack([lo, hi], 1).to(torch.int32).contiguous()


def _weighted_sums(cnt: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """sum over slots of cnt [B, S] * mats[v] [B, S] for every v:
    wrap-around u64 [V]."""
    return (cnt.to(torch.int64)[None] * mats).sum((1, 2))


# ---------------------------------------------------------------------------
# Fused join + checksums (the agg_join contract)
# ---------------------------------------------------------------------------


def _radix_body(prep_b, prep_p, SPb: int, SPp: int):
    """Kernel branch: slot-fill both sides, count, weight."""
    kb, vb, st_b, ct_b = prep_b
    kp, vp, st_p, ct_p = prep_p
    mats_b = slot_fill(st_b, ct_b, [kb, *vb], SPb)  # [1 + Vb, B, SPb]
    mats_p = slot_fill(st_p, ct_p, [kp, *vp], SPp)
    zeros = torch.zeros_like(ct_b)
    mc, pc = probe_counts(mats_b[0], _windows(zeros, ct_b), mats_p[0],
                          _windows(zeros, ct_p))
    return (mc.sum(dtype=torch.int64), _weighted_sums(mc, mats_b[1:]),
            _weighted_sums(pc, mats_p[1:]))


def _merge_on_sorted(kb, vb, n_b: Count, kp, vp, n_p: Count):
    """Merge branch: fused checksums over two sides sorted in unsigned
    order (rotated or plain keys alike), values [V, P] in the same order.
    A probe row's match range is two ranks clamped to the live build
    prefix; the per-build-row counts are a difference array of the
    ranges."""
    lo = torch.clamp(ranks_u64(kb, kp, "left"), max=n_b)
    hi = torch.clamp(ranks_u64(kb, kp, "right"), max=n_b)
    live_p = live_mask(kp.shape[0], n_p, kp.device)
    lo = torch.where(live_p, lo, 0)
    hi = torch.where(live_p, hi, 0)  # dead probe rows: empty range
    cnt = hi - lo
    ones = torch.ones_like(lo)
    diff = torch.zeros(kb.shape[0] + 1, dtype=torch.int64, device=kb.device)
    diff.index_add_(0, lo, ones).index_add_(0, hi, -ones)
    mc = torch.cumsum(diff[:-1], 0)
    return (cnt.sum(), (mc[None, :] * vb).sum(1),
            (cnt[None, :] * vp).sum(1))


def radix_fused_static(keys_b, vals_b, n_b: Count, keys_p, vals_p,
                       n_p: Count, *, bits: int, SPb: int, SPp: int,
                       prep_b=None, prep_p=None):
    """Fused radix join with slot widths from static_radix_plan: (count,
    sums_build [Vb], sums_probe [Vp]), exact wrap-around u64.

    `prep_b` / `prep_p`: a side's prep-time (krot_sorted, starts, cnts,
    max_occ) from radix_prep_keys at the same bits; that side's vals_*
    must then be its values pre-sorted by the artifact's perm (engine
    device_radix_val) and its keys_* is unused.

    A bucket past its slots (occupancy > SP - ALIGN) sends the join to
    the merge branch.  Deciding that costs one host read; BRANCHES counts
    the outcome."""
    def side(keys, vals, n, pre):
        if pre is None:
            return _prep_side(keys, vals, n, bits)
        krot_s, st, ct, mo = pre
        return krot_s, vals, st, ct, mo

    kb, vb, st_b, ct_b, mo_b = side(keys_b, vals_b, n_b, prep_b)
    kp, vp, st_p, ct_p, mo_p = side(keys_p, vals_p, n_p, prep_p)
    over = torch.stack([mo_b.to(torch.int64) - (SPb - ALIGN),
                        mo_p.to(torch.int64) - (SPp - ALIGN)]).max()
    if int(over) > 0:  # the one host read
        _bump(BRANCHES, "merge")
        return _merge_on_sorted(kb, vb, n_b, kp, vp, n_p)
    _bump(BRANCHES, "kernel")
    return _radix_body((kb, vb, st_b, ct_b), (kp, vp, st_p, ct_p), SPb,
                       SPp)


def radix_join_checksum(keys_b, vals_b, n_b: Count, keys_p, vals_p,
                        n_p: Count, bits=None):
    """Fused radix join sized from the data: one host read of both sides'
    largest bucket picks the slot widths.  Raises ValueError when a
    bucket holds more than MAX_SLOTS rows (a key multiplicity past the
    dense bucket layout; the sort members serve such joins)."""
    from ..utils.padding import size_class

    if bits is None:
        bits = choose_bits(keys_b.shape[0], keys_p.shape[0])
    kb, vb, st_b, ct_b, mo_b = _prep_side(keys_b, vals_b, n_b, bits)
    kp, vp, st_p, ct_p, mo_p = _prep_side(keys_p, vals_p, n_p, bits)
    Sb, Sp = torch.stack([mo_b, mo_p]).tolist()  # the one host read
    if max(Sb, Sp) > MAX_SLOTS:
        raise ValueError(
            f"bucket overflow (build {Sb}, probe {Sp} rows/bucket at "
            f"bits={bits}): key multiplicity beyond dense-bucket "
            f"economics; use the sort path")
    SPb = size_class(max(Sb, 1), ALIGN) + ALIGN
    SPp = size_class(max(Sp, 1), ALIGN) + ALIGN
    return _radix_body((kb, vb, st_b, ct_b), (kp, vp, st_p, ct_p), SPb,
                       SPp)


def fused_join_auto(keys_b, vals_b, n_b, keys_p, vals_p, n_p,
                    algo: str = "auto", presorted=None, table=None,
                    table_prefs=None, radix_pre_b=None, radix_vals_b=None,
                    radix_pre_p=None, radix_vals_p=None, presorted_p=None):
    """The engine's fused-final-join entry: (count, sums_build [Vb],
    sums_probe [Vp]).

    The member is chosen by padded size alone, never by device: the
    staircase member (ops/ms_join.py) at scale, the table / sort members
    (ops/agg_join.py) below.  `algo` "sort", "ms", "radix" or "qd" forces
    one.

    `presorted` / `presorted_p`: a side's prep-time (sorted_keys, perm);
    `table`: the build side's prep-time (cumcnt rank table, perm);
    `table_prefs`: prefix tables of every build-side view ([V, Pb+1]),
    which make the table member probe-only (vals_b is then unused).
    `radix_pre_*` + `radix_vals_*`: a side's prep-time radix artifacts
    (krot_sorted, starts, cnts, max_occ) at bits == plan_bits(Pb) (the
    caller checks the match) and its pre-sorted [V, P] value stack;
    consumed only by the radix member."""
    if algo == "qd":
        from .qd_join import qd_fused_static, qd_static_plan

        SPb, H, SPp = qd_static_plan(keys_b.shape[0], keys_p.shape[0])
        return qd_fused_static(keys_b, vals_b, n_b, keys_p, vals_p, n_p,
                               SPb=SPb, H=H, SPp=SPp)
    if ms_member_selected(keys_b.shape[0], keys_p.shape[0], algo):
        return ms_fused(keys_b, vals_b, n_b, keys_p, vals_p, n_p,
                        presorted_b=presorted, presorted_p=presorted_p)
    if algo == "radix":
        bits, SPb, SPp = static_radix_plan(keys_b.shape[0], keys_p.shape[0])
        vb = vals_b if radix_pre_b is None else radix_vals_b
        vp = vals_p if radix_pre_p is None else radix_vals_p
        return radix_fused_static(keys_b, vb, n_b, keys_p, vp, n_p,
                                  bits=bits, SPb=SPb, SPp=SPp,
                                  prep_b=radix_pre_b, prep_p=radix_pre_p)
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
