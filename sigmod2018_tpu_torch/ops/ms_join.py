"""Merge-staircase join: match counts between two SORTED sides.

Counterpart of `sigmod2018_tpu/ops/ms_join.py`.  Both sides of an
at-scale join are sorted by key; one kernel then gives, per sorted probe
row, the number of equal build keys and the first one's position.  That
serves two engine paths:

- intermediate joins (`join_probe_count_ms`): counts and ranges per raw
  probe row, so ops.sort_join.join_emit expands them unchanged;
- fused final joins (`ms_fused`): two passes with the roles swapped give
  per-row counts for BOTH sides, which weight the original value columns
  (the kernel never touches values).

`staircase_counts` is the kernel's wrapper: on a CUDA tensor it launches
csrc/stair_counts.cu (hand-written for Hopper; see that file for the
design and what bounds it), on a CPU tensor it runs
`staircase_counts_plain`, the same contract in plain PyTorch.  Which one
runs is decided only by the tensors' device.

The TPU kernel's layout machinery is not carried over: no [Pb, 1, 1]
relayout, no 2^23 build split (`MS_BCAST_MAX_ROWS`), no step plan or cap
ladder with its searchsorted fallback — the CUDA kernel serves any
Pb < 2^31 in one launch and has no step cap.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from ..config import env_int
from .select import Count, live_mask
from .sort_join import _ccum_total, join_build, join_probe_count
from .u64 import flip

# CUDA kernel launches since the last reset (the plain twin does not
# count): a call launches two, the bounds pass and the merge pass, or the
# merge pass alone when host counts leave no live row.  Incremented under
# _count_lock: the protocol driver dispatches a batch's queries from
# several threads.
LAUNCHES = 0
_count_lock = threading.Lock()

# Emitting-path crossover: intermediate joins whose padded sizes reach
# this take the staircase counting member instead of searchsorted ranks
# (tools/bench_probe.py measures the crossover on the card).  Read at
# import, as the JAX package reads it: S18_EMIT_MS_MIN overrides, 0 or
# less sends every size to the staircase.  The JAX package's
# S18_EMIT_MS_FORCE has no counterpart: it only sent at-scale counts off
# the TPU into Pallas interpret mode, and here the tensors' device alone
# picks the kernel or its plain twin, so the port always routes as the
# JAX package does under S18_EMIT_MS_FORCE=1.
EMIT_MS_MIN_ROWS = env_int("S18_EMIT_MS_MIN", 1 << 18)

_MAX_ROWS = (1 << 31) - 1024  # int32 row indices inside the kernel


def _check_count(n: Count, P: int, device: torch.device) -> None:
    if isinstance(n, torch.Tensor):
        if (n.dim() != 0 or n.device != device
                or n.dtype not in (torch.int32, torch.int64)):
            raise ValueError(f"live count must be an int or a 0-d int "
                             f"tensor on {device}: {n!r}")
    elif not 0 <= n <= P:
        raise ValueError(f"live count {n} outside [0, {P}]")


def _check(kb: torch.Tensor, n_b: Count, kp: torch.Tensor,
           n_p: Count) -> None:
    for name, t in (("kb", kb), ("kp", kp)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous 1-D int64 "
                             f"tensor of u64 keys, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.shape[0] > _MAX_ROWS:
            raise ValueError(f"{name}: {t.shape[0]} rows past the "
                             f"kernel's int32 row index")
    if kb.device != kp.device or kb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kb on {kb.device}, kp on {kp.device}: expected "
                         f"both on the CPU or both on one CUDA device")
    _check_count(n_b, kb.shape[0], kb.device)
    _check_count(n_p, kp.shape[0], kb.device)


def staircase_counts_plain(kb: torch.Tensor, n_b: Count, kp: torch.Tensor,
                           n_p: Count) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's contract in plain PyTorch: searchsorted of the
    flipped probe keys over the flipped live build prefix kb[:n_b], left
    and right; rows >= n_p get cnt 0.  (cnt, lo) int32."""
    fb = flip(kb[:int(n_b)])
    fp = flip(kp)
    lo = torch.searchsorted(fb, fp, side="left")
    hi = torch.searchsorted(fb, fp, side="right")
    live = live_mask(kp.shape[0], n_p, kp.device)
    cnt = torch.where(live, hi - lo, 0)
    return cnt.to(torch.int32), lo.to(torch.int32)


def _stair_lib():
    from ._kernels import load

    lib = load("stair_counts")
    fn = lib.s18_stair_counts
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, p, i, i, p, p, p, ctypes.c_longlong, p,
                       ctypes.POINTER(i)]
        fn.restype = ctypes.c_int
        lib.s18_stair_scratch_ints.argtypes = [i]
        lib.s18_stair_scratch_ints.restype = ctypes.c_longlong
        lib.s18_error_string.argtypes = [ctypes.c_int]
        lib.s18_error_string.restype = ctypes.c_char_p
    return lib


def _staircase_counts_cuda(kb, n_b: Count, kp, n_p: Count):
    global LAUNCHES
    lib = _stair_lib()
    dev = kb.device
    Pp = kp.shape[0]
    cnt = torch.empty(Pp, dtype=torch.int32, device=dev)
    lo = torch.empty(Pp, dtype=torch.int32, device=dev)
    if Pp == 0:
        return cnt, lo
    n_dev, nb, np_ = None, 0, 0
    if isinstance(n_b, torch.Tensor) or isinstance(n_p, torch.Tensor):
        # a fill kernel, not a host->device copy: no sync
        n_dev = torch.stack([n.to(torch.int32)
                             if isinstance(n, torch.Tensor) else
                             torch.full((), n, dtype=torch.int32, device=dev)
                             for n in (n_b, n_p)])
    else:
        nb, np_ = int(n_b), int(n_p)
    scratch = torch.empty(lib.s18_stair_scratch_ints(Pp), dtype=torch.int32,
                          device=dev)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.s18_stair_counts(
            kb.data_ptr(), kb.shape[0], kp.data_ptr(), Pp,
            None if n_dev is None else n_dev.data_ptr(), nb, np_,
            cnt.data_ptr(), lo.data_ptr(), scratch.data_ptr(),
            scratch.shape[0], stream, ctypes.byref(launched))
    if err != 0:
        raise RuntimeError(f"stair_counts kernel launch failed: "
                           f"{lib.s18_error_string(err).decode()}")
    with _count_lock:
        LAUNCHES += launched.value
    return cnt, lo


def staircase_counts(kb: torch.Tensor, n_b: Count, kp: torch.Tensor,
                     n_p: Count) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per sorted probe row: (cnt, lo) int32 [Pp] against the sorted build.

    kb [Pb], kp [Pp]: u64 keys as int64, each sorted (unsigned) in its
    live prefix [0, n_b) / [0, n_p); n_b, n_p are ints or 0-d int tensors
    on the same device.  cnt[i] = #build keys equal to kp[i] (0 for
    i >= n_p), lo[i] = the first one's position in kb (unspecified where
    cnt == 0).  Liveness is by position, so a live 2^64-1 key is exact.

    CUDA tensors launch the hand-written kernel (or raise); CPU tensors
    run staircase_counts_plain.  Replaces the Pallas kernel
    sigmod2018_tpu/ops/ms_join.py::_stair_kernel.  On the card the kernel
    is bound by bytes: it reads the two sorted u64 arrays and writes two
    int32 per probe row.  A first launch finds, for every chunk of 1,024
    sorted probe rows, the build bounds of its first and last key (one
    warp a bound, into int32 scratch of the size the library gives); then
    one block a chunk answers rows of those two keys from the bounds and
    merges the rest against the build window between them, staged in
    shared memory.  The first launch is skipped when host counts leave no
    live row."""
    _check(kb, n_b, kp, n_p)
    if kb.device.type == "cpu":
        return staircase_counts_plain(kb, n_b, kp, n_p)
    return _staircase_counts_cuda(kb, n_b, kp, n_p)


def _unsort(perm: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x in sorted coordinates -> original coordinates: out[perm] = x."""
    out = torch.empty_like(x)
    out[perm] = x
    return out


def join_probe_count_ms(sorted_keys, n_build: Count, probe_keys,
                        n_probe: Count):
    """The ops/sort_join.py::join_probe_count contract on the staircase
    kernel: (lo, cnt, ccum, total) per RAW probe row, lo in sorted-build
    coordinates.  `sorted_keys`: the build side sorted by join_build;
    `probe_keys`: raw padded keys, sorted here."""
    kp_s, perm_p = join_build(probe_keys, n_probe)
    cnt_s, lo_s = staircase_counts(sorted_keys, n_build, kp_s, n_probe)
    cnt = _unsort(perm_p, cnt_s)
    return (_unsort(perm_p, lo_s), cnt, *_ccum_total(cnt))


def join_probe_count_auto(sorted_keys, n_build: Count, probe_keys,
                          n_probe: Count):
    """Size-dispatched emitting-count member: the staircase kernel at or
    past EMIT_MS_MIN_ROWS padded rows, searchsorted ranks below."""
    if max(sorted_keys.shape[0], probe_keys.shape[0]) >= EMIT_MS_MIN_ROWS:
        return join_probe_count_ms(sorted_keys, n_build, probe_keys,
                                   n_probe)
    return join_probe_count(sorted_keys, n_build, probe_keys, n_probe)


def ms_fused(keys_b, vals_b, n_b: Count, keys_p, vals_p, n_p: Count, *,
             presorted_b=None, presorted_p=None):
    """Fused staircase join + checksums: (count, sums_build [Vb],
    sums_probe [Vp]), exact wrap-around u64 (the agg_join contract).

    `presorted_*`: a side's prep-time (sorted_keys, perm) from join_build
    (engine device_sorted_column) skips that side's query-time sort."""
    kb_s, perm_b = (presorted_b if presorted_b is not None
                    else join_build(keys_b, n_b))
    kp_s, perm_p = (presorted_p if presorted_p is not None
                    else join_build(keys_p, n_p))
    cnt_p, _ = staircase_counts(kb_s, n_b, kp_s, n_p)
    count = cnt_p.sum(dtype=torch.int64)
    if vals_b.shape[0]:
        # per-BUILD-row counts: the same kernel with the roles swapped;
        # skipped when no view lives on the build side
        cnt_b, _ = staircase_counts(kp_s, n_p, kb_s, n_b)
        cb = _unsort(perm_b, cnt_b).to(torch.int64)
        sums_b = (cb[None, :] * vals_b).sum(1)
    else:
        sums_b = vals_b.new_zeros(0)
    if vals_p.shape[0]:
        cp = _unsort(perm_p, cnt_p).to(torch.int64)
        sums_p = (cp[None, :] * vals_p).sum(1)
    else:
        sums_p = vals_p.new_zeros(0)
    return count, sums_b, sums_p
