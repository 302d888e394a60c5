"""Mesh SPMD join: hash shuffle over the shards + shard-local sort-join.

Counterpart of `sigmod2018_tpu/parallel/dist.py`, function by function,
with the same names and contracts, in plain PyTorch.  The JAX functions
are `shard_map` bodies over one shard's view; here the SPMD steps are
written in list-of-shards form: shard-local work is a loop over the
shards this process owns (`Mesh.local`, each tensor on its shard's
device), and the collectives of parallel/collectives.py sit between the
loops.  The `make_*` functions return the counterpart of the JAX
package's jitted programs: a function of per-shard input lists
(`row_sharding(mesh)` places a column) whose replicated outputs come
back as the first local shard's copy.

- Every row goes to shard `key mod ndev`, the unsigned remainder of its
  u64 key (int64 bit patterns, ops/u64.py), so the destinations are
  the JAX package's on any mesh size; dead rows go to the extra bucket
  ndev, which sends nothing.
- Send buffers are [ndev, cap] per shard.  The JAX package scatters
  each row to (destination, rank) and drops what falls outside; torch
  indexing has no dropping scatter, so the buffers are GATHERED instead:
  slot j of destination d takes the destination-sorted row starts[d] + j
  where j < min(count[d], cap), and a mask writes the pad key elsewhere.
  No row scatters into a spare slot, and no count is read to the host.
- The shard-local join is ops/agg_join.py's fused sort-join (stable
  sort of the live build keys, unsigned ranks), so a live key of 2^64-1
  still joins.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch

from .. import ops
from ..ops.u64 import PAD, flip, flip_scalar, ranks_u64, sort_u64
from .collectives import (all_gather, all_to_all, pmax, psum,
                          ring_all_to_all)
# AXIS, make_mesh and row_sharding are the JAX dist.py's names too
from .mesh import AXIS, Mesh, make_mesh, row_sharding  # noqa: F401

_PAD_KEY = PAD  # 2^64-1 as an int64 bit pattern
_LOW63 = (1 << 63) - 1

Count = Union[int, torch.Tensor]
Shards = List[torch.Tensor]


# ---------------------------------------------------------------------------
# Shard-local building blocks (one shard's tensors, no collective)
# ---------------------------------------------------------------------------


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    c = torch.cumsum(x, 0)
    return torch.cat([c.new_zeros(1), c[:-1]])


def _dest_of(keys: torch.Tensor, live: torch.Tensor,
             ndev: int) -> torch.Tensor:
    """Destination shard per row: the u64 key mod ndev (int64); dead
    rows go to the out-of-range bucket `ndev`.  The remainder of the
    unsigned value is ((k >>> 1) mod n * 2 + (k & 1)) mod n, the logical
    shift done as an arithmetic one with the sign bit cleared; a power
    of two only needs the low bits."""
    if ndev & (ndev - 1) == 0:
        d = keys & (ndev - 1)
    else:
        d = (((keys >> 1) & _LOW63) % ndev * 2 + (keys & 1)) % ndev
    return torch.where(live, d, ndev)


def _hist(dest: torch.Tensor, ndev: int) -> torch.Tensor:
    """Rows per destination, [ndev + 1] int64 (the last: dead rows).  A
    scatter-add, since torch.bincount reads its maximum to the host on
    a card."""
    return torch.zeros(ndev + 1, dtype=torch.int64,
                       device=dest.device).scatter_add_(
        0, dest, torch.ones_like(dest))


def send_hist_max(keys: torch.Tensor, live: torch.Tensor,
                  ndev: int) -> torch.Tensor:
    """This shard's largest per-destination send count, untruncated (0-d
    int64): a learned exchange cap below it dropped rows
    (dist_compiled.py validates learned caps with it)."""
    return _hist(_dest_of(keys, live, ndev), ndev)[:ndev].max()


def _partition(keys: torch.Tensor, payloads: Sequence[torch.Tensor],
               live: torch.Tensor, ndev: int, cap: int):
    """(send_keys [ndev, cap] pad-filled, send payloads [ndev, cap]
    zero-filled, hist [ndev + 1]): one stable sort by destination, then
    the gather of the module docstring."""
    L = keys.shape[0]
    dest = _dest_of(keys, live, ndev)
    _, order = torch.sort(dest, stable=True)
    hist = _hist(dest, ndev)
    slot = torch.arange(cap, device=keys.device)
    src = _exclusive_cumsum(hist)[:ndev, None] + slot[None, :]
    valid = slot[None, :] < hist[:ndev, None]
    rows = order[torch.clamp(src, max=max(L - 1, 0))]
    send_keys = torch.where(valid, keys[rows], _PAD_KEY)
    send_pay = tuple(torch.where(valid, p[rows], 0) for p in payloads)
    return send_keys, send_pay, hist


def partition_for_exchange(keys: torch.Tensor, payload: torch.Tensor,
                           live: torch.Tensor, ndev: int, cap: int):
    """Group a shard's live rows into [ndev, cap] per-destination send
    buffers.  Returns (send_keys, send_payload, counts [ndev] int32,
    overflow 0-d bool: some destination had more than cap rows)."""
    sk, (sp,), hist = _partition(keys, (payload,), live, ndev, cap)
    counts = torch.clamp(hist[:ndev], max=cap).to(torch.int32)
    return sk, sp, counts, (hist[:ndev] > cap).any()


def partition_multi(keys: torch.Tensor, payloads, live: torch.Tensor,
                    ndev: int, cap: int):
    """partition_for_exchange with a tuple of payload columns riding one
    destination sort: (send_keys, send_payloads, counts)."""
    sk, sp, hist = _partition(keys, tuple(payloads), live, ndev, cap)
    return sk, sp, torch.clamp(hist[:ndev], max=cap).to(torch.int32)


def _compact_received(recv_keys: torch.Tensor, recv_pays,
                      recv_cnt: torch.Tensor):
    """Received [ndev, cap] blocks, block s holding recv_cnt[s] live rows,
    into one live prefix of ndev * cap rows (keys pad-filled, payloads
    0): (keys, payloads, live count 0-d int64)."""
    ndev, cap = recv_keys.shape
    ends = torch.cumsum(recv_cnt.to(torch.int64), 0)
    t = torch.arange(ndev * cap, device=recv_keys.device)
    blk = torch.clamp(torch.searchsorted(ends, t, right=True), max=ndev - 1)
    valid = t < ends[-1]
    flat = torch.where(valid, blk * cap + t - (ends - recv_cnt)[blk], 0)
    keys = torch.where(valid, recv_keys.reshape(-1)[flat], _PAD_KEY)
    pays = tuple(torch.where(valid, p.reshape(-1)[flat], 0)
                 for p in recv_pays)
    return keys, pays, ends[-1]


def _transport(via: str):
    return ring_all_to_all if via == "ring" else all_to_all


def exchange_multi(mesh: Mesh, send_keys: Sequence[torch.Tensor],
                   send_pays, counts: Sequence[torch.Tensor],
                   via: str = "a2a"):
    """Exchange every shard's per-destination buffers (`via`: "a2a", the
    all_to_all, or "ring", its ppermute hops) and compact what each
    shard received.  Per-shard lists: (keys [ndev * cap], payload
    tuples, live counts)."""
    a2a = _transport(via)
    nloc = len(send_keys)
    recv_keys = a2a(mesh, send_keys)
    npay = len(send_pays[0]) if nloc else 0
    recv_pays = [a2a(mesh, [sp[i] for sp in send_pays])
                 for i in range(npay)]
    recv_cnt = a2a(mesh, [c[:, None] for c in counts])
    out = [_compact_received(recv_keys[s], [rp[s] for rp in recv_pays],
                             recv_cnt[s][:, 0]) for s in range(nloc)]
    return ([o[0] for o in out], [o[1] for o in out], [o[2] for o in out])


def exchange(mesh: Mesh, send_keys, send_pay, counts):
    """exchange_multi of one payload column over the all_to_all:
    per-shard lists (keys, payload, live count)."""
    keys, pays, n = exchange_multi(mesh, send_keys,
                                   [(p,) for p in send_pay], counts)
    return keys, [p[0] for p in pays], n


def local_join_checksum(bkeys: torch.Tensor, bvals: torch.Tensor,
                        n_build: Count, pkeys: torch.Tensor,
                        pvals: torch.Tensor, n_probe: Count):
    """Shard-local join with the checksum pushed into the probe: (count,
    sum of build values, sum of probe values) over the matching pairs,
    wrap-around u64 (0-d int64 each)."""
    count, sb, sp = local_join_checksum_multi(
        bkeys, bvals[None, :], n_build, pkeys, pvals[None, :], n_probe)
    return count, sb[0], sp[0]


def local_join_checksum_multi(bkeys, bcols, n_build: Count, pkeys, pcols,
                              n_probe: Count):
    """Shard-local fused join with V view columns per side ([V, P]):
    (count, sums_build [V], sums_probe [V]) — ops.join_checksum_fused."""
    return ops.join_checksum_fused(bkeys, bcols, n_build, pkeys, pcols,
                                   n_probe)


def _on(n: Count, device) -> Count:
    """A replicated live count on one shard's device."""
    return n.to(device) if isinstance(n, torch.Tensor) else n


def _global_live(L: int, s: int, n: Count, device) -> torch.Tensor:
    """Shard s's live mask of a row-sharded column with a global live
    prefix of n rows (shard s, a global index, owns rows [sL, (s+1)L))."""
    return (s * L + torch.arange(L, device=device)) < _on(n, device)


def _top_k_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, ties by lower index
    (jax.lax.top_k's order)."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def _stable_argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x.to(torch.int8), stable=True).indices


def _shards(mesh: Mesh, xs: Sequence) -> int:
    """The mesh's size, after checking that xs holds one tensor per
    shard this process owns."""
    if len(xs) != len(mesh.local):
        raise ValueError(f"{len(xs)} shards for the {len(mesh.local)} "
                         f"local shards of a mesh of {mesh.size}")
    return mesh.size


# ---------------------------------------------------------------------------
# End-to-end SPMD programs
# ---------------------------------------------------------------------------


def make_dist_join_checksum(mesh: Mesh, cap: int):
    """filter -> hash shuffle -> local join -> psum: the program of a
    one-join query, SELECT SUM(r.b), SUM(s.c) FROM r, s WHERE r.a = s.a
    AND r.b > filter_const.  Returns (count, sum_build, sum_probe,
    overflow); overflow is nonzero iff a shard's send buffer truncated
    (cap too small), and the sums are then not to be trusted."""
    def run(r_key: Shards, r_val: Shards, s_key: Shards, s_val: Shards,
            filter_const: int):
        ndev = _shards(mesh, r_key)
        fc = flip_scalar(int(filter_const))
        live_r = [flip(v) > fc for v in r_val]
        pr = [partition_for_exchange(k, v, lv, ndev, cap)
              for k, v, lv in zip(r_key, r_val, live_r)]
        ps = [partition_for_exchange(k, v, torch.ones(
            k.shape[0], dtype=torch.bool, device=k.device), ndev, cap)
              for k, v in zip(s_key, s_val)]
        bk, bv, nb = exchange(mesh, *[[p[i] for p in pr]
                                      for i in range(3)])
        pk, pv, npr = exchange(mesh, *[[p[i] for p in ps]
                                       for i in range(3)])
        res = [local_join_checksum(*a) for a in zip(bk, bv, nb, pk, pv, npr)]
        overflow = [(a[3] | b[3]).to(torch.int32) for a, b in zip(pr, ps)]
        return tuple(psum(mesh, [r[i] for r in res])[0]
                     for i in range(3)) + (psum(mesh, overflow)[0],)

    return run


def make_dist_join_parts(mesh: Mesh, cap: int):
    """The two halves of make_dist_join_checksum's cost: `comp_only` does
    the same per-shard work (filter, partition, local join, psum) with
    each shard's own send buffers flattened in place of the exchange;
    `comm_only` does only the partition and the exchange of both key
    columns."""
    def comp(r_key, r_val, s_key, s_val, filter_const):
        ndev = _shards(mesh, r_key)
        fc = flip_scalar(int(filter_const))
        res = []
        for rk, rv, sk, sv in zip(r_key, r_val, s_key, s_val):
            skr, spr, cr, _ = partition_for_exchange(rk, rv, flip(rv) > fc,
                                                     ndev, cap)
            sks, sps, cs, _ = partition_for_exchange(
                sk, sv, torch.ones(sk.shape[0], dtype=torch.bool,
                                   device=sk.device), ndev, cap)
            res.append(local_join_checksum(
                skr.reshape(-1), spr.reshape(-1), cr.sum(),
                sks.reshape(-1), sps.reshape(-1), cs.sum()))
        return tuple(psum(mesh, [r[i] for r in res])[0] for i in range(3))

    def comm(r_key, s_key):
        ndev = _shards(mesh, r_key)
        sides = []
        for keys in (r_key, s_key):
            parts = [partition_for_exchange(
                k, k, torch.ones(k.shape[0], dtype=torch.bool,
                                 device=k.device), ndev, cap)
                for k in keys]
            sides.append(exchange(mesh, *[[p[i] for p in parts]
                                          for i in range(3)]))
        (bk, _, nb), (pk, _, npr) = sides
        return psum(mesh, [b[0] + p[0] + x + y
                           for b, p, x, y in zip(bk, pk, nb, npr)])[0]

    return comp, comm


def make_fused_shuffle_join(mesh: Mesh, cap: int, n_views: int):
    """The mesh's fused final join: hash-shuffle both sides (keys and
    n_views view columns each), shard-local multi-view join and
    checksums, psum'd packed [1 + n_views] result (count, then per view
    sums_build + sums_probe: a view lives on one side, the other side's
    column is zeros).  Inputs: row-sharded global padded keys [L] and
    view columns [V, L] per shard, and replicated global live counts."""
    def run(bk: Shards, bcols: Shards, n_b: Count, pk: Shards,
            pcols: Shards, n_p: Count):
        ndev = _shards(mesh, bk)
        sides = []
        for keys, cols, n in ((bk, bcols, n_b), (pk, pcols, n_p)):
            parts = [partition_multi(
                k, tuple(c), _global_live(k.shape[0], s, n, k.device),
                ndev, cap) for s, k, c in zip(mesh.local, keys, cols)]
            sides.append(exchange_multi(mesh, *[[p[i] for p in parts]
                                                for i in range(3)]))
        (kb, vb, nb), (kp, vp, npr) = sides
        packed = []
        for s in range(len(kb)):
            count, sums_b, sums_p = local_join_checksum_multi(
                kb[s], _stack(vb[s], kb[s]), nb[s],
                kp[s], _stack(vp[s], kp[s]), npr[s])
            packed.append(torch.cat([count.reshape(1), sums_b + sums_p]))
        return psum(mesh, packed)[0]

    return run


def _stack(cols, like: torch.Tensor) -> torch.Tensor:
    """[V, P] view columns, [0, P] for none."""
    if cols:
        return torch.stack(cols)
    return like.new_zeros(0, like.shape[0])


def make_shuffle_caps(mesh: Mesh):
    """Both sides' largest per-(source, destination) row count in one
    [2] int64 result (one host read sizes make_fused_shuffle_join's
    cap)."""
    def one(keys: Shards, n: Count) -> torch.Tensor:
        ndev = _shards(mesh, keys)
        return pmax(mesh, [send_hist_max(
            k, _global_live(k.shape[0], s, n, k.device), ndev)
            for s, k in zip(mesh.local, keys)])[0]

    def run(bk: Shards, n_b: Count, pk: Shards, n_p: Count):
        return torch.stack([one(bk, n_b), one(pk, n_p)])

    return run


def make_exchange_counts(mesh: Mesh):
    """The first pass of a two-phase shuffle: the largest number of rows
    any shard sends to any one shard (every row live)."""
    def run(keys: Shards) -> torch.Tensor:
        ndev = _shards(mesh, keys)
        return pmax(mesh, [send_hist_max(k, torch.ones(k.shape[0],
                                                       dtype=torch.bool,
                                                       device=k.device),
                                         ndev)
                           for k in keys])[0]

    return run


def _local_key_counts(keys: torch.Tensor, live: torch.Tensor):
    """Per row, the multiplicity of its key within the shard's live rows
    (int32), and a mask of each key's first live occurrence."""
    k = torch.where(live, keys, _PAD_KEY)
    sk, perm = sort_u64(k)
    cnt = torch.where(live, ranks_u64(sk, k, "right")
                      - ranks_u64(sk, k, "left"), 0).to(torch.int32)
    first_sorted = torch.cat([torch.ones(1, dtype=torch.bool,
                                         device=k.device), sk[1:] != sk[:-1]])
    first = torch.zeros_like(live)
    first[perm] = first_sorted
    return cnt, first & live


def make_dist_join_checksum_skew(mesh: Mesh, cap: int, hot_k: int = 16,
                                 hot_cap: int = 256,
                                 hot_threshold: int = 4):
    """make_dist_join_checksum with a heavy-hitter split:

      1. each shard's top hot_k keys by local multiplicity, on both key
         columns, are all_gather'ed; psum'd exact global counts keep the
         keys whose rows, routed to one shard, would pass 1/hot_threshold
         of a shard's row share of that side;
      2. build rows of those keys (at most hot_cap per shard) are
         all_gather'ed to every shard;
      3. probe rows of those keys stay and join the gathered rows there;
      4. every other row takes the hash shuffle and the local join.

    The fourth output is nonzero iff a shard had more than hot_cap hot
    build rows or a cold send buffer truncated."""
    def run(r_key: Shards, r_val: Shards, s_key: Shards, s_val: Shards,
            filter_const: int):
        ndev = _shards(mesh, r_key)
        fc = flip_scalar(int(filter_const))
        live_r = [flip(v) > fc for v in r_val]
        live_s = [torch.ones(k.shape[0], dtype=torch.bool, device=k.device)
                  for k in s_key]

        # --- 1. heavy hitters of both key columns ----------------------
        def side_candidates(keys, live):
            cnt, first = _local_key_counts(keys, live)
            score = torch.where(first, cnt, 0)
            idx = _top_k_indices(score, hot_k)
            return torch.where(score[idx] > 0, keys[idx], _PAD_KEY)

        g_r = all_gather(mesh, [side_candidates(k, lv)
                                for k, lv in zip(r_key, live_r)])
        g_s = all_gather(mesh, [side_candidates(k, lv)
                                for k, lv in zip(s_key, live_s)])
        all_cand = [sort_u64(torch.cat([a.reshape(-1), b.reshape(-1)]))[0]
                    for a, b in zip(g_r, g_s)]

        def global_counts(keys, live):
            local = []
            for k, lv, cand in zip(keys, live, all_cand):
                skl, _ = sort_u64(torch.where(lv, k, _PAD_KEY))
                local.append((ranks_u64(skl, cand, "right")
                              - ranks_u64(skl, cand, "left")).to(
                    torch.int32))
            return psum(mesh, local)

        gc_r = global_counts(r_key, live_r)
        gc_s = global_counts(s_key, live_s)
        share_r = max(1, r_key[0].shape[0] // max(1, hot_threshold))
        share_s = max(1, s_key[0].shape[0] // max(1, hot_threshold))

        hot_r, hot_s, hot_over, hk, hv = [], [], [], [], []
        for s in range(len(r_key)):
            cand = all_cand[s]
            dup = torch.cat([torch.zeros(1, dtype=torch.bool,
                                         device=cand.device),
                             cand[1:] == cand[:-1]])
            heavy = ((cand != _PAD_KEY) & ~dup
                     & ((gc_r[s] > share_r) | (gc_s[s] > share_s)))
            score = torch.where(heavy, torch.maximum(gc_r[s], gc_s[s]), 0)
            idx = _top_k_indices(score, hot_k)
            hot_keys, _ = sort_u64(torch.where(score[idx] > 0, cand[idx],
                                               _PAD_KEY))

            def is_hot(keys, live):
                pos = torch.clamp(ranks_u64(hot_keys, keys, "left"),
                                  max=hot_k - 1)
                return (hot_keys[pos] == keys) & (keys != _PAD_KEY) & live

            hot_r.append(is_hot(r_key[s], live_r[s]))
            hot_s.append(is_hot(s_key[s], live_s[s]))
            # --- 2. the hot build rows, at most hot_cap per shard -------
            hot_over.append(hot_r[s].sum() > hot_cap)
            hp = _stable_argsort(~hot_r[s])[:hot_cap]
            sel = hot_r[s][hp]
            hk.append(torch.where(sel, r_key[s][hp], _PAD_KEY))
            hv.append(torch.where(sel, r_val[s][hp], 0))
        gk_all, gv_all = all_gather(mesh, hk), all_gather(mesh, hv)

        # --- 3. hot probe rows join the gathered rows in place ---------
        t_h = []
        for s in range(len(r_key)):
            gk, gv = gk_all[s].reshape(-1), gv_all[s].reshape(-1)
            n_hot_build = (gk != _PAD_KEY).sum()
            order = _stable_argsort(gk == _PAD_KEY)
            t_h.append(local_join_checksum(
                gk[order], gv[order], n_hot_build,
                torch.where(hot_s[s], s_key[s], _PAD_KEY),
                torch.where(hot_s[s], s_val[s], 0), s_key[s].shape[0]))

        # --- 4. the cold rows take the shuffle -------------------------
        pr = [partition_for_exchange(k, v, lv & ~h, ndev, cap)
              for k, v, lv, h in zip(r_key, r_val, live_r, hot_r)]
        ps = [partition_for_exchange(k, v, lv & ~h, ndev, cap)
              for k, v, lv, h in zip(s_key, s_val, live_s, hot_s)]
        bk, bv, nb = exchange(mesh, *[[p[i] for p in pr]
                                      for i in range(3)])
        pk, pv, npr = exchange(mesh, *[[p[i] for p in ps]
                                       for i in range(3)])
        t_c = [local_join_checksum(*a) for a in zip(bk, bv, nb, pk, pv, npr)]
        overflow = [(o | a[3] | b[3]).to(torch.int32)
                    for o, a, b in zip(hot_over, pr, ps)]
        return tuple(psum(mesh, [h[i] + c[i]
                                 for h, c in zip(t_h, t_c)])[0]
                     for i in range(3)) + (psum(mesh, overflow)[0],)

    return run


def make_dist_checksum(mesh: Mesh):
    """Wrap-around u64 SUM of a row-sharded column."""
    def run(col: Shards) -> torch.Tensor:
        _shards(mesh, col)
        return psum(mesh, [c.sum() for c in col])[0]

    return run

