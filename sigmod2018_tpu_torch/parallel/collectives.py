"""The collectives that `shard_map` supplies in the JAX package.

Each takes one tensor per shard (element s on shard s's device) and
returns one tensor per shard, on the same devices: the list-of-shards
form of `jax.lax.all_to_all`, `all_gather`, `psum`, `pmax` and
`ppermute` over the mesh axis.  Every output is a fresh tensor, also
where two shards share a device (`Tensor.to` of a tensor already on the
target device returns the tensor itself, which a later in-place write
would then change for the sender too).  Rows cross devices as device
copies (peer copies between cards); on one card they are copies within
it.

`CALLS` counts the calls of each kind (a ring exchange counts its
ppermute hops), like the kernels' launch counts.  Incremented under a
lock: the protocol driver dispatches a batch from several threads.
"""

from __future__ import annotations

import threading
from typing import List, Sequence, Tuple

import torch

KINDS = ("all_to_all", "all_gather", "psum", "pmax", "ppermute")
CALLS = dict.fromkeys(KINDS, 0)
_count_lock = threading.Lock()

Shards = List[torch.Tensor]


def _count(kind: str) -> None:
    with _count_lock:
        CALLS[kind] += 1


def reset_calls() -> None:
    with _count_lock:
        for k in CALLS:
            CALLS[k] = 0


def all_to_all(xs: Sequence[torch.Tensor]) -> Shards:
    """Split axis 0 and concatenate on axis 0: row s of the output on
    shard d is row d of shard s's input ([ndev, ...] on every shard)."""
    _count("all_to_all")
    return [torch.stack([x[d].to(y.device) for x in xs])
            for d, y in enumerate(xs)]


def all_gather(xs: Sequence[torch.Tensor]) -> Shards:
    """Every shard gets the [ndev, ...] stack of all shards' inputs."""
    _count("all_gather")
    return [torch.stack([x.to(y.device) for x in xs]) for y in xs]


def _reduce(xs: Sequence[torch.Tensor], op) -> Shards:
    acc = torch.stack([x.to(xs[0].device) for x in xs])
    total = op(acc)
    return [total.to(x.device, copy=True) for x in xs]


def psum(xs: Sequence[torch.Tensor]) -> Shards:
    """Sum over the shards, replicated; int64 wraps around mod 2^64 (the
    u64 bit patterns of ops/u64.py)."""
    _count("psum")
    return _reduce(xs, lambda a: a.sum(0, dtype=a.dtype))


def pmax(xs: Sequence[torch.Tensor]) -> Shards:
    """Elementwise maximum over the shards, replicated."""
    _count("pmax")
    return _reduce(xs, lambda a: a.amax(0))


def ppermute(xs: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> Shards:
    """Shard dst receives shard src's tensor for each (src, dst) of
    `perm`; a shard that receives nothing gets zeros."""
    _count("ppermute")
    out = [torch.zeros_like(x) for x in xs]
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device, copy=True)
    return out


def ring_all_to_all(xs: Sequence[torch.Tensor]) -> Shards:
    """`all_to_all`'s contract in ndev - 1 neighbour-distance hops of
    ppermute (the JAX package's `_ring_all_to_all`): hop k moves each
    shard's row for its distance-k peer, so every step sends one row per
    shard and no link carries the whole fanout."""
    ndev = len(xs)
    rows = [[None] * ndev for _ in range(ndev)]
    for me in range(ndev):
        rows[me][me] = xs[me][me].clone()
    for k in range(1, ndev):
        perm = [(i, (i + k) % ndev) for i in range(ndev)]
        got = ppermute([xs[i][(i + k) % ndev] for i in range(ndev)], perm)
        for me in range(ndev):  # arrives from (me - k) % ndev
            rows[me][(me - k) % ndev] = got[me]
    return [torch.stack(r) for r in rows]
