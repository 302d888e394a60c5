"""The collectives that `shard_map` supplies in the JAX package.

Each takes the mesh (the counterpart of the JAX collectives' axis name)
and one tensor per shard that this process owns (element i on the
device of shard `mesh.local[i]`), and returns one tensor per such
shard, on the same devices: the list-of-shards form of
`jax.lax.all_to_all`, `all_gather`, `psum`, `pmax` and `ppermute` over
the mesh axis.  Every output is a fresh tensor, also where two shards
share a device (`Tensor.to` of a tensor already on the target device
returns the tensor itself, which a later in-place write would then
change for the sender too).

The mesh alone says how its shards split over processes
(`Mesh.world`, `Mesh.rank`; parallel/mesh.py).  On a mesh of one
process rows cross devices as device copies (peer copies between
cards; on one card, copies within it).  On a mesh of W processes each
rank passes its n/W shards, host-major, and the part between processes
runs on this process's group (parallel/multihost.py), which must be
the mesh's: all_to_all_single with equal splits, all_gather,
all_reduce (SUM, MAX) after a reduce over the local shards, and
send/receive pairs for ppermute.  The transport is gloo with every
tensor staged through host memory here (`.cpu()` before, `.to(device)`
after), so one path runs on CPU meshes and between ranks that share a
card.  Every rank must call the same collectives in the same order
with tensors of the same shapes; an error of the group propagates.

`CALLS` counts the calls of each kind in this process (a ring exchange
counts its ppermute hops), like the kernels' launch counts.  Incremented
under a lock: the protocol driver dispatches a batch from several
threads when there is no process group.
"""

from __future__ import annotations

import threading
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh, process_group

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


def _layout(mesh: Mesh, xs: Sequence[torch.Tensor]) -> int:
    """The global index of this process's first shard of `mesh`, after
    checking that xs holds one tensor per local shard and that a mesh of
    several processes is this process's group's."""
    if len(xs) != len(mesh.local):
        raise ValueError(f"{len(xs)} tensors for the {len(mesh.local)} "
                         f"local shards of a mesh of {mesh.size}")
    if mesh.world > 1 and process_group() != (mesh.rank, mesh.world):
        raise RuntimeError(f"a mesh of rank {mesh.rank} of {mesh.world} "
                           f"processes, but this process's group is "
                           f"{process_group()} (rank, world size)")
    return mesh.local[0]


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A tensor as gloo sends it: on the host, contiguous, bool as
    uint8."""
    h = t.detach().to("cpu")
    return (h.to(torch.uint8) if h.dtype == torch.bool else h).contiguous()


def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A fresh copy of host tensor h with like's dtype on like's
    device."""
    return h.to(device=like.device, dtype=like.dtype, copy=True)


def a2a_stage(mesh: Mesh, xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """all_to_all's first part on a mesh of several processes: the local
    shards' rows copied to the host as all_to_all_single's send buffer,
    [dst rank, src local, dst local, ...]."""
    k, world = len(xs), mesh.world
    rest = tuple(xs[0].shape[1:])
    return torch.stack([_to_host(x) for x in xs]).reshape(
        (k, world, k) + rest).transpose(0, 1).contiguous()


def a2a_exchange(send: torch.Tensor) -> torch.Tensor:
    """all_to_all's second part: the group's exchange of a2a_stage's
    buffer; the result is [src rank, src local, dst local, ...]."""
    recv = torch.empty_like(send)
    if send.numel():
        dist.all_to_all_single(recv, send)
    return recv


def a2a_unstage(mesh: Mesh, recv: torch.Tensor,
                xs: Sequence[torch.Tensor]) -> Shards:
    """all_to_all's last part: each local shard's [ndev, ...] rows from
    a2a_exchange's buffer, back on its device."""
    rest = tuple(xs[0].shape[1:])
    return [_back(recv[:, :, i].reshape((mesh.size,) + rest), x)
            for i, x in enumerate(xs)]


def all_to_all(mesh: Mesh, xs: Sequence[torch.Tensor]) -> Shards:
    """Split axis 0 and concatenate on axis 0: row s of the output on
    shard d is row d of shard s's input ([ndev, ...] on every shard)."""
    _count("all_to_all")
    _layout(mesh, xs)
    if mesh.world == 1:
        return [torch.stack([x[d].to(y.device) for x in xs])
                for d, y in enumerate(xs)]
    return a2a_unstage(mesh, a2a_exchange(a2a_stage(mesh, xs)), xs)


def all_gather(mesh: Mesh, xs: Sequence[torch.Tensor]) -> Shards:
    """Every shard gets the [ndev, ...] stack of all shards' inputs."""
    _count("all_gather")
    _layout(mesh, xs)
    if mesh.world == 1:
        return [torch.stack([x.to(y.device) for x in xs]) for y in xs]
    mine = torch.stack([_to_host(x) for x in xs])
    parts = [torch.empty_like(mine) for _ in range(mesh.world)]
    if mine.numel():
        dist.all_gather(parts, mine)
    return [_back(torch.cat(parts), x) for x in xs]


def _reduce(mesh: Mesh, xs: Sequence[torch.Tensor], op,
            group_op: str) -> Shards:
    _layout(mesh, xs)
    acc = torch.stack([x.to(xs[0].device) for x in xs])
    total = op(acc)
    if mesh.world > 1 and total.numel():
        host = _to_host(total)
        dist.all_reduce(host, op=getattr(dist.ReduceOp, group_op))
        total = host.to(total.dtype)
    return [total.to(x.device, copy=True) for x in xs]


def psum(mesh: Mesh, xs: Sequence[torch.Tensor]) -> Shards:
    """Sum over the shards, replicated; int64 wraps around mod 2^64 (the
    u64 bit patterns of ops/u64.py), across processes too."""
    _count("psum")
    return _reduce(mesh, xs, lambda a: a.sum(0, dtype=a.dtype), "SUM")


def pmax(mesh: Mesh, xs: Sequence[torch.Tensor]) -> Shards:
    """Elementwise maximum over the shards, replicated."""
    _count("pmax")
    return _reduce(mesh, xs, lambda a: a.amax(0), "MAX")


def ppermute(mesh: Mesh, xs: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> Shards:
    """Shard dst receives shard src's tensor for each (src, dst) of
    `perm` (global shard indices); a shard that receives nothing gets
    zeros."""
    _count("ppermute")
    first = _layout(mesh, xs)
    k, rank = len(xs), mesh.rank
    out = [torch.zeros_like(x) for x in xs]
    ops, received = [], []
    for src, dst in perm:
        s_rank, d_rank = src // k, dst // k
        if s_rank == d_rank == rank:
            out[dst - first] = xs[src - first].to(xs[dst - first].device,
                                                  copy=True)
        elif xs[0].numel() and rank in (s_rank, d_rank):
            # a destination receives once per call: its index is the tag
            if s_rank == rank:
                ops.append(dist.P2POp(dist.isend, _to_host(xs[src - first]),
                                      d_rank, tag=dst))
            else:
                buf = torch.empty_like(_to_host(xs[dst - first]))
                ops.append(dist.P2POp(dist.irecv, buf, s_rank, tag=dst))
                received.append((dst - first, buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for i, buf in received:
        out[i] = _back(buf, xs[i])
    return out


def ring_all_to_all(mesh: Mesh, xs: Sequence[torch.Tensor]) -> Shards:
    """`all_to_all`'s contract in ndev - 1 neighbour-distance hops of
    ppermute (the JAX package's `_ring_all_to_all`): hop k moves each
    shard's row for its distance-k peer, so every step sends one row per
    shard and no link carries the whole fanout."""
    ndev, local = mesh.size, mesh.local
    _layout(mesh, xs)
    rows = [[None] * ndev for _ in local]
    for i, me in enumerate(local):
        rows[i][me] = xs[i][me].clone()
    for k in range(1, ndev):
        perm = [(i, (i + k) % ndev) for i in range(ndev)]
        got = ppermute(mesh, [x[(me + k) % ndev]
                              for x, me in zip(xs, local)], perm)
        for i, me in enumerate(local):  # arrives from (me - k) % ndev
            rows[i][(me - k) % ndev] = got[i]
    return [torch.stack(r) for r in rows]
