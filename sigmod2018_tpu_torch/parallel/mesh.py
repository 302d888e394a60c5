"""The device mesh: shards placed on devices, and row-sharded columns.

Counterpart of `jax.sharding.Mesh` and of `make_mesh` / `row_sharding` in
`sigmod2018_tpu/parallel/dist.py`.  The JAX package is single-controller
per process: each process runs `shard_map` programs over every device
of the mesh, and after `jax.distributed.initialize` the mesh spans the
devices of every process.  So does the port: a process holds one tensor
per shard that it owns, each on its shard's device, and the collectives
of parallel/collectives.py move rows between shards.

Without a process group (parallel/multihost.py) one process owns every
shard.  `make_mesh(n, "cuda")` places shard i on card i mod the number
of cards.  On one card every shard lives there, which is the
counterpart of the JAX tests' `--xla_force_host_platform_device_count=8`
virtual devices: the mesh's programs and collectives run unchanged, the
collectives as device copies.  With several cards the same code moves
rows by peer copies.  `make_mesh(n, "cpu")` puts every shard on the
CPU, as the tests do.

Under a process group of W ranks the n shards split host-major: rank p
owns shards [p n/W, (p+1) n/W), shard i on its owner's card i mod that
host's cards (the CPU under "cpu").  `Mesh.local` lists the shards this
process owns, and every list of shards that the parallel package passes
around holds those shards only, in that order.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.padding import size_class

AXIS = "shards"

Column = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """`devices`: an object array of torch.device, one per shard (the
    device on the shard's owner), whose axes `axis_names` names (1-D for
    the engines' shuffle axis).  `world`: the processes the shards split
    over, host-major (1: this process owns them all); `rank`: this
    process's.  The collectives read the layout from here."""

    devices: np.ndarray
    axis_names: Tuple[str, ...] = (AXIS,)
    rank: int = 0
    world: int = 1

    def __post_init__(self):
        if self.size % self.world or not 0 <= self.rank < self.world:
            raise ValueError(f"{self.size} shards do not split host-major "
                             f"over {self.world} processes at rank "
                             f"{self.rank}")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> List[torch.device]:
        return list(self.devices.reshape(-1))

    @property
    def local(self) -> List[int]:
        """The global indices of the shards this process owns."""
        k = self.size // self.world
        return list(range(self.rank * k, (self.rank + 1) * k))

    @property
    def local_devices(self) -> List[torch.device]:
        flat = self.flat
        return [flat[s] for s in self.local]


def _device_array(devs) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = list(devs)
    return arr


def process_devices(platform: str) -> List[torch.device]:
    """This process's devices: every card on "cuda" (a machine without a
    card raises), the CPU on "cpu"."""
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "S18_PLATFORM=cuda but torch.cuda.is_available() is False "
                "(set S18_PLATFORM=cpu to run the mesh on the CPU)")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if platform == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"S18_PLATFORM={platform!r}: expected 'cuda' or "
                     f"'cpu'")


def process_group() -> Optional[Tuple[int, int]]:
    """(rank, world size) of this process's group, None without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return None


def make_mesh(n_devices: Optional[int] = None,
              platform: str = "cuda") -> Mesh:
    """A 1-D mesh of n shards, shard i on this host's device i mod the
    platform's devices (on "cpu": the CPU).  Default n: every device of
    every process on "cuda", one per process on "cpu".  Under a process
    group the shards split host-major over the ranks (the module
    docstring), and n must be a multiple of the world size."""
    devs = process_devices(platform)
    rank, world = process_group() or (0, 1)
    per_process = len(devs) if platform == "cuda" else 1
    n = world * per_process if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n}")
    if n % world:
        raise ValueError(f"S18_MESH={n} shards do not split over "
                         f"S18_NUM_PROCS={world} processes")
    return Mesh(_device_array([devs[i % len(devs)] for i in range(n)]),
                rank=rank, world=world)


def _as_tensor(col: Column) -> torch.Tensor:
    if isinstance(col, torch.Tensor):
        return col
    return torch.from_numpy(np.ascontiguousarray(col).view(np.int64))


def split_rows(col: Column, mesh: Mesh) -> List[torch.Tensor]:
    """A column's rows in mesh.size equal blocks, block s on shard s's
    device, for the shards s of `mesh.local` in that order (the
    counterpart of `jax.device_put(col, row_sharding(mesh))`; u64 host
    arrays become int64 bit patterns).  A block already on its device
    is a view of `col`."""
    t = _as_tensor(col)
    ndev = mesh.size
    if t.shape[0] % ndev:
        raise ValueError(f"{t.shape[0]} rows do not split over {ndev} "
                         f"shards")
    L = t.shape[0] // ndev
    return [t[s * L:(s + 1) * L].to(d)
            for s, d in zip(mesh.local, mesh.local_devices)]


def row_sharding(mesh: Mesh):
    """The row-sharded layout of a 1-D column, as a function placing one
    (`split_rows` over `mesh`)."""
    return lambda col: split_rows(col, mesh)


def padded_rows(n: int, ndev: int, min_pad: int = 128) -> int:
    """Padded length of an n-row column on an ndev-shard mesh:
    size_class(n, min_pad * ndev), rounded up to a multiple of ndev when
    ndev is not a power of two."""
    P = size_class(max(n, 1), min_pad * ndev)
    return -(-P // ndev) * ndev


def pad_rows(col: torch.Tensor, length: int, fill: int = 0) -> torch.Tensor:
    """`col` padded with `fill` to `length` rows (itself if it has them)."""
    if col.shape[0] == length:
        return col
    out = torch.full((length,) + tuple(col.shape[1:]), fill,
                     dtype=col.dtype, device=col.device)
    out[:col.shape[0]] = col
    return out


def shard_rows(col: Column, mesh: Mesh) -> List[torch.Tensor]:
    """A base column padded with 0 to `padded_rows(n, mesh.size)` and split
    over the mesh: shard s owns rows [sL, (s+1)L) of the padded column."""
    t = _as_tensor(col)
    return split_rows(pad_rows(t, padded_rows(t.shape[0], mesh.size)), mesh)
