"""The device mesh: shards placed on devices, and row-sharded columns.

Counterpart of `jax.sharding.Mesh` and of `make_mesh` / `row_sharding` in
`sigmod2018_tpu/parallel/dist.py`.  The JAX package is single-controller:
one process runs `shard_map` programs over every device it sees.  So is
the port: one process holds one tensor per shard, each on its shard's
device, and the collectives of parallel/collectives.py move rows between
them.  No process group is involved.

`make_mesh(n, "cuda")` places shard i on card i mod the number of cards.
On one card every shard lives there, which is the counterpart of the JAX
tests' `--xla_force_host_platform_device_count=8` virtual devices: the
mesh's programs and collectives run unchanged, the collectives as device
copies.  With several cards the same code moves rows by peer copies.
`make_mesh(n, "cpu")` puts every shard on the CPU, as the tests do.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.padding import size_class

AXIS = "shards"

Column = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """`devices`: an object array of torch.device, one per shard, whose
    axes `axis_names` names (1-D for the engines' shuffle axis)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...] = (AXIS,)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat(self) -> List[torch.device]:
        return list(self.devices.reshape(-1))


def _device_array(devs) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = list(devs)
    return arr


def make_mesh(n_devices: Optional[int] = None,
              platform: str = "cuda") -> Mesh:
    """A 1-D mesh of n shards.  On "cuda" shard i lives on card i mod
    torch.cuda.device_count() (default n: every card), and a machine
    without a card raises; on "cpu" every shard is on the CPU (default
    n: 1)."""
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "S18_PLATFORM=cuda but torch.cuda.is_available() is False "
                "(set S18_PLATFORM=cpu to run the mesh on the CPU)")
        cards = torch.cuda.device_count()
        n = cards if n_devices is None else n_devices
        devs = [torch.device("cuda", i % cards) for i in range(n)]
    elif platform == "cpu":
        n = 1 if n_devices is None else n_devices
        devs = [torch.device("cpu")] * n
    else:
        raise ValueError(f"S18_PLATFORM={platform!r}: expected 'cuda' or "
                         f"'cpu'")
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n}")
    return Mesh(_device_array(devs))


def _as_tensor(col: Column) -> torch.Tensor:
    if isinstance(col, torch.Tensor):
        return col
    return torch.from_numpy(np.ascontiguousarray(col).view(np.int64))


def split_rows(col: Column, mesh: Mesh) -> List[torch.Tensor]:
    """A column's rows in mesh.size equal blocks, block s on shard s's
    device (the counterpart of `jax.device_put(col, row_sharding(mesh))`;
    u64 host arrays become int64 bit patterns).  A block already on its
    device is a view of `col`."""
    t = _as_tensor(col)
    ndev = mesh.size
    if t.shape[0] % ndev:
        raise ValueError(f"{t.shape[0]} rows do not split over {ndev} "
                         f"shards")
    L = t.shape[0] // ndev
    return [t[s * L:(s + 1) * L].to(d) for s, d in enumerate(mesh.flat)]


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
