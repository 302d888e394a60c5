"""Multi-process bring-up and host-aware meshes.

Counterpart of `sigmod2018_tpu/parallel/multihost.py`:

- `init_distributed()` joins a `torch.distributed` process group from
  the JAX package's env contract (S18_COORD_ADDR, S18_NUM_PROCS,
  S18_PROC_ID); without S18_COORD_ADDR it is the single-process no-op.
  After it, `make_mesh` splits the mesh's shards host-major over the
  ranks and the collectives cross processes (parallel/mesh.py,
  parallel/collectives.py), as `jax.devices()` spans every process after
  `jax.distributed.initialize`.  The group's backend is gloo, and the
  collectives stage every tensor through host memory, so the same
  transport runs on the CPU and between ranks that share one card.
- `hier_mesh()` builds the 2-D ("host", "chip") mesh: under a group one
  row per rank, holding its shards; in one process `fake_hosts` splits
  the devices into that many synthetic host groups, as the JAX
  package's topology tests do.  `flat_mesh_dcn_last()` flattens it
  host-major, so consecutive shards of the engines' shuffle axis are
  same-host devices.
"""

from __future__ import annotations

import datetime
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import process_env
from .mesh import AXIS, Mesh, make_mesh, process_group

HOST_AXIS = "host"
CHIP_AXIS = "chip"

BACKEND = "gloo"
TRANSPORT = "gloo, staged through host memory"
# How long a rank waits for the others at the group's start and in a
# collective before the group raises.
TIMEOUT_S = 300


def init_distributed():
    """Join the process group that the env asks for (the JAX package's
    contract: S18_COORD_ADDR host:port of rank 0, S18_NUM_PROCS ranks,
    S18_PROC_ID this rank).  False for the ordinary single-process case
    (no S18_COORD_ADDR); else (rank, world size).  A second call returns
    them again without a new group."""
    env = process_env()
    if env is None:
        return False
    addr, world, rank = env
    if process_group() is None:
        import torch.distributed as dist

        dist.init_process_group(
            BACKEND, init_method=f"tcp://{addr}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        print(f"process {rank} of {world}: collectives over {TRANSPORT} "
              f"(rendezvous {addr})", file=sys.stderr)
    return rank, world


def _devices(devices: Optional[Sequence[torch.device]]) -> list:
    if devices is not None:
        return list(devices)
    return make_mesh(platform="cuda").flat


def hier_mesh(devices: Optional[Sequence[torch.device]] = None,
              fake_hosts: Optional[int] = None) -> Mesh:
    """2-D ("host", "chip") mesh over `devices` (default: every card of
    every process).  Under a process group row p holds rank p's shards
    (host-major, as make_mesh splits them); in one process all devices
    are this host's, one row, unless `fake_hosts` splits them."""
    devs = _devices(devices)
    rank, world = process_group() or (0, 1)
    if world > 1 and fake_hosts:
        raise ValueError("fake_hosts is for one process; under a process "
                         "group each rank is a host")
    hosts = world if world > 1 else (fake_hosts or 1)
    if len(devs) % hosts:
        raise ValueError(f"{len(devs)} devices not divisible into {hosts} "
                         f"hosts")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(hosts, -1), (HOST_AXIS, CHIP_AXIS),
                rank=rank, world=world)


def flat_mesh_dcn_last(devices: Optional[Sequence[torch.device]] = None,
                       fake_hosts: Optional[int] = None) -> Mesh:
    """1-D mesh for the shuffle axis, host-major: shard order runs over
    host 0's devices, then host 1's."""
    hm = hier_mesh(devices, fake_hosts=fake_hosts)
    return Mesh(hm.devices.reshape(-1), (AXIS,), rank=hm.rank,
                world=hm.world)
