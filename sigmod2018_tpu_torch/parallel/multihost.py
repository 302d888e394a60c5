"""Multi-host bring-up and host-aware meshes.

Counterpart of `sigmod2018_tpu/parallel/multihost.py`.  The port is one
process that holds every shard (parallel/mesh.py), so every device of a
mesh is on this host:

- `init_distributed()` is a no-op without `S18_COORD_ADDR`.  With it
  set, the JAX package joins a multi-process runtime; serving over
  several hosts (a process group and the exchange between processes)
  is not ported yet, and the call raises instead of ignoring the
  variable.
- `hier_mesh()` builds the 2-D ("host", "chip") mesh; `fake_hosts`
  splits one host's devices into that many synthetic host groups, as
  the JAX package's topology tests do.  `flat_mesh_dcn_last()` flattens
  it host-major, so consecutive shards of the engines' shuffle axis are
  same-host devices.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from .mesh import AXIS, Mesh, make_mesh

HOST_AXIS = "host"
CHIP_AXIS = "chip"


def init_distributed() -> bool:
    """False for the single-process case (no S18_COORD_ADDR); raises
    RuntimeError when a multi-process runtime is asked for."""
    addr = os.environ.get("S18_COORD_ADDR")
    if not addr:
        return False
    raise RuntimeError(
        f"S18_COORD_ADDR={addr!r}: multi-host serving is not ported yet; "
        f"the port serves one process whose mesh spans this host's "
        f"devices (unset S18_COORD_ADDR)")


def _devices(devices: Optional[Sequence[torch.device]]) -> list:
    if devices is not None:
        return list(devices)
    return make_mesh(platform="cuda").flat


def hier_mesh(devices: Optional[Sequence[torch.device]] = None,
              fake_hosts: Optional[int] = None) -> Mesh:
    """2-D ("host", "chip") mesh over `devices` (default: every card).
    Without `fake_hosts` all devices are this process's host: one row."""
    devs = _devices(devices)
    hosts = fake_hosts or 1
    if len(devs) % hosts:
        raise ValueError(f"{len(devs)} devices not divisible into {hosts} "
                         f"hosts")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(hosts, -1), (HOST_AXIS, CHIP_AXIS))


def flat_mesh_dcn_last(devices: Optional[Sequence[torch.device]] = None,
                       fake_hosts: Optional[int] = None) -> Mesh:
    """1-D mesh for the shuffle axis, host-major: shard order runs over
    host 0's devices, then host 1's."""
    grid = hier_mesh(devices, fake_hosts=fake_hosts).devices
    return Mesh(grid.reshape(-1), (AXIS,))
