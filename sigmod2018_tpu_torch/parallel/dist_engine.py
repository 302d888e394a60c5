"""The operator engine on a mesh (S18_MESH > 1 with S18_COMPILE_QUERIES=0
or S18_TRACE).

Counterpart of `sigmod2018_tpu/parallel/dist_engine.py::DistJaxEngine`.
There, base columns are row-sharded and every operator program runs
under GSPMD, which inserts the gathers its operators need, while the
fused final join goes through the hand-written hash shuffle of dist.py.
Here the operators are TorchEngine's, on whole columns on the mesh's
first device (where GSPMD's gathers would have put them), and the fused
final join is the shuffle: both sides are split over the mesh,
`make_shuffle_caps` sizes the send buffers with one host read, and
`make_fused_shuffle_join` exchanges the rows and joins them shard by
shard.  The prep-time join artifacts do not apply
(`prep_join_artifacts = False`): the shuffle re-partitions the build
side.

Under a process group every rank runs the operators on whole columns on
its first device (the same work on every rank, so every rank reads the
same totals), splits each fused join's sides into the blocks of the
shards it owns, and the shuffle's collectives cross processes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import EngineConfig
from ..engine.executor import TorchEngine
from ..storage.catalog import Catalog
from ..utils.padding import size_class
from .dist import make_fused_shuffle_join, make_shuffle_caps
from .mesh import Mesh, make_mesh, padded_rows


def padded_column(catalog: Catalog, rid: int, cid: int,
                  ndev: int) -> Tuple[np.ndarray, int]:
    """A base column on the host, padded with 0 so that it splits into
    ndev equal shards (mesh.padded_rows), and its live rows."""
    col = np.array(catalog.column(rid, cid), dtype=np.uint64)
    host = np.zeros(padded_rows(col.shape[0], ndev), dtype=np.uint64)
    host[:col.shape[0]] = col
    return host, col.shape[0]


def mesh_column(engine: TorchEngine, rid: int,
                cid: int) -> Tuple[torch.Tensor, int]:
    """padded_column whole on the engine's first device."""
    host, n = padded_column(engine.catalog, rid, cid, engine.mesh.size)
    return torch.from_numpy(host.view(np.int64)).to(engine.device), n


def mesh_for(config: EngineConfig, mesh: Optional[Mesh]) -> Mesh:
    """The engine's mesh: the one given, else S18_MESH shards (every
    card when it is 1) on the configured platform."""
    if mesh is not None:
        return mesh
    return make_mesh(config.mesh_devices if config.mesh_devices > 1
                     else None, config.platform)


class DistTorchEngine(TorchEngine):
    """TorchEngine whose fused final join is the mesh's hash shuffle."""

    prep_join_artifacts = False

    def __init__(self, catalog: Catalog, config: EngineConfig,
                 mesh: Optional[Mesh] = None):
        super().__init__(catalog, config)
        self.mesh = mesh_for(config, mesh)
        self.device = self.mesh.local_devices[0]
        # the host read of each shuffle join's send maxima
        self.counts["cap_reads"] = 0

    def device_column(self, rid: int, cid: int) -> Tuple[torch.Tensor, int]:
        return self._once(self._columns, (rid, cid),
                          lambda: mesh_column(self, rid, cid))

    def _fused_join(self, keys_b, vals_b, n_b, keys_p, vals_p, n_p, **kw):
        """The shuffle join over the mesh.  Each view's values are on one
        side; the other side gets a zero column in its slot, so the
        packed sums are view-slot aligned."""
        ndev = self.mesh.size
        Vb, Vp = vals_b.shape[0], vals_p.shape[0]

        def split(t: torch.Tensor):
            """t's last axis in equal blocks over the mesh (zero-padded),
            the blocks of this process's shards."""
            P = t.shape[-1]
            L = -(-P // ndev)
            t = torch.nn.functional.pad(t, (0, L * ndev - P))
            return [t[..., s * L:(s + 1) * L].to(d)
                    for s, d in zip(self.mesh.local,
                                    self.mesh.local_devices)]

        kb, kp = split(keys_b), split(keys_p)
        hints = make_shuffle_caps(self.mesh)(kb, n_b, kp, n_p).tolist()
        self._count("cap_reads")
        cap = size_class(max(hints[0], hints[1], 1))
        bcols = torch.cat([vals_b, vals_b.new_zeros(Vp, vals_b.shape[1])])
        pcols = torch.cat([vals_p.new_zeros(Vb, vals_p.shape[1]), vals_p])
        packed = make_fused_shuffle_join(self.mesh, cap, Vb + Vp)(
            kb, split(bcols), n_b, kp, split(pcols), n_p)
        return packed[0], packed[1:1 + Vb], packed[1 + Vb:]
