"""Engine configuration: the fields of `sigmod2018_tpu/config.py` that the
operator-granular engine reads, under the same environment knobs.  The
reference's debugging switches S18_OPTIMIZE, S18_FUSE and S18_PRESORT
are fixed on here: the DP join order, the fused final join and the
prep-time sorts always run."""

from __future__ import annotations

import dataclasses
import os

import torch


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # Device the engine runs on: "cuda" (default) or "cpu".  Asking for
    # "cuda" on a machine without a usable card raises; nothing falls
    # back to the CPU.
    platform: str = "cuda"

    # Fused-join member: "auto" (the staircase member at scale, the
    # sort/table members below ops.radix_join.RADIX_MIN_ROWS), or "sort"
    # / "ms" to force one.  "radix" and "qd" are not ported yet and raise.
    join_algo: str = "auto"

    # Domain-rank key tables for base join columns whose exact max u
    # satisfies u + 3 <= key_table_max (engine device_key_table).  0
    # disables.  Device cost: 4*(u+3) bytes per column.
    key_table_max: int = 1 << 22

    # Intermediate-result row cap: a planned join order past it re-runs
    # the query in text order.  0 disables the net.
    max_intermediate: int = 1 << 26

    # Threads dispatching the queries of one batch: they overlap each
    # query's host syncs (one per intermediate join).
    batch_workers: int = 8

    def device(self) -> torch.device:
        if self.platform == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "S18_PLATFORM=cuda but torch.cuda.is_available() is "
                    "False (set S18_PLATFORM=cpu to run on the CPU)")
            return torch.device("cuda", torch.cuda.current_device())
        if self.platform == "cpu":
            return torch.device("cpu")
        raise ValueError(f"S18_PLATFORM={self.platform!r}: expected "
                         f"'cuda' or 'cpu'")

    @staticmethod
    def from_env() -> "EngineConfig":
        def _flag(name: str, default: str) -> str:
            return os.environ.get(name, default)

        return EngineConfig(
            platform=_flag("S18_PLATFORM", "cuda"),
            join_algo=_flag("S18_JOIN", "auto"),
            key_table_max=int(_flag("S18_KEYTABLE", str(1 << 22))),
            batch_workers=int(_flag("S18_WORKERS", "8")),
        )


DEFAULT_CONFIG = EngineConfig()
