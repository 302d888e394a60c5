"""Engine configuration: the fields of `sigmod2018_tpu/config.py` that the
port's engines read, under the same environment knobs and defaults.  The
reference's debugging switches S18_OPTIMIZE, S18_FUSE and S18_PRESORT
are fixed on here: the DP join order, the fused final join and the
prep-time sorts always run."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple, Union

import torch

BACKENDS = ("torch", "numpy")
EXCHANGES = ("a2a", "ring")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # Device the engine runs on: "cuda" (default) or "cpu".  Asking for
    # "cuda" on a machine without a usable card raises; nothing falls
    # back to the CPU.
    platform: str = "cuda"

    # Operator backend: "torch" (the engines of engine/, on `platform`) or
    # "numpy" (the host oracle, engine/oracle.py: no device is touched).
    backend: str = "torch"

    # Fused-join member: "auto" (the staircase member at scale, the
    # sort/table members below ops.radix_join.RADIX_MIN_ROWS), or "sort",
    # "ms", "radix" or "qd" (the radix and equi-depth members, with the
    # slot-fill and dual-count kernels) to force one.
    join_algo: str = "auto"

    # Domain-rank key tables for base join columns whose exact max u
    # satisfies u + 3 <= key_table_max (engine device_key_table).  0
    # disables.  Device cost: 4*(u+3) bytes per column.
    key_table_max: int = 1 << 22

    # Intermediate-result row cap: a planned join order past it answers
    # by message passing if the query is a forest (engine/factorized.py),
    # else re-runs in text order.  0 disables the net.
    max_intermediate: int = 1 << 26

    # Proactive factorized (Yannakakis message-passing) service: a
    # forest-shaped query whose PLANNED largest intermediate reaches this
    # many rows, or whose final estimate reaches 16x it, answers by
    # message passing and materializes nothing
    # (TorchEngine._maybe_factorized).  0 disables.
    factorize_min: int = 1 << 22

    # Threads dispatching the queries of one batch: they overlap each
    # query's host syncs (one per intermediate join).
    batch_workers: int = 8

    # Whole-query engine (engine/compiled.py::CompiledTorchEngine): a
    # query's device work is dispatched in one go when the size class of
    # every intermediate join is known or guessed, and fetched with the
    # batch.  False serves with the operator-granular TorchEngine, which
    # reads each intermediate join's size to the host.
    compile_queries: bool = True

    # Speculative intermediate sizing: guess each intermediate join's
    # size class as the planner's estimate x spec_margin; a guess that
    # was too small is found when the batch is fetched and the query
    # re-runs with one host read per intermediate join.  A guess past
    # spec_max rows is not made (the query takes that path at once).
    speculate: bool = True
    spec_margin: int = 8
    spec_max: int = 1 << 22

    # Replay the persisted serving history (the learned size classes) in
    # prefetch, so every known text has run once before the timed phase.
    warm_replay: bool = False

    # S18_EXPLAIN=1: each join order with the planner's estimates, and the
    # actual total of each intermediate join read to the host, on stderr.
    explain: bool = False

    # S18_TRACE: per-op card time, bytes and floors of each query on
    # stderr (engine/trace.py), True for a table, "json" for one object
    # per query.  io/repl.py then serves with the operator engine.
    trace: Union[bool, str] = False

    # Run the prefetch (device copies, presorts, key tables) in a thread
    # while serving starts; the first queries build what they need.
    async_prep: bool = True

    # Stats by the native loader (storage/native); False: NumPy.
    native: bool = True

    # Mesh of shards the relations are row-sharded over (parallel/): 1
    # serves on one device; n > 1 places shard i on card i mod the
    # number of cards (parallel/mesh.py::make_mesh).
    mesh_devices: int = 1

    # The mesh's hash-shuffle transport: "a2a" (all_to_all) or "ring"
    # (ndev - 1 neighbour hops of ppermute; parallel/collectives.py).
    exchange: str = "a2a"

    # A join whose build side holds at most this many padded rows over
    # the whole mesh broadcasts it (all_gather) and moves no probe row;
    # larger builds hash-shuffle both sides (parallel/dist_compiled.py).
    bcast_threshold: int = 4096

    # Skew-split joins: a shuffle join whose catalog MCV sketch shows a
    # hot key with at least skew_factor x a shard's average row share
    # gathers that key's rows of one side to every shard and joins the
    # other side's hot rows in place.  0 disables.
    skew_factor: int = 2

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"S18_BACKEND={self.backend!r}: expected one "
                             f"of {BACKENDS}")
        if self.exchange not in EXCHANGES:
            raise ValueError(f"S18_EXCHANGE={self.exchange!r}: expected "
                             f"one of {EXCHANGES}")
        for name, value, least in (("S18_MESH", self.mesh_devices, 1),
                                   ("S18_BCAST", self.bcast_threshold, 0),
                                   ("S18_SKEW", self.skew_factor, 0)):
            if value < least:
                raise ValueError(f"{name}={value}: expected an integer "
                                 f">= {least}")

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

        config = EngineConfig(
            platform=_flag("S18_PLATFORM", "cuda"),
            join_algo=_flag("S18_JOIN", "auto"),
            key_table_max=int(_flag("S18_KEYTABLE", str(1 << 22))),
            factorize_min=int(_flag("S18_FACTORIZE_MIN", str(1 << 22))),
            batch_workers=int(_flag("S18_WORKERS", "8")),
            compile_queries=_flag("S18_COMPILE_QUERIES", "1") != "0",
            speculate=_flag("S18_SPECULATE", "1") != "0",
            spec_margin=int(_flag("S18_SPEC_MARGIN", "8")),
            spec_max=int(_flag("S18_SPEC_MAX", str(1 << 22))),
            warm_replay=_flag("S18_WARM_REPLAY", "0") != "0",
            backend=_flag("S18_BACKEND", "torch"),
            explain=_flag("S18_EXPLAIN", "0") == "1",
            trace={"0": False, "1": True}.get(_flag("S18_TRACE", "0"),
                                              _flag("S18_TRACE", "0")),
            async_prep=_flag("S18_ASYNC_PREP", "1") != "0",
            native=_flag("S18_NATIVE", "1") != "0",
            mesh_devices=int(_flag("S18_MESH", "1")),
            exchange=_flag("S18_EXCHANGE", "a2a"),
            bcast_threshold=int(_flag("S18_BCAST", "4096")),
            skew_factor=int(_flag("S18_SKEW", "2")),
        )
        procs = process_env()
        n = config.mesh_devices
        if procs and n > 1 and n % procs[1]:
            # the shards split host-major over the ranks
            raise ValueError(f"S18_MESH={n}: expected a multiple of "
                             f"S18_NUM_PROCS={procs[1]}")
        return config


def process_env() -> Optional[Tuple[str, int, int]]:
    """(S18_COORD_ADDR, S18_NUM_PROCS, S18_PROC_ID), or None when
    S18_COORD_ADDR is unset; a missing or out-of-range count or id
    raises ValueError naming its variable."""
    addr = os.environ.get("S18_COORD_ADDR")
    if not addr:
        return None
    values = []
    for name in ("S18_NUM_PROCS", "S18_PROC_ID"):
        raw = os.environ.get(name)
        try:
            values.append(int(raw))
        except (TypeError, ValueError):
            raise ValueError(f"S18_COORD_ADDR={addr!r} needs {name} (an "
                             f"integer), not {raw!r}") from None
    world, rank = values
    if world < 1:
        raise ValueError(f"S18_NUM_PROCS={world}: expected an integer >= 1")
    if not 0 <= rank < world:
        raise ValueError(f"S18_PROC_ID={rank}: expected 0 <= id < "
                         f"S18_NUM_PROCS={world}")
    return addr, world, rank


DEFAULT_CONFIG = EngineConfig()
