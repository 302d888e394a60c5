"""stdin/stdout protocol driver (counterpart of `sigmod2018_tpu/io/repl.py`).

Protocol:
  1. one relation file path per line, until the line "Done"
  2. query lines in batches; "F" ends a batch (the whole batch executes
     then), "Exit" or EOF terminates
  3. one output line per query: space-separated uint64 checksums, or NULL
     per projection on an empty result

Prep is loading and stats (storage/catalog.py: stats cache, native
loader or NumPy), then the engine's prefetch (device copies, presorts,
key tables).  The contest harness times everything past a 1 s window
after `Done`, so by default (S18_ASYNC_PREP) the prefetch runs in a
thread while serving starts, and the first queries build the columns
they need on demand.  An exception in that thread is raised by `serve`
after the last line is written, and `serve` joins the thread before it
returns.  S18_ASYNC_PREP=0 prefetches before the first query is read.

A malformed query line — text that does not parse, or that names a
relation, binding or column that does not exist — answers a NULL line
and the batch goes on, as in the reference package.  Any other error is
a fault of the engine or the device and propagates.

The engine is `CompiledTorchEngine` (engine/compiled.py), or the
operator-granular `TorchEngine` under S18_COMPILE_QUERIES=0 and under
S18_TRACE (whose per-op report is the operator engine's, as in the
reference package), or under S18_BACKEND=numpy the host oracle's
`OracleEngine` (engine/oracle.py), which touches no device.  With
S18_MESH > 1 the first two are their mesh counterparts,
`DistCompiledTorchEngine` and `DistTorchEngine` (parallel/).  `serve`
returns it; `run_protocol` returns how many queries each serving tier
answered (`TorchEngine.tiers`).  `main` prints the engine's counts (host
reads of intermediate totals and, for the compiled engine, how each
query was sized) and then the tiers on stderr at exit.

With S18_COORD_ADDR, S18_NUM_PROCS and S18_PROC_ID set and S18_MESH > 1,
W processes serve together (parallel/multihost.py): each reads the
protocol on its own stdin and writes every answer line, and the mesh's
shards split over them.  The collectives of one rank must meet the same
collectives of the others, so under a group one thread dispatches each
batch in input order, whatever S18_WORKERS says; the prefetch issues no
collective and keeps its thread, except that a warm replay (which
serves queries) runs before the first query is read.  `main` then also
prints one `process {..}` JSON line on stderr (rank, world size,
transport, collective calls by kind, K1/K4/K5 launches, the engine's
counts, tiers and join strategies, prep and timed seconds) and leaves
the group at exit.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import IO, Dict, List, Optional

from ..config import EngineConfig
from ..frontend.parser import FilterPred, Query, parse_query
from ..storage.catalog import Catalog


def check_query(q: Query, catalog: Catalog) -> None:
    """Raise ValueError unless every relation, binding and column the
    query names exists in the catalog."""
    for rid in q.relations:
        if not 0 <= rid < len(catalog):
            raise ValueError(f"no relation {rid}")
    refs = list(q.views)
    for p in q.predicates:
        if isinstance(p, FilterPred):
            refs.append((p.binding, p.column))
        else:
            refs += [(p.binding1, p.column1), (p.binding2, p.column2)]
    for b, c in refs:
        if not 0 <= b < len(q.relations):
            raise ValueError(f"no binding {b}")
        if not 0 <= c < catalog.relation(q.relations[b]).num_columns:
            raise ValueError(f"no column {b}.{c}")


def _null_line(num_views: int) -> str:
    return " ".join(["NULL"] * max(num_views, 1))


def make_engine(catalog: Catalog, config: EngineConfig):
    """The engine `config` asks for (see the module docstring)."""
    if config.backend == "numpy":
        from ..engine.oracle import OracleEngine

        return OracleEngine(catalog)
    compiled = config.compile_queries and not config.trace
    if config.mesh_devices > 1:
        from ..parallel.multihost import init_distributed

        init_distributed()  # joins S18_COORD_ADDR's group
        if compiled:
            from ..parallel.dist_compiled import DistCompiledTorchEngine

            return DistCompiledTorchEngine(catalog, config)
        from ..parallel.dist_engine import DistTorchEngine

        return DistTorchEngine(catalog, config)
    from ..engine.compiled import CompiledTorchEngine
    from ..engine.executor import TorchEngine

    if compiled:
        return CompiledTorchEngine(catalog, config)
    return TorchEngine(catalog, config)


class _Prep:
    """engine.prefetch() in a thread; its exception is kept for `serve`."""

    def __init__(self, engine):
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, args=(engine,),
                                        name="s18prefetch")
        self._thread.start()

    def _run(self, engine) -> None:
        try:
            engine.prefetch()
        except BaseException as exc:  # noqa: BLE001 — serve raises it
            self.error = exc

    def join(self) -> Optional[BaseException]:
        self._thread.join()
        return self.error


def serve(stdin: IO[str], stdout: IO[str],
          config: Optional[EngineConfig] = None):
    """Answer the protocol on stdin; returns the engine that served."""
    from concurrent.futures import ThreadPoolExecutor

    from ..engine.executor import format_batch

    config = config or EngineConfig.from_env()
    paths: List[str] = []
    for raw in stdin:
        line = raw.strip()
        if line == "Done":
            break
        if line:
            paths.append(line)

    catalog = Catalog.from_files(paths, native=config.native)
    engine = make_engine(catalog, config)
    grouped = _in_group(config)
    prep = None
    if config.async_prep and not (grouped and config.warm_replay):
        prep = _Prep(engine)
    else:
        engine.prefetch()

    def start(q):
        # a str is the NULL answer of a malformed line
        return q if isinstance(q, str) else engine.execute_async(q)

    def run_batch(batch: list, pool) -> None:
        # Dispatch the whole batch before fetching any result line.
        results = (list(pool.map(start, batch)) if pool is not None
                   else [start(q) for q in batch])
        for line in format_batch(results):
            stdout.write(line + "\n")
        stdout.flush()

    workers = config.batch_workers
    if grouped and workers > 1:
        print(f"S18_WORKERS={workers} overridden: under a process group one "
              f"thread dispatches each batch in input order", file=sys.stderr)
        workers = 1
    pool = (ThreadPoolExecutor(workers, thread_name_prefix="s18batch")
            if workers > 1 else None)
    try:
        batch: list = []
        for raw in stdin:
            line = raw.strip()
            if line == "Exit":
                break
            if not line:
                continue
            if line == "F":
                run_batch(batch, pool)
                batch = []
                continue
            try:
                q = parse_query(line)
            except ValueError as exc:
                print(f"parse error: {exc!r} in {line!r}", file=sys.stderr)
                batch.append(_null_line(1))
                continue
            try:
                check_query(q, catalog)
            except ValueError as exc:
                print(f"query error: {exc} in {line!r}", file=sys.stderr)
                batch.append(_null_line(len(q.views)))
                continue
            batch.append(q)
        # A trailing batch without its final F still executes.
        run_batch(batch, pool)
    except BaseException as exc:
        if prep is not None and prep.join() is not None:
            exc.add_note(f"the prefetch thread failed too: {prep.error!r}")
        raise
    finally:
        if pool is not None:
            pool.shutdown()
        if prep is not None:
            prep.join()  # nothing of prep outlives serve on the card
    if prep is not None and prep.error is not None:
        raise prep.error
    return engine


def _in_group(config: EngineConfig) -> bool:
    """Whether this process serves in a process group."""
    if config.mesh_devices == 1 or config.backend == "numpy":
        return False
    from ..parallel.mesh import process_group

    return process_group() is not None


def run_protocol(stdin: IO[str], stdout: IO[str],
                 config: Optional[EngineConfig] = None) -> Dict[str, int]:
    return dict(serve(stdin, stdout, config).tiers)


class _Clocked:
    """stdin's lines, noting when the first line after "Done" is read
    (the end of prep)."""

    def __init__(self, stdin: IO[str]):
        self._stdin = stdin
        self._done = False
        self.t_serving: Optional[float] = None

    def __iter__(self):
        return self

    def __next__(self) -> str:
        line = next(self._stdin)
        if self._done and self.t_serving is None:
            self.t_serving = time.perf_counter()
        self._done = self._done or line.strip() == "Done"
        return line


def _process_report(engine, t0: float, t_serving: Optional[float]) -> str:
    """The `process {..}` line of a rank (module docstring)."""
    import collections

    from ..ops import ms_join, radix_join
    from ..parallel import collectives
    from ..parallel.mesh import process_group
    from ..parallel.multihost import TRANSPORT

    rank, world = process_group()
    end = time.perf_counter()
    t_serving = end if t_serving is None else t_serving
    return "process " + json.dumps(dict(
        rank=rank, world=world, transport=TRANSPORT,
        collectives=dict(collectives.CALLS),
        launches=dict(K1=ms_join.LAUNCHES,
                      K4=radix_join.LAUNCHES["slot_fill"],
                      K5=radix_join.LAUNCHES["probe_counts"]),
        counts=dict(engine.counts), tiers=dict(engine.tiers),
        join_strategies=dict(collections.Counter(
            getattr(engine, "join_strategies", ()))),
        prep_s=t_serving - t0, timed_s=end - t_serving))


def main() -> None:
    t0 = time.perf_counter()
    stdin = _Clocked(sys.stdin)
    config = EngineConfig.from_env()
    try:
        engine = serve(stdin, sys.stdout, config)
        print(f"engine {type(engine).__name__}:" + "".join(
            f" {k}={v}" for k, v in engine.counts.items()), file=sys.stderr)
        print("served by tier: " + " ".join(
            f"{k}={v}" for k, v in engine.tiers.items()), file=sys.stderr)
        if _in_group(config):
            print(_process_report(engine, t0, stdin.t_serving),
                  file=sys.stderr)
    finally:
        if _in_group(config):
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
