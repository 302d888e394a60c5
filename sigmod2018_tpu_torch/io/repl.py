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
after `Done`, and a fresh process spends seconds importing torch and
starting the card.  So the card starts in a thread (`_Card`, the JAX
driver's `_init_backend_async`) before the first relation path is read:
it imports torch, starts the device with a first launch and a value
read, loads the CUDA kernels, imports the engine modules, then makes the
engine from the catalog and runs its prefetch.  The main thread meanwhile
reads the relations and serves: until the engine is made (or the thread
has failed), a query whose bindings reference at most S18_WARMUP_ORACLE
base rows (2^21; 0 disables) answers on the host, exactly, by
engine/factorized.py's NumPy twin or else the NumPy oracle, with no torch
in the main thread (the warm-up tier, `_HostTier`).  A query past the
bound, or whose intermediate passes the engine's cap in the oracle,
waits for the engine.  Under a process group the tier is off, since
every rank must issue the same collectives.  By default (S18_ASYNC_PREP)
the prefetch runs while serving goes on, and the first queries build the
columns they need on demand; with S18_ASYNC_PREP=0 the prefetch ends
before the first query is read, which also keeps the tier closed.

`main` first puts every thread on glibc's main malloc arena
(`one_malloc_arena`): on the H100 machine, with an arena per thread both
the card thread's `import torch` and serving on the batch threads took
longer (tools/cold_start.py's arena study).

The thread's exception is kept: the first query that needs the engine
raises it, and `serve` raises it after the last line is written, so a
run with no usable card fails even when the tier answered every line.
`serve` joins the thread before it returns.  Under S18_BACKEND=numpy no
thread starts and torch is never imported.

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
answered (`TorchEngine.tiers`, and `warmup_host` for the warm-up tier).
`main` prints on stderr at exit one `start {..}` JSON line (seconds from
the process's start to each step of `STEPS`, null for a step not
reached), a `kernel launches: K1=.. K4=.. K5=..` line (`kernel_launches`),
the engine's counts (host reads of intermediate totals and, for the
compiled engine, how each query was sized) and then the tiers.

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

import dataclasses
import json
import os
import sys
import threading
import time
from typing import IO, Dict, List, Optional

from ..config import EngineConfig, process_env, total_limit
from ..frontend.parser import FilterPred, Query, parse_query
# numpy's import here, before the card's thread starts: beside that
# thread's `import torch` it would take seconds, and torch needs numpy
from ..storage.catalog import Catalog

# The steps of a process's start that `serve` notes (ServeLog.marks), in
# the order they are expected: the card's thread starts, then its steps
# and the main thread's run side by side.
STEPS = ("card_started", "done_read", "catalog_loaded", "torch_imported",
         "cuda_ready", "kernels_loaded", "engine_imported", "engine_built",
         "prefetch_done", "first_line", "last_line")


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


@dataclasses.dataclass
class ServeLog:
    """What `serve` notes beside the engine's own counts: the
    time.perf_counter() at which each of STEPS ended, and how many
    queries the warm-up tier answered."""

    marks: Dict[str, float] = dataclasses.field(default_factory=dict)
    warmup_host: int = 0

    def mark(self, step: str) -> None:
        self.marks[step] = time.perf_counter()

    def timeline(self, origin: float) -> Dict[str, Optional[float]]:
        """{step: seconds since `origin`, or None if not reached}."""
        return {k: (self.marks[k] - origin if k in self.marks else None)
                for k in STEPS}


class _Card:
    """The device engine, made in a thread that starts before the
    relation list is read (see the module docstring).  `built` is set
    once the engine is made or the thread has failed; the thread's
    exception is kept and raised by `engine()`."""

    def __init__(self, config: EngineConfig, log: ServeLog):
        self.error: Optional[BaseException] = None
        self.built = threading.Event()
        self._config, self._log = config, log
        self._engine = None
        self._catalog: Optional[Catalog] = None
        self._handed = threading.Event()  # the catalog (or None) handed
        self._thread = threading.Thread(target=self._run, name="s18card")
        self._thread.start()

    def hand(self, catalog: Optional[Catalog]) -> None:
        """Give the thread the catalog to make the engine from; None
        ends it without an engine."""
        if not self._handed.is_set():
            self._catalog = catalog
            self._handed.set()

    def _run(self) -> None:
        log = self._log
        log.mark("card_started")
        try:
            import torch

            log.mark("torch_imported")
            device = self._config.device()
            # a value read, not only a synchronize: the first copy to the
            # host is part of the start
            torch.ones(8, dtype=torch.int64, device=device).sum().item()
            log.mark("cuda_ready")
            if device.type == "cuda":
                from ..ops import _kernels

                _kernels.load_all(_kernels.NAMES)
            log.mark("kernels_loaded")
            if self._config.mesh_devices > 1:
                from ..parallel import dist_compiled, dist_engine  # noqa: F401
            from ..engine import compiled, executor  # noqa: F401

            log.mark("engine_imported")
            self._handed.wait()
            if self._catalog is None:
                return
            self._engine = make_engine(self._catalog, self._config)
            log.mark("engine_built")
        except BaseException as exc:  # noqa: BLE001 — engine() raises it
            self.error = exc
            return
        finally:
            self.built.set()
        try:
            self._engine.prefetch()
        except BaseException as exc:  # noqa: BLE001 — serve raises it
            self.error = exc
        finally:
            log.mark("prefetch_done")

    def engine(self):
        """The engine, once made; the thread's exception if it failed
        before."""
        self.built.wait()
        if self._engine is None:
            raise self.error
        return self._engine

    def join(self) -> Optional[BaseException]:
        self.hand(None)
        self._thread.join()
        return self.error


class _HostTier:
    """The warm-up tier: until `closed` is set, a query whose bindings
    reference at most config.warmup_oracle base rows (counted per
    binding) answers on the host.  A forest answers by message passing
    (no materialization), anything else by the NumPy oracle with the
    engine's intermediate cap; past that cap (OracleOverflow) the
    engine answers.  Any other exception propagates."""

    def __init__(self, catalog: Catalog, config: EngineConfig,
                 closed: threading.Event, log: ServeLog):
        self._catalog, self._closed, self._log = catalog, closed, log
        self._bound = config.warmup_oracle
        self._cap = total_limit(config)
        self._lock = threading.Lock()

    def answer(self, q: Query) -> Optional[str]:
        if self._closed.is_set():
            return None
        rows = sum(self._catalog.relation(r).num_tuples for r in q.relations)
        if rows > self._bound:
            return None
        from ..engine.factorized import execute_query_factorized_np
        from ..engine.oracle import OracleOverflow, execute_query_numpy

        line = execute_query_factorized_np(q, self._catalog)
        if line is None:
            try:
                line = execute_query_numpy(q, self._catalog,
                                           max_rows=self._cap)
            except OracleOverflow:
                return None
        with self._lock:
            self._log.warmup_host += 1
        return line


def serve(stdin: IO[str], stdout: IO[str],
          config: Optional[EngineConfig] = None,
          log: Optional[ServeLog] = None):
    """Answer the protocol on stdin; returns the engine that served.
    `log`, if given, receives the start's steps and the warm-up tier's
    count."""
    config = config or EngineConfig.from_env()
    log = ServeLog() if log is None else log
    card = None if config.backend == "numpy" else _Card(config, log)
    try:
        catalog = _read_catalog(stdin, config, log)
        if card is None:
            engine = make_engine(catalog, config)
            _answer(stdin, stdout, catalog, config, log, lambda: engine,
                    None, False)
            return engine
        card.hand(catalog)
        grouped = config.mesh_devices > 1 and process_env() is not None
        if not config.async_prep or (grouped and config.warm_replay):
            if card.join() is not None:  # prefetch before the first query
                raise card.error
        tier = (None if grouped or config.warmup_oracle == 0
                or card.built.is_set()
                else _HostTier(catalog, config, card.built, log))
        _answer(stdin, stdout, catalog, config, log, card.engine, tier,
                grouped)
    except BaseException as exc:
        if card is not None and card.join() not in (None, exc):
            exc.add_note(f"the engine's thread failed too: {card.error!r}")
        raise
    if card.join() is not None:
        raise card.error
    return card.engine()


def _read_catalog(stdin: IO[str], config: EngineConfig,
                  log: ServeLog) -> Catalog:
    """The relations named on stdin up to `Done`."""
    paths: List[str] = []
    for raw in stdin:
        line = raw.strip()
        if line == "Done":
            break
        if line:
            paths.append(line)
    log.mark("done_read")
    catalog = Catalog.from_files(paths, native=config.native)
    log.mark("catalog_loaded")
    return catalog


def _answer(stdin: IO[str], stdout: IO[str], catalog: Catalog,
            config: EngineConfig, log: ServeLog, engine,
            tier: Optional[_HostTier], grouped: bool) -> None:
    """The query batches on stdin, each answered by `tier` where it
    answers, else by `engine()`; `grouped`: under a process group."""
    from concurrent.futures import ThreadPoolExecutor

    def start(q):
        # a str is the NULL answer of a malformed line
        if isinstance(q, str):
            return q
        line = None if tier is None else tier.answer(q)
        return line if line is not None else engine().execute_async(q)

    def run_batch(batch: list, pool) -> None:
        # Dispatch the whole batch before fetching any result line.
        results = (list(pool.map(start, batch)) if pool is not None
                   else [start(q) for q in batch])
        if all(isinstance(r, str) for r in results):
            lines = results  # answered on the host: no torch needed
        else:
            from ..engine.executor import format_batch

            lines = format_batch(results)
        for line in lines:
            stdout.write(line + "\n")
        stdout.flush()
        if lines:
            log.marks.setdefault("first_line", time.perf_counter())
            log.mark("last_line")

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
    finally:
        if pool is not None:
            pool.shutdown()


def _in_group(config: EngineConfig) -> bool:
    """Whether this process serves in a process group."""
    if config.mesh_devices == 1 or config.backend == "numpy":
        return False
    from ..parallel.mesh import process_group

    return process_group() is not None


def run_protocol(stdin: IO[str], stdout: IO[str],
                 config: Optional[EngineConfig] = None) -> Dict[str, int]:
    log = ServeLog()
    engine = serve(stdin, stdout, config, log)
    return dict(engine.tiers, warmup_host=log.warmup_host)


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


def kernel_launches() -> Dict[str, int]:
    """K1/K4/K5 launches in this process (ops.ms_join.LAUNCHES,
    ops.radix_join.LAUNCHES); 0 for a kernel whose module was never
    imported, so that S18_BACKEND=numpy still imports no torch."""
    ops = __name__.rsplit(".", 2)[0] + ".ops"
    ms_join = sys.modules.get(ops + ".ms_join")
    radix_join = sys.modules.get(ops + ".radix_join")
    return dict(K1=ms_join.LAUNCHES if ms_join else 0,
                K4=radix_join.LAUNCHES["slot_fill"] if radix_join else 0,
                K5=radix_join.LAUNCHES["probe_counts"] if radix_join else 0)


def _process_report(engine, t0: float, t_serving: Optional[float]) -> str:
    """The `process {..}` line of a rank (module docstring)."""
    import collections

    from ..parallel import collectives
    from ..parallel.mesh import process_group
    from ..parallel.multihost import TRANSPORT

    rank, world = process_group()
    end = time.perf_counter()
    t_serving = end if t_serving is None else t_serving
    return "process " + json.dumps(dict(
        rank=rank, world=world, transport=TRANSPORT,
        collectives=dict(collectives.CALLS),
        launches=kernel_launches(),
        counts=dict(engine.counts), tiers=dict(engine.tiers),
        join_strategies=dict(collections.Counter(
            getattr(engine, "join_strategies", ()))),
        prep_s=t_serving - t0, timed_s=end - t_serving))


def process_start() -> float:
    """This process's start on the time.perf_counter() clock, from its
    start time in /proc (clock ticks, 10 ms on Linux); now where /proc
    has none."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            # the fields after "pid (comm)": starttime is the 20th
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return now
    return now - age


def one_malloc_arena() -> bool:
    """Make every thread of this process allocate from glibc's main
    malloc arena (mallopt M_ARENA_MAX = 1); False where the C library has
    no mallopt.  A new thread otherwise gets an arena of its own, grown
    in mmap'd heaps, and `import torch`'s many small allocations then
    take seconds longer in the card's thread than in the main thread on
    the H100 machine (chip_smoke.py's `fresh process:` line).  glibc fixes
    the limit when a thread first needs an arena, so call this before
    the process starts a thread."""
    import ctypes

    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = (ctypes.c_int, ctypes.c_int)
    mallopt.restype = ctypes.c_int
    m_arena_max = -8  # malloc.h
    return mallopt(m_arena_max, 1) == 1


def main() -> None:
    origin = process_start()
    one_malloc_arena()
    t0 = time.perf_counter()
    stdin = _Clocked(sys.stdin)
    config = EngineConfig.from_env()
    log = ServeLog()
    try:
        try:
            engine = serve(stdin, sys.stdout, config, log)
        finally:
            print("start " + json.dumps(log.timeline(origin)),
                  file=sys.stderr)
        print("kernel launches: " + " ".join(
            f"{k}={v}" for k, v in kernel_launches().items()),
            file=sys.stderr)
        print(f"engine {type(engine).__name__}:" + "".join(
            f" {k}={v}" for k, v in engine.counts.items()), file=sys.stderr)
        print("served by tier: " + " ".join(
            f"{k}={v}" for k, v in engine.tiers.items())
            + f" warmup_host={log.warmup_host}", file=sys.stderr)
        if _in_group(config):
            print(_process_report(engine, t0, stdin.t_serving),
                  file=sys.stderr)
    finally:
        if _in_group(config):
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
