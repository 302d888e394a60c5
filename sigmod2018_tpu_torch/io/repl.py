"""stdin/stdout protocol driver (counterpart of `sigmod2018_tpu/io/repl.py`).

Protocol:
  1. one relation file path per line, until the line "Done"
  2. query lines in batches; "F" ends a batch (the whole batch executes
     then), "Exit" or EOF terminates
  3. one output line per query: space-separated uint64 checksums, or NULL
     per projection on an empty result

The prep phase (loading, stats, device copies, presorts, key tables) runs
before the first batch; the contest harness does not time it.

A malformed query line — text that does not parse, or that names a
relation, binding or column that does not exist — answers a NULL line
and the batch goes on, as in the reference package.  Any other error is
a fault of the engine or the device and propagates.

The engine is `CompiledTorchEngine` (engine/compiled.py), or the
operator-granular `TorchEngine` under S18_COMPILE_QUERIES=0.  `serve`
returns it; `run_protocol` returns how many queries each serving tier
answered (`TorchEngine.tiers`).  `main` prints the engine's counts (host
reads of intermediate totals and, for the compiled engine, how each
query was sized) and then the tiers on stderr at exit.
"""

from __future__ import annotations

import sys
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


def serve(stdin: IO[str], stdout: IO[str],
          config: Optional[EngineConfig] = None):
    """Answer the protocol on stdin; returns the engine that served."""
    from concurrent.futures import ThreadPoolExecutor

    from ..engine.compiled import CompiledTorchEngine
    from ..engine.executor import TorchEngine, format_batch

    config = config or EngineConfig.from_env()
    paths: List[str] = []
    for raw in stdin:
        line = raw.strip()
        if line == "Done":
            break
        if line:
            paths.append(line)

    catalog = Catalog.from_files(paths)
    engine = (CompiledTorchEngine if config.compile_queries
              else TorchEngine)(catalog, config)
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

    pool = (ThreadPoolExecutor(config.batch_workers,
                               thread_name_prefix="s18batch")
            if config.batch_workers > 1 else None)
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
    return engine


def run_protocol(stdin: IO[str], stdout: IO[str],
                 config: Optional[EngineConfig] = None) -> Dict[str, int]:
    return dict(serve(stdin, stdout, config).tiers)


def main() -> None:
    engine = serve(sys.stdin, sys.stdout)
    print(f"engine {type(engine).__name__}: " + " ".join(
        f"{k}={v}" for k, v in engine.counts.items()), file=sys.stderr)
    print("served by tier: " + " ".join(
        f"{k}={v}" for k, v in engine.tiers.items()), file=sys.stderr)


if __name__ == "__main__":
    main()
