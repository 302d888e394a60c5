"""Differential fuzz: random queries through the port's engines, each
line held against the NumPy oracle (engine/oracle.py).  Counterpart of
the JAX package's tests/_fuzz_impl.py.

    python -m sigmod2018_tpu_torch.tools.fuzz [N] [SEED] [mesh]
        [--platform cuda|cpu] [--join auto|sort|ms|radix|qd] [--shards 8]

`draw_case(SEED, N)` makes the NumPy calls of the JAX body in its order,
so a seed gives the same seven relations (five of 80-500 rows with keys
below 50; two whose first two columns sit at 2^34 and 2^22, past 32 bits
and past the key-table gate) and the same N query texts (cycles,
self-joins, duplicate bindings, filters): a failing text replays on the
JAX package.

Every query runs on each engine of the matrix, then once more on the
first engine (the per-text fast path):

- single device: `compiled` (CompiledTorchEngine, the default),
  `operator` (TorchEngine, compile_queries=False) and `compiled-nospec`
  (speculate=False);
- with `mesh`: the same three over parallel.make_mesh(--shards):
  `dist-compiled`, `dist-operator` and `dist-compiled-nospec`.

The JAX matrix's `nofuse` and `compiled-nofuse` have no counterpart: the
port's fused final join is always on (S18_FUSE is fixed).  At fuzz sizes
`auto` takes the sort and table members and launches no kernel, so
--join forces a member (EngineConfig.join_algo): `ms` runs the staircase
kernel K1, `radix` and `qd` the slot-fill and dual-count kernels K4 and
K5, on relations of tens of rows, empty after a filter as often as not.

One `FAIL <engine> <text> got .. want ..` line per miss; the last line is
`N queries x E engines: F failures`, and the exit code is 1 when F > 0.
Runs on the card unless --platform cpu; without a card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Sequence, Tuple

import numpy as np

JOIN_ALGOS = ("auto", "sort", "ms", "radix", "qd")


def draw_case(seed: int, n: int) -> Tuple[List[List[np.ndarray]], List[str]]:
    """(relations as lists of uint64 columns, n query texts) of a seed:
    the JAX body's draws, call for call."""
    rng = np.random.default_rng(seed)
    rels = []
    for n_rows in (500, 350, 200, 120, 80):
        rels.append([rng.integers(0, 50, size=n_rows).astype(np.uint64)
                     for _ in range(3)])
    for n_rows, base in ((150, 1 << 34), (100, 1 << 22)):
        big = [(base + rng.integers(0, 50, size=n_rows)).astype(np.uint64)
               for _ in range(2)]
        rels.append(big + [rng.integers(0, 50, size=n_rows).astype(np.uint64)])
    texts = []
    for _ in range(n):
        nrel = int(rng.integers(1, 5))
        bindings = list(rng.integers(0, len(rels), size=nrel))
        preds = []
        for b in range(1, nrel):
            preds.append(f'{b-1}.{rng.integers(0,3)}={b}.{rng.integers(0,3)}')
        if rng.random() < 0.3 and nrel >= 2:
            a, b2 = sorted(rng.choice(nrel, size=2, replace=False))
            preds.append(f'{a}.{rng.integers(0,3)}={b2}.{rng.integers(0,3)}')
        if rng.random() < 0.3:
            b3 = int(rng.integers(0, nrel))
            preds.append(f'{b3}.{rng.integers(0,3)}={b3}.{rng.integers(0,3)}')
        if rng.random() < 0.7:
            op = rng.choice(['<', '>', '='])
            preds.append(f'{rng.integers(0,nrel)}.{rng.integers(0,3)}{op}'
                         f'{rng.integers(0, 60)}')
        if not preds:
            preds.append(f'0.0>{rng.integers(0,50)}')
        views = ' '.join(f'{rng.integers(0, nrel)}.{rng.integers(0, 3)}'
                         for _ in range(int(rng.integers(1, 4))))
        texts.append(f"{' '.join(map(str, bindings))}|{'&'.join(preds)}|"
                     f"{views}")
    return rels, texts


def single_engines(catalog, config) -> list:
    """[(name, engine)] of the single-device matrix."""
    from ..engine.compiled import CompiledTorchEngine
    from ..engine.executor import TorchEngine

    return [("compiled", CompiledTorchEngine(catalog, config)),
            ("operator", TorchEngine(catalog, dataclasses.replace(
                config, compile_queries=False))),
            ("compiled-nospec", CompiledTorchEngine(
                catalog, dataclasses.replace(config, speculate=False)))]


def mesh_engines(catalog, config, mesh) -> list:
    """[(name, engine)] of the mesh matrix, every engine over `mesh`."""
    from ..parallel.dist_compiled import DistCompiledTorchEngine
    from ..parallel.dist_engine import DistTorchEngine

    return [("dist-compiled", DistCompiledTorchEngine(catalog, config, mesh)),
            ("dist-operator", DistTorchEngine(catalog, dataclasses.replace(
                config, compile_queries=False), mesh)),
            ("dist-compiled-nospec", DistCompiledTorchEngine(
                catalog, dataclasses.replace(config, speculate=False), mesh))]


def catalog_of(relations: Sequence[Sequence[np.ndarray]]):
    from ..storage.catalog import Catalog
    from ..storage.relation import Relation

    return Catalog([Relation(columns=list(cols)) for cols in relations])


def run(n: int, seed: int, *, platform: str = "cuda", join: str = "auto",
        shards: int = 0, out=None) -> int:
    """Fuzz n queries of `seed`; prints the FAIL lines and the summary
    line to `out` (stdout) and returns the number of failures.  shards
    > 0 runs the mesh matrix on that many shards."""
    from ..config import EngineConfig
    from ..engine.oracle import execute_query_numpy
    from ..frontend.parser import parse_query

    out = sys.stdout if out is None else out
    if join not in JOIN_ALGOS:
        raise ValueError(f"--join {join!r}: expected one of {JOIN_ALGOS}")
    relations, texts = draw_case(seed, n)
    catalog = catalog_of(relations)
    config = EngineConfig(platform=platform, join_algo=join,
                          mesh_devices=max(shards, 1))
    if shards:
        from ..parallel import make_mesh

        engines = mesh_engines(catalog, config, make_mesh(shards, platform))
    else:
        engines = single_engines(catalog, config)
    fails = 0
    for text in texts:
        q = parse_query(text)
        want = execute_query_numpy(q, catalog)
        # the repeat on the first engine takes the per-text fast path
        # (cached dispatch and learned classes): its invalidation logic
        for name, eng in engines + [(engines[0][0] + "-repeat",
                                     engines[0][1])]:
            got = eng.execute(q)
            if got != want:
                fails += 1
                print("FAIL", name, text, "got", got, "want", want, file=out,
                      flush=True)
    print(f"{n} queries x {len(engines)} engines: {fails} failures",
          file=out, flush=True)
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=200)
    ap.add_argument("seed", nargs="?", type=int, default=99)
    ap.add_argument("mode", nargs="?", choices=["mesh"],
                    help="run the mesh engines")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--join", default="auto", choices=JOIN_ALGOS)
    ap.add_argument("--shards", type=int, default=8,
                    help="shards of the mesh (with `mesh`)")
    args = ap.parse_args(argv)
    fails = run(args.n, args.seed, platform=args.platform, join=args.join,
                shards=args.shards if args.mode == "mesh" else 0)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
