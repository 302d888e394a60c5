"""Relation binaries of the benchmark workloads, from their seeds.

The reference's generator (`tools/gen_workload.py`) writes NAME.init,
NAME.work and NAME.result and relation files r0, r1, ...; the .work and
.result files are committed, the relation binaries are not.  This module
regenerates the binaries without the reference package: it makes the
same random draws in the same order as the reference's
`gen_relation` and its lookup-table set-up (the bigdom/zipfbig LUT first,
then every relation before any query), so the committed .result files
hold for what it writes.

Run:  python -m sigmod2018_tpu_torch.tools.workload OUT_DIR \
          --profile uniform --rows 2000000 --relations 4 \
          --keyspace 1048576 --seed 7
(the parameters of workloads/big in tools/regen_workloads.sh).
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..storage.relation import Relation, store_relation

PROFILES = ("uniform", "zipf", "scaled", "bigdom", "zipfbig")


def gen_relation(rng: np.random.Generator, rows: int, cols: int,
                 profile: str, keyspace: int,
                 lut: Optional[np.ndarray] = None) -> Relation:
    data = []
    for _ in range(cols):
        if profile == "zipf":
            col = np.minimum(rng.zipf(1.3, size=rows),
                             keyspace).astype(np.uint64)
        elif profile == "bigdom":
            # keyspace distinct keys shared across relations via the LUT,
            # spread over a huge domain (no key tables possible)
            col = lut[rng.integers(0, keyspace, size=rows)]
        elif profile == "zipfbig":
            ranks = np.minimum(rng.zipf(1.3, size=rows),
                               keyspace).astype(np.int64) - 1
            col = lut[ranks]
        else:
            col = rng.integers(0, keyspace, size=rows, dtype=np.uint64)
        data.append(col)
    return Relation(columns=data)


def make_lut(rng: np.random.Generator, keyspace: int,
             domain: int) -> np.ndarray:
    """keyspace distinct keys drawn from [0, domain), in random order."""
    lut = np.unique(rng.integers(0, domain, size=2 * keyspace,
                                 dtype=np.uint64))
    if lut.size < keyspace:
        raise ValueError(f"domain {domain} too small for {keyspace} keys")
    return rng.permutation(lut)[:keyspace]


def write_relations(out: Path, profile: str, rows: int, relations: int,
                    keyspace: int, seed: int, domain: int = 1 << 40,
                    scale: int = 10) -> List[Path]:
    """Write r0..r{relations-1} under `out`; returns their paths."""
    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r}")
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    if profile == "scaled":
        rows *= scale
    lut = (make_lut(rng, keyspace, domain)
           if profile in ("bigdom", "zipfbig") else None)
    paths = []
    for i in range(relations):
        path = out / f"r{i}"
        store_relation(gen_relation(rng, rows, 3, profile, keyspace, lut),
                       path)
        paths.append(path)
    return paths


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--profile", default="uniform", choices=PROFILES)
    ap.add_argument("--domain", type=int, default=1 << 40)
    ap.add_argument("--relations", type=int, default=6)
    ap.add_argument("--rows", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--keyspace", type=int, default=1000)
    args = ap.parse_args()
    for p in write_relations(Path(args.out), args.profile, args.rows,
                             args.relations, args.keyspace, args.seed,
                             args.domain, args.scale):
        print(p)


if __name__ == "__main__":
    main()
