"""Relation binaries of the benchmark workloads, from their seeds.

The reference's generator (`tools/gen_workload.py`) writes NAME.init,
NAME.work and NAME.result and relation files r0, r1, ...; the .work and
.result files are committed, the relation binaries are not.  This module
regenerates the binaries without the reference package: it makes the
same random draws in the same order as the reference's
`gen_relation` and its lookup-table set-up (the bigdom/zipfbig LUT first,
then every relation before any query), so the committed .result files
hold for what it writes.  Zipf draws come from `zipf_draws`, this
module's copy of the sampler of NumPy up to 2.0, under which those files
were made: `Generator.zipf` draws other values from the same stream
since NumPy 2.1.

Run:  python -m sigmod2018_tpu_torch.tools.workload OUT_DIR \
          --profile uniform --rows 2000000 --relations 4 \
          --keyspace 1048576 --seed 7
(the parameters of workloads/big in tools/regen_workloads.sh).
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..storage.relation import Relation, store_relation

PROFILES = ("uniform", "zipf", "scaled", "bigdom", "zipfbig")


def zipf_draws(rng: np.random.Generator, a: float, size: int) -> np.ndarray:
    """`rng.zipf(a, size)` as NumPy up to 2.0 computes it (Devroye's
    rejection sampler, legacy `random_zipf`), whatever NumPy is installed,
    leaving `rng` in the state that call leaves it in.

    Every round of the sampler reads two doubles, U = 1 - next and V =
    next, and accepts X = floor(U ** (-1 / (a - 1))) or not, so the
    samples are the accepted rounds of the double stream in order.  The
    stream is read in blocks; the last block is read again up to the
    round of the last sample only, so no double past it is consumed."""
    am1 = a - 1.0
    b = 2.0 ** am1
    out = np.empty(size, dtype=np.int64)
    have = 0
    while have < size:
        rounds = int((size - have) * 1.25) + 1024
        state = rng.bit_generator.state
        d = rng.random(2 * rounds)
        u, v = 1.0 - d[0::2], d[1::2]
        with np.errstate(over="ignore"):
            x = np.floor(np.power(u, -1.0 / am1))
            # np.power and the C library's pow (NumPy's sampler) can
            # differ in the last bit, which floor keeps in a large value:
            # the few draws past 2^40 take the library's
            for i in np.flatnonzero(x >= 2.0 ** 40):
                x[i] = math.floor(math.pow(u[i], -1.0 / am1))
            ok = (x <= float(np.iinfo(np.int64).max)) & (x >= 1.0)
            t = np.power(1.0 + 1.0 / np.where(ok, x, 1.0), am1)
            ok &= v * x * (t - 1.0) / (b - 1.0) <= t / b
        hits = np.flatnonzero(ok)
        if hits.size > size - have:
            hits = hits[:size - have]
            rng.bit_generator.state = state
            rng.random(2 * (int(hits[-1]) + 1))
        out[have:have + hits.size] = x[hits].astype(np.int64)
        have += hits.size
    return out


def gen_relation(rng: np.random.Generator, rows: int, cols: int,
                 profile: str, keyspace: int,
                 lut: Optional[np.ndarray] = None) -> Relation:
    data = []
    for _ in range(cols):
        if profile == "zipf":
            col = np.minimum(zipf_draws(rng, 1.3, rows),
                             keyspace).astype(np.uint64)
        elif profile == "bigdom":
            # keyspace distinct keys shared across relations via the LUT,
            # spread over a huge domain (no key tables possible)
            col = lut[rng.integers(0, keyspace, size=rows)]
        elif profile == "zipfbig":
            ranks = np.minimum(zipf_draws(rng, 1.3, rows),
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
