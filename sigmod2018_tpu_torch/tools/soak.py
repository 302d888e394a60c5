"""Differential soak: N random queries in chunks, each chunk a fresh process
running tools/fuzz.py (every engine against the NumPy oracle).
Counterpart of the JAX package's tools/soak.py.

    python -m sigmod2018_tpu_torch.tools.soak [N] [SEED] [CHUNK]
        [--platform cuda|cpu] [--join auto|sort|ms|radix|qd]

Chunk i fuzzes seed SEED + i.  Every third chunk runs the mesh engines
on 8 shards (on the card, or on the CPU with --platform cpu) at a third
of CHUNK queries, as the JAX soak does.  Fresh processes exercise the
cold path (first launches, empty device caches) again and again.  Each
chunk runs with S18_PREP_CACHE=0: random texts never repeat across
processes, so persisting their learned classes would only pile up files.

One line per chunk with the fuzz's last line; a chunk that exits nonzero
or whose last line lacks `0 failures` prints its output's tail, and the
exit code is then 1.
Runs on the card unless --platform cpu; without a card it raises.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

from ..utils.timing import tool_device
from .fuzz import JOIN_ALGOS

REPO = Path(__file__).resolve().parents[2]
MESH_SHARDS = 8


def chunk_command(n: int, seed: int, mesh: bool, platform: str,
                  join: str) -> list:
    args = [sys.executable, "-m", "sigmod2018_tpu_torch.tools.fuzz", str(n),
            str(seed)]
    if mesh:
        args += ["mesh", "--shards", str(MESH_SHARDS)]
    return args + ["--platform", platform, "--join", join]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=600)
    ap.add_argument("seed", nargs="?", type=int, default=99)
    ap.add_argument("chunk", nargs="?", type=int, default=150)
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--join", default="auto", choices=JOIN_ALGOS)
    args = ap.parse_args(argv)
    tool_device(args.platform)  # no card: raise here, not in every chunk
    env = dict(os.environ, S18_PREP_CACHE="0", PYTHONPATH=str(REPO))
    fails = done = chunk_i = 0
    while done < args.n:
        mesh = chunk_i % 3 == 2
        n = min(args.chunk // 3 if mesh else args.chunk, args.n - done)
        seed = args.seed + chunk_i
        proc = subprocess.run(
            chunk_command(n, seed, mesh, args.platform, args.join),
            capture_output=True, text=True, timeout=3600, env=env, cwd=REPO)
        lines = proc.stdout.strip().splitlines()
        tail = lines[-1] if lines else ""
        exit_note = ("" if proc.returncode == 0
                     else f" (exit {proc.returncode})")
        print(f"chunk {chunk_i} (seed {seed}"
              f"{f', mesh {MESH_SHARDS}' if mesh else ''}): {tail}"
              f"{exit_note}", flush=True)
        # the whole count: "10 failures" also holds "0 failures"
        if proc.returncode != 0 or not tail.endswith(": 0 failures"):
            fails += 1
            print(proc.stdout[-3000:])
            print(proc.stderr[-2000:], file=sys.stderr)
        done += n
        chunk_i += 1
    print(f"soak: {done} queries in {chunk_i} chunks, "
          f"{'OK' if fails == 0 else f'{fails} FAILING CHUNKS'}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
