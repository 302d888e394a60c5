"""The cost of one call of each collective of parallel/collectives.py.

    python -m sigmod2018_tpu_torch.tools.collective_cost [--platform cuda|cpu]

On a mesh of SHARDS shards (parallel/mesh.py::make_mesh): in one process
every shard is this process's and a collective is device copies;
started as the ranks of a process group (S18_COORD_ADDR, S18_NUM_PROCS,
S18_PROC_ID set, e.g. by parallel/launch.py::run_ranks) each rank owns
its shards and the collectives cross processes over gloo, staged
through host memory.  The cases are the calls the mesh engines make: a
psum and a pmax of one count per shard, an all_gather of 1,024 rows,
all_to_alls of [shards, rows] send buffers at 2^10, 2^14 and 2^17 rows,
and one ring hop (a ppermute of 2^14 rows to the next shard).

Each case is timed on the host clock around the call and a device
synchronize, since the engines use what a collective returns: the
median of REPS calls after one warm-up call.  Under a group the largest
all_to_all is also timed in its three parts (collectives.a2a_stage:
device to host and the send buffer's layout; a2a_exchange: gloo;
a2a_unstage: the received rows' layout and host to device), each the
median of REPS, with a barrier before the exchange so that it does not
time the other ranks' staging.  Prints one JSON line per process: world
size, rank, shards, platform, transport, per case the milliseconds and
the bytes this process's shards send, and the parts (null in one
process).  Runs on the card unless --platform cpu; without a card it
raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch
import torch.distributed as dist

from ..parallel import collectives, multihost
from ..parallel.mesh import make_mesh, process_group

SHARDS = 4
REPS = 15
A2A_ROWS = (1 << 10, 1 << 14, 1 << 17)


def _rows(mesh, gen: torch.Generator, shape) -> list:
    return [torch.randint(-(1 << 62), 1 << 62, shape, generator=gen).to(d)
            for d in mesh.local_devices]


def _cases(mesh, gen: torch.Generator) -> dict:
    """{name: (call, bytes sent by this process's shards)}."""
    n = mesh.size
    counts = _rows(mesh, gen, ())
    gather = _rows(mesh, gen, (1024,))
    hop = _rows(mesh, gen, (1 << 14,))
    ring = [(s, (s + 1) % n) for s in range(n)]
    out = {"psum 1 count": (lambda: collectives.psum(mesh, counts), 8),
           "pmax 1 count": (lambda: collectives.pmax(mesh, counts), 8),
           "all_gather 1,024 rows": (
               lambda: collectives.all_gather(mesh, gather), 8 * 1024)}
    for r in A2A_ROWS:
        send = _rows(mesh, gen, (n, r))
        out[f"all_to_all [{n}, {r:,}]"] = (
            lambda send=send: collectives.all_to_all(mesh, send), 8 * n * r)
    out["ppermute hop 16,384 rows"] = (
        lambda: collectives.ppermute(mesh, hop, ring), 8 * (1 << 14))
    return {k: (f, b * len(mesh.local)) for k, (f, b) in out.items()}


def _a2a_parts(mesh, gen: torch.Generator, sync) -> dict:
    """Median ms of the largest all_to_all's three parts (stage,
    exchange, unstage) under a group."""
    xs = _rows(mesh, gen, (mesh.size, A2A_ROWS[-1]))
    ms = {"stage": [], "exchange": [], "unstage": []}
    for rep in range(REPS + 1):  # the first is the warm-up
        sync()
        t0 = time.perf_counter()
        send = collectives.a2a_stage(mesh, xs)
        t1 = time.perf_counter()
        dist.barrier()
        t2 = time.perf_counter()
        recv = collectives.a2a_exchange(send)
        t3 = time.perf_counter()
        collectives.a2a_unstage(mesh, recv, xs)
        sync()
        t4 = time.perf_counter()
        if rep:
            for part, dt in (("stage", t1 - t0), ("exchange", t3 - t2),
                             ("unstage", t4 - t3)):
                ms[part].append(dt * 1e3)
    return {part: statistics.median(v) for part, v in ms.items()}


def run(platform: str = "cuda") -> dict:
    proc = multihost.init_distributed()
    mesh = make_mesh(SHARDS, platform)
    sync = (torch.cuda.synchronize if platform == "cuda"
            else (lambda: None))
    gen = torch.Generator().manual_seed(9)
    times = {}
    for name, (call, nbytes) in _cases(mesh, gen).items():
        call()
        sync()
        ms = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            call()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        times[name] = dict(ms=statistics.median(ms), bytes=nbytes)
    rank, world = proc or (0, 1)
    return dict(world=world, rank=rank, shards=SHARDS, platform=platform,
                transport=(multihost.TRANSPORT if proc
                           else "device copies in one process"),
                cases=times,
                a2a_parts=_a2a_parts(mesh, gen, sync) if proc else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    try:
        print(json.dumps(run(args.platform)), flush=True)
    finally:
        if process_group() is not None:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
