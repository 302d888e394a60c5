"""Primitive rates on the card: the numbers the port's kernel and op
designs cite.  Counterpart of the JAX package's tools/microbench.py.

    python -m sigmod2018_tpu_torch.tools.microbench [--log2-rows 23]
        [--platform cuda|cpu]

On int64 tensors (u64 bit patterns, the port's column type) of n = 2^23
rows by default:

  copy           x + 1, the memory-rate sanity check
  gather         a[idx], u64 and u32 rows, int64 indices at random and in
                 random 1,024-row blocks: what a gather by a prep-time
                 permutation costs (engine/factorized.py's messages)
  scatter-add    out.index_add_(0, idx, a) at random indices, distinct
                 ones: the rate a scatter reaches when no two rows share
                 an address.  ops/sort_join.py::join_emit no longer
                 scatters: its rows without matches all aimed at one
                 spare slot, whose atomics serialised, so each output
                 slot now finds its row by a searchsorted (the line
                 below), which writes nothing shared
  sort x1        torch.sort of the keys (it returns the permutation too)
  sort +2        the sort, then two payloads carried by gathers through
                 its permutation (how ops/u64.py::sort_u64 callers carry
                 value columns)
  cumsum         the inclusive prefix sum (prefix and ccum tables)
  searchsorted   torch.searchsorted of n queries in n sorted keys (the
                 sort member's probe)

Each line gives the median time (utils/timing.py::time_call: CUDA
events with the L2 flushed on a card, the host clock on the CPU), the
bytes the call must move (each input read once, each output written
once: `BYTES`), their rate and its share of the H100's memory rate
(utils/floors.py::HBM_BYTES_PER_S), and rows per second.  Runs on the
card unless --platform cpu; without a card it raises.  On a card each
line also gives the host's issue time, and says host-bound where the
host takes as long to issue the call as the card to run it.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..utils.timing import REPS

# bytes per row each primitive must move: inputs read once, outputs
# written once (int64 values and indices are 8 bytes, u32 rows 4)
BYTES = {
    "copy u64": 8 + 8,
    "gather u64 random": 8 + 8 + 8,      # index, row read, row written
    "gather u64 1K-block": 8 + 8 + 8,
    "gather u32 random": 8 + 4 + 4,
    "gather u32 1K-block": 8 + 4 + 4,
    "scatter-add u64": 8 + 8 + 8,        # index, value, out row
    "sort u64 x1": 8 + 8 + 8,            # keys in; sorted keys, perm out
    "sort u64 +2 payloads": 8 * 3 + 8 * 4,  # 3 in; keys, perm, 2 payloads
    "cumsum u64": 8 + 8,
    "searchsorted u64": 8 + 8 + 8,       # sorted keys, queries, ranks
}


def cases(n: int, device: torch.device) -> dict:
    """{name: fn} of the primitives on n rows made from a seed."""
    gen = torch.Generator(device=device).manual_seed(0)
    x64 = torch.randint(0, 1 << 60, (n,), generator=gen, device=device)
    y64 = torch.randint(0, 1 << 60, (n,), generator=gen, device=device)
    z64 = torch.randint(0, 1 << 60, (n,), generator=gen, device=device)
    x32 = x64.to(torch.int32)
    idx_rand = torch.randperm(n, generator=gen, device=device)
    blocks = torch.randperm(max(n // 1024, 1), generator=gen, device=device)
    idx_block = (blocks[:, None] * 1024
                 + torch.arange(min(n, 1024), device=device)).reshape(-1)
    skeys = torch.sort(x64).values
    out = torch.zeros_like(x64)

    def sort3():
        s, perm = torch.sort(x64)
        return s, perm, y64[perm], z64[perm]

    return {
        "copy u64": lambda: x64 + 1,
        "gather u64 random": lambda: x64[idx_rand],
        "gather u64 1K-block": lambda: x64[idx_block],
        "gather u32 random": lambda: x32[idx_rand],
        "gather u32 1K-block": lambda: x32[idx_block],
        "scatter-add u64": lambda: out.zero_().index_add_(0, idx_rand, x64),
        "sort u64 x1": lambda: torch.sort(x64),
        "sort u64 +2 payloads": sort3,
        "cumsum u64": lambda: torch.cumsum(x64, 0),
        "searchsorted u64": lambda: torch.searchsorted(skeys, x64),
    }


def run(log2_rows: int = 23, platform: str = "cuda",
        reps: int = REPS) -> dict:
    """Prints one line per primitive; returns {name: {ms, host_ms,
    host_bound, bytes, gbps, hbm_share, mrows}}."""
    from ..utils.floors import HBM_BYTES_PER_S
    from ..utils.timing import clock_note, flush_buffer, time_call, tool_device

    device = tool_device(platform)
    n = 1 << log2_rows
    note = clock_note(device)
    flush = flush_buffer(device)
    print(f"# microbench: n = 2^{log2_rows} int64 rows; memory rate "
          f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s ({note})", flush=True)
    results = {}
    for name, fn in cases(n, device).items():
        t = time_call(fn, flush, reps)
        ms = t.ms
        nbytes = BYTES[name] * n
        gbps = nbytes / ms / 1e6
        results[name] = dict(ms=ms, host_ms=t.host_ms,
                             host_bound=t.host_bound, bytes=nbytes, gbps=gbps,
                             hbm_share=gbps * 1e9 / HBM_BYTES_PER_S,
                             mrows=n / ms / 1e3)
        print(f"microbench {name:22s} {ms:9.4f} ms  {gbps:8.1f} GB/s "
              f"({results[name]['hbm_share']:6.1%} of the memory rate)  "
              f"{n / ms / 1e3:9.1f} Mrows/s  [{nbytes} bytes]{t.tag()} "
              f"({note})",
              flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2-rows", type=int, default=23)
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(args.log2_rows, args.platform)
    return 0


if __name__ == "__main__":
    sys.exit(main())
