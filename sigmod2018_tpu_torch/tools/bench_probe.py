"""The two size crossovers of the join family, measured on the card.
Counterpart of the JAX package's tools/bench_probe.py.

    python -m sigmod2018_tpu_torch.tools.bench_probe [--lo 12] [--hi 23]
        [--platform cuda|cpu]

Per size 2^lo .. 2^hi (both sides that many rows, all live, keys below
half the size and shifted past 32 bits):

- probe crossover: an intermediate join's counts by searchsorted ranks
  (ops/sort_join.py::join_probe_count) against the staircase kernel
  (ops/ms_join.py::join_probe_count_ms: a probe-side sort, K1, two
  unsorts), the build side sorted beforehand for both.  The choice
  ms_join.EMIT_MS_MIN_ROWS makes in join_probe_count_auto.  Both must
  give the same cnt, the same lo where cnt > 0, and the same total;
- fused crossover: a fused final join by searchsorted ranks over a
  presorted build side (ops/agg_join.py::join_checksum_fused_presorted)
  against the staircase member (ops/ms_join.py::ms_fused, the same
  presorted build side), one value column a side: the choice
  radix_join.RADIX_MIN_ROWS makes in ms_member_selected.  Both must give
  the same count and sums.  The staircase member is also timed with the
  probe side presorted too (`ms2`), as the engine calls it when both
  sides are unfiltered base columns with prep-time sorts.

Each crossover printed is the smallest measured size from which the
staircase path is faster at every larger measured size (None: it never
is), in device time.  Times are utils/timing.py::time_call (CUDA events
with the L2 flushed on a card, the host clock on the CPU).  On a card
each line also names the calls that are host-bound (the host takes as
long to issue the call as the card to run it: back to back, such a call
costs its host time), and the crossover line lists the sizes with any
host-bound call, where the engine's choice turns on host dispatch and
not on the card.  This tool changes no threshold.  Runs on the card
unless --platform cpu; without a card it raises.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from ..utils.timing import REPS

# the timed calls of a size: (row key, label)
CALLS = [("probe_ss", "probe searchsorted"), ("probe_ms", "probe staircase"),
         ("fused_ss", "fused searchsorted"), ("fused_ms", "fused staircase"),
         ("fused_ms2", "fused ms2")]


def crossover(rows: list, key: str) -> Optional[int]:
    """The smallest log2 size from which rows' ratio[key] > 1 (the
    staircase path faster) holds at every larger size, or None."""
    best = None
    for row in reversed(rows):
        if row[key] <= 1:
            break
        best = row["log2"]
    return best


def run(lo: int = 12, hi: int = 23, platform: str = "cuda",
        reps: int = REPS) -> dict:
    """Prints a line per size and the crossovers; returns {"rows": [...],
    "probe_crossover", "fused_crossover", "fused2_crossover": each a log2
    size or None, "host_bound": the log2 sizes with a host-bound call}."""
    from ..ops import (join_build, join_checksum_fused_presorted,
                       join_probe_count, join_probe_count_ms, ms_fused)
    from ..ops.ms_join import EMIT_MS_MIN_ROWS
    from ..ops.radix_join import RADIX_MIN_ROWS
    from ..utils.timing import clock_note, flush_buffer, time_call, tool_device
    from .smoke import as_u64

    device = tool_device(platform)
    note = clock_note(device)
    flush = flush_buffer(device)
    rng = np.random.default_rng(0)
    print(f"# bench_probe: searchsorted against the staircase kernel, "
          f"2^{lo}..2^{hi} rows a side ({note})", flush=True)
    rows = []
    for logn in range(lo, hi + 1):
        n = 1 << logn

        def dev(a):
            return torch.from_numpy(a.view(np.int64)).to(device)

        kb = dev(rng.integers(0, max(n // 2, 1), n).astype(np.uint64) << 20)
        kp = dev(rng.integers(0, max(n // 2, 1), n).astype(np.uint64) << 20)
        vb = dev(rng.integers(0, 1 << 40, (1, n)).astype(np.uint64))
        vp = dev(rng.integers(0, 1 << 40, (1, n)).astype(np.uint64))
        sk, perm = join_build(kb, n)
        presorted_p = join_build(kp, n)

        a = join_probe_count(sk, n, kp, n)
        b = join_probe_count_ms(sk, n, kp, n)
        hit = a[1] > 0
        if not (torch.equal(a[1], b[1]) and torch.equal(a[0][hit], b[0][hit])
                and int(a[3]) == int(b[3])):
            raise AssertionError(f"2^{logn}: the probe members' cnt, lo or "
                                 f"total differ ({int(a[3])}, {int(b[3])})")
        fa = as_u64(join_checksum_fused_presorted(sk, perm, vb, n, kp, vp, n))
        fb = as_u64(ms_fused(kb, vb, n, kp, vp, n, presorted_b=(sk, perm)))
        fc = as_u64(ms_fused(kb, vb, n, kp, vp, n, presorted_b=(sk, perm),
                             presorted_p=presorted_p))
        if not fa == fb == fc:
            raise AssertionError(f"2^{logn}: the fused members differ: "
                                 f"{fa} against {fb} and {fc}")

        timings = {
            "probe_ss": time_call(
                lambda: join_probe_count(sk, n, kp, n), flush, reps),
            "probe_ms": time_call(
                lambda: join_probe_count_ms(sk, n, kp, n), flush, reps),
            "fused_ss": time_call(
                lambda: join_checksum_fused_presorted(sk, perm, vb, n, kp,
                                                      vp, n), flush, reps),
            "fused_ms": time_call(
                lambda: ms_fused(kb, vb, n, kp, vp, n,
                                 presorted_b=(sk, perm)), flush, reps),
            "fused_ms2": time_call(
                lambda: ms_fused(kb, vb, n, kp, vp, n,
                                 presorted_b=(sk, perm),
                                 presorted_p=presorted_p), flush, reps)}
        row = {"log2": logn}
        for key, t in timings.items():
            row[f"{key}_ms"] = t.ms
            row[f"{key}_host_ms"] = t.host_ms
        row["host_bound"] = [label for key, label in CALLS
                             if timings[key].host_bound]
        row["probe_speedup"] = row["probe_ss_ms"] / row["probe_ms_ms"]
        row["fused_speedup"] = row["fused_ss_ms"] / row["fused_ms_ms"]
        row["fused2_speedup"] = row["fused_ss_ms"] / row["fused_ms2_ms"]
        rows.append(row)
        bound = (f"; host-bound: {', '.join(row['host_bound'])}"
                 if row["host_bound"] else "")
        print(f"bench_probe 2^{logn:<3d} probe: searchsorted "
              f"{row['probe_ss_ms']:9.4f} ms, staircase "
              f"{row['probe_ms_ms']:9.4f} ms ({row['probe_speedup']:5.2f}x); "
              f"fused: searchsorted {row['fused_ss_ms']:9.4f} ms, staircase "
              f"{row['fused_ms_ms']:9.4f} ms ({row['fused_speedup']:5.2f}x), "
              f"ms2 {row['fused_ms2_ms']:9.4f} ms; "
              f"{int(a[3])} matches, parity held{bound} ({note})", flush=True)
        if device.type == "cuda":
            issue = ", ".join(f"{label} {timings[key].host_ms:.4f}"
                              for key, label in CALLS)
            print(f"bench_probe 2^{logn:<3d} host issue ms: {issue} ({note})",
                  flush=True)
    probe_x = crossover(rows, "probe_speedup")
    fused_x = crossover(rows, "fused_speedup")
    fused2_x = crossover(rows, "fused2_speedup")
    host_bound = [row["log2"] for row in rows if row["host_bound"]]

    def fmt(x):
        return "none in range" if x is None else f"2^{x}"

    def threshold(n):  # in force: S18_EMIT_MS_MIN, S18_RADIX_MIN
        power = n > 0 and n & (n - 1) == 0
        return f"2^{n.bit_length() - 1}" if power else str(n)

    print(f"bench_probe crossovers over 2^{lo}..2^{hi}: probe {fmt(probe_x)} "
          f"(EMIT_MS_MIN_ROWS = {threshold(EMIT_MS_MIN_ROWS)}), "
          f"fused {fmt(fused_x)}, both sides presorted {fmt(fused2_x)} "
          f"(RADIX_MIN_ROWS = {threshold(RADIX_MIN_ROWS)}); "
          f"sizes with a host-bound call: "
          f"{', '.join(f'2^{x}' for x in host_bound) or 'none'} ({note})",
          flush=True)
    return {"rows": rows, "probe_crossover": probe_x,
            "fused_crossover": fused_x, "fused2_crossover": fused2_x,
            "host_bound": host_bound}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lo", type=int, default=12)
    ap.add_argument("--hi", type=int, default=23)
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(args.lo, args.hi, args.platform)
    return 0


if __name__ == "__main__":
    sys.exit(main())
