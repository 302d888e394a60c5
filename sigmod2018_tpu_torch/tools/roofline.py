"""Each join member and kernel stage on the card against its floor.
Counterpart of the JAX package's tools/roofline.py.

    python -m sigmod2018_tpu_torch.tools.roofline [--log2-rows 23]
        [--platform cuda|cpu]

Two sides of n = 2^23 rows (by default), every row live, keys uniform
below D = min(n, 2^22 - 2) (so a key table passes the engine's gate,
u + 3 <= 2^22), one value column a side:

- the radix member's stages at its static plan: `_prep_side` (one side's
  rotated-key sort carrying its values), K4 `slot_fill` of the build side
  (key + value) and K5 `probe_counts` of both sides' slot-filled keys,
  each against its bytes (kernel_bound for the kernels);
- the fused members end to end through ops.fused_join_auto: radix, qd,
  sort, table and table+pref (the build side's key table, perm and
  prefix tables made first, as prep makes them), and ms on the same keys
  and on full-range keys (the keys times an odd 64-bit constant: a
  bijection, so the answer is the same), each against the fused join's
  floor (utils/floors.py::fused_join_floors).  Every member's (count,
  sums) must equal the others';
- the ms member's stages: the sort of one side (join_build), K1
  `staircase_counts` and the unsort of its counts.

With kernel_stages=False (chip_smoke.py's phase 9, whose phase 3 times
K1, K4 and K5 at the kernel table's shapes) the K4, K5 and K1 stage
lines are left out.  Times are utils/timing.py::time_call (CUDA events
with the L2 flushed on a card, the host clock on the CPU); on a card each
line also gives the host's issue time, and says host-bound where the
host takes as long to issue the call as the card to run it.  The JAX
tool's limbs=2/1, key32 and tile-floor lines have no counterpart: the
port's keys are 8 bytes and its floors are bytes only (utils/floors.py
says why).  Runs on the card unless --platform cpu; without a card
it raises.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..utils.timing import REPS

FULL_RANGE_MUL = np.uint64(0x9E3779B97F4A7C15)  # odd: a bijection of u64


def key_domain(n: int) -> int:
    """Keys below this at n rows a side: at most n distinct, and a key
    table of the largest (u + 3 entries) within the engine's default
    gate, EngineConfig.key_table_max."""
    from ..config import EngineConfig

    return min(n, EngineConfig().key_table_max - 2)


def _line(name: str, t, nbytes: int, note: str) -> dict:
    """Prints a stage's line for its Timing `t`."""
    from ..utils.floors import HBM_BYTES_PER_S

    gbps = nbytes / t.ms / 1e6
    print(f"roofline {name:34s} {t.ms:9.4f} ms  {gbps:8.1f} GB/s "
          f"({gbps * 1e9 / HBM_BYTES_PER_S:6.1%} of the memory rate) "
          f"[{nbytes} bytes]{t.tag()} ({note})", flush=True)
    return dict(ms=t.ms, host_ms=t.host_ms, host_bound=t.host_bound,
                bytes=nbytes, gbps=gbps)


def run(log2_rows: int = 23, platform: str = "cuda", reps: int = REPS,
        kernel_stages: bool = True) -> dict:
    """Prints every line; returns {"stages": {name: {...}}, "members":
    {name: {ms, host_ms, host_bound, floor_ms, share}}, "floor_ms": x}."""
    from ..ops import join_build, ms_join, radix_join as rj
    from ..ops import qd_static_plan, staircase_counts
    from ..utils.floors import fused_join_floors, kernel_bound
    from ..utils.timing import clock_note, flush_buffer, time_call, tool_device
    from .smoke import MEMBERS, as_u64, make_sides, member_call

    device = tool_device(platform)
    note = clock_note(device)
    flush = flush_buffer(device)
    n = 1 << log2_rows
    D = key_domain(n)
    rng = np.random.default_rng(0)
    kb, kp = (rng.integers(0, D, n).astype(np.uint64) for _ in range(2))
    vb, vp = (rng.integers(0, 1 << 40, (1, n)).astype(np.uint64)
              for _ in range(2))
    sides = make_sides(kb, vb, n, kp, vp, n, device)
    full = make_sides(kb * FULL_RANGE_MUL, vb, n, kp * FULL_RANGE_MUL, vp, n,
                      device)
    bits, SPb, SPp = rj.static_radix_plan(n, n)
    B = 1 << bits
    print(f"# roofline: 2^{log2_rows} rows a side, keys below {D}; radix "
          f"plan bits={bits} (B={B}) SPb={SPb} SPp={SPp} ({note})",
          flush=True)

    def timed(fn):
        return time_call(fn, flush, reps)

    stages = {}
    # ---- the radix member's stages ----------------------------------------
    stages["radix _prep_side (one side)"] = _line(
        "radix _prep_side (one side)",
        timed(lambda: rj._prep_side(sides.kb, sides.vb, n, bits)),
        # key and value read; sorted key, value written; starts + cnts
        8 * 2 * n + 8 * 2 * n + 8 * B, note)
    if kernel_stages:
        kb_s, vb_s, st_b, ct_b, _ = rj._prep_side(sides.kb, sides.vb, n, bits)
        kp_s, _, st_p, ct_p, _ = rj._prep_side(sides.kp, sides.vp, n, bits)
        srcs_b = [kb_s, *vb_s]
        _, k4_bytes = kernel_bound("K4", K=len(srcs_b), B=B, SP=SPb, live=n)
        stages["K4 slot_fill (build key + value)"] = _line(
            "K4 slot_fill (build key + value)",
            timed(lambda: rj.slot_fill(st_b, ct_b, srcs_b, SPb)), k4_bytes,
            note)
        mat_b = rj.slot_fill(st_b, ct_b, [kb_s], SPb)[0]
        mat_p = rj.slot_fill(st_p, ct_p, [kp_s], SPp)[0]
        zeros = torch.zeros_like(ct_b)
        wb, wp = rj._windows(zeros, ct_b), rj._windows(zeros, ct_p)
        both = (ct_b > 0) & (ct_p > 0)
        _, k5_bytes = kernel_bound("K5", B=B, Sb=SPb, Sp=SPp,
                                   live_b=int(ct_b[both].sum()),
                                   live_p=int(ct_p[both].sum()))
        stages["K5 probe_counts"] = _line(
            "K5 probe_counts",
            timed(lambda: rj.probe_counts(mat_b, wb, mat_p, wp)), k5_bytes,
            note)

    # ---- the fused members end to end -------------------------------------
    floor = fused_join_floors(n, n, 1, 1)["floor_ms"]
    print(f"# fused join floor: {floor:.4f} ms (keys and values read once "
          f"at the memory rate)", flush=True)
    runs = [(m, sides) for m in MEMBERS] + [("ms full-range keys", full)]
    members, answers = {}, {}
    for name, s in runs:
        member = name.split()[0]
        answers[name] = as_u64(member_call(member, s))
        t = timed(lambda: member_call(member, s))
        ms = t.ms
        members[name] = dict(ms=ms, host_ms=t.host_ms,
                             host_bound=t.host_bound, floor_ms=floor,
                             share=floor / ms)
        print(f"roofline member {name:27s} {ms:9.4f} ms  "
              f"{2 * n / ms / 1e3:9.1f} Mrows/s  ({floor / ms:6.1%} of its "
              f"floor {floor:.4f} ms){t.tag()} ({note})", flush=True)
    first = answers[runs[0][0]]
    for name, got in answers.items():
        if got != first:
            raise AssertionError(f"member {name} answered {got}, "
                                 f"{runs[0][0]} {first}")

    # ---- the ms member's stages -------------------------------------------
    stages["ms sort (join_build, one side)"] = _line(
        "ms sort (join_build, one side)",
        timed(lambda: join_build(sides.kb, n)),
        8 * n + 8 * n + 4 * n, note)          # keys in; sorted, perm out
    sk_b, _ = join_build(sides.kb, n)
    sk_p, perm_p = join_build(sides.kp, n)
    if kernel_stages:
        _, k1_bytes = kernel_bound("K1", n_b=n, n_p=n, Pp=n)
        stages["K1 staircase_counts"] = _line(
            "K1 staircase_counts",
            timed(lambda: staircase_counts(sk_b, n, sk_p, n)), k1_bytes,
            note)
    cnt, _ = staircase_counts(sk_b, n, sk_p, n)
    stages["ms unsort (counts)"] = _line(
        "ms unsort (counts)", timed(lambda: ms_join._unsort(perm_p, cnt)),
        4 * n + 4 * n + 4 * n, note)          # perm, counts in; counts out
    qd = qd_static_plan(n, n)
    print(f"# qd plan SPb={qd[0]} H={qd[1]} SPp={qd[2]}; every member "
          f"answered count={first[0]} (equal across members)", flush=True)
    return {"stages": stages, "members": members, "floor_ms": floor}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2-rows", type=int, default=23)
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run(args.log2_rows, args.platform)
    return 0


if __name__ == "__main__":
    sys.exit(main())
