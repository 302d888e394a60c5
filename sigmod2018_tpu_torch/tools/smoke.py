"""Smoke gate of the port on the card: every member of the fused final join
and the kernel paths around it, each run three times and held against
NumPy.  Counterpart of the JAX package's tools/smoke_tpu.py.

    python -m sigmod2018_tpu_torch.tools.smoke [--platform cuda|cpu]
        [--log2-rows 18]

Cases, each named in the log and in the failure list:

- `member:<m>`: the fused join of one pair of sides (2^18 padded rows
  each, the JAX gate's size, 100 and 177 pad rows, keys below 50,000,
  two value columns a side) by each member m of MEMBERS through
  ops.fused_join_auto, its (count, build sums, probe sums) equal to
  NumPy's.  Three rounds, each running every member once, so every run
  of a member follows runs of the others.  `radix` and `qd` must serve
  from their kernel branch; on a card `ms` must launch K1, and `radix`
  and `qd` K4 and K5;
- `radix:merge-branch`: one build key on 2,000 rows puts a bucket past
  its slots (occupancy > SPb - ALIGN), so the radix member serves from
  its merge branch (BRANCHES["merge"] rises): the counterpart of the
  JAX gate's staircase-overflow `lax.cond` case;
- `emitting:jpc_ms`: the emitting join's counts by the staircase kernel
  (ms_join.join_probe_count_ms) equal to searchsorted's
  (sort_join.join_probe_count): cnt, lo where cnt > 0, total;
- `engine:compiled-3rel-x3`: a three-relation query on one compiled
  engine three times (planned, then the per-text fast path);
- `engine:factorized-blowup-x3`: a four-relation chain that blows up,
  served by message passing three times, against the NumPy twin.

Not carried over: the vault round trip (the port has no vault), the
key32 variants (no u32 key path) and the gate-record file that bench.py
reads (the port has no bench yet).

A watchdog exits 3 with every thread's traceback when the gate runs past
SMOKE_DEADLINE seconds (default 1500).  The exit code is 0 on PASS, 1
with the failing cases named.  Runs on the card unless --platform cpu;
without a card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import os
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

MEMBERS = ("sort", "table", "table+pref", "ms", "radix", "qd")
MASK64 = (1 << 64) - 1
MERGE_HOT_ROWS = 2000  # build rows of one key: past SPb - ALIGN = 1024

_T0 = time.monotonic()


def log(msg: str) -> None:
    print(f"[smoke +{time.monotonic() - _T0:6.1f}s] {msg}", flush=True)


def arm_deadline(seconds: float) -> threading.Event:
    """Start the watchdog; setting the returned event stops it."""
    done = threading.Event()

    def watchdog():
        if not done.wait(seconds):
            log(f"DEADLINE EXCEEDED ({seconds:.0f}s)")
            faulthandler.dump_traceback(file=sys.stderr)
            os._exit(3)

    threading.Thread(target=watchdog, daemon=True).start()
    return done


@dataclasses.dataclass
class Sides:
    """Both sides of a fused join on the device, with the build side's
    prep-time artifacts: the key table (cumcnt, None past the engine's
    default gate, EngineConfig.key_table_max) and the prefix tables of
    its values in key order."""

    kb: torch.Tensor          # [Pb] build keys, u64 bit patterns
    vb: torch.Tensor          # [Vb, Pb]
    nb: int
    kp: torch.Tensor          # [Pp]
    vp: torch.Tensor          # [Vp, Pp]
    np_: int
    perm: torch.Tensor        # join_build's perm of the build side
    cumcnt: Optional[torch.Tensor]
    prefs: torch.Tensor       # [Vb, Pb + 1]


def make_sides(kb: np.ndarray, vb: np.ndarray, nb: int, kp: np.ndarray,
               vp: np.ndarray, np_: int, device) -> Sides:
    """Sides from uint64 host arrays (keys [P], values [V, P])."""
    from ..config import EngineConfig
    from ..ops import join_build, prefix_by_perm

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(
            device)

    keys_b = dev(kb)
    vals_b = dev(vb)
    _, perm = join_build(keys_b, nb)
    live = kb[:nb]
    cumcnt = None
    u = int(live.max()) if nb else 0
    if u + 3 <= EngineConfig().key_table_max:  # device_key_table's gate
        table = np.zeros(u + 3, dtype=np.int32)
        table[1:u + 2] = np.cumsum(np.bincount(live.astype(np.int64),
                                               minlength=u + 1))
        table[u + 2] = table[u + 1]
        cumcnt = torch.from_numpy(table).to(device)
    prefs = torch.stack([prefix_by_perm(v, perm, nb) for v in vals_b])
    return Sides(keys_b, vals_b, nb, dev(kp), dev(vp), np_, perm, cumcnt,
                 prefs)


def member_call(member: str, s: Sides):
    """One fused join of `s` by `member` through ops.fused_join_auto:
    (count, sums_build, sums_probe) as device tensors."""
    from ..ops import fused_join_auto

    kw = {}
    if member in ("table", "table+pref"):
        if s.cumcnt is None:
            raise ValueError(f"{member}: the build keys pass the key-table "
                             f"gate")
        kw["table"] = (s.cumcnt, s.perm)
        if member == "table+pref":
            kw["table_prefs"] = s.prefs
    algo = "sort" if member in ("table", "table+pref") else member
    return fused_join_auto(s.kb, s.vb, s.nb, s.kp, s.vp, s.np_, algo=algo,
                           **kw)


def as_u64(result) -> tuple:
    """(count, [sums_build], [sums_probe]) as Python ints mod 2^64."""
    count, sb, sp = result
    return (int(count) & MASK64, [int(x) & MASK64 for x in sb.tolist()],
            [int(x) & MASK64 for x in sp.tolist()])


def numpy_fused(kb: np.ndarray, vb: np.ndarray, nb: int, kp: np.ndarray,
                vp: np.ndarray, np_: int) -> tuple:
    """The fused join's (count, [sums_build], [sums_probe]) by NumPy:
    per-row match counts of each side weight its value columns."""
    ob, op_ = np.sort(kb[:nb]), np.sort(kp[:np_])
    cnt_p = (np.searchsorted(ob, kp[:np_], "right")
             - np.searchsorted(ob, kp[:np_], "left")).astype(np.uint64)
    cnt_b = (np.searchsorted(op_, kb[:nb], "right")
             - np.searchsorted(op_, kb[:nb], "left")).astype(np.uint64)
    return (int(cnt_p.sum()),
            [int((cnt_b * v[:nb]).sum()) & MASK64 for v in vb],
            [int((cnt_p * v[:np_]).sum()) & MASK64 for v in vp])


def fixture(log2_rows: int, seed: int = 0):
    """The JAX gate's sides: (kb, vb, nb, kp, vp, np) uint64 host arrays,
    Pb = Pp = 2^log2_rows, keys below 50,000 (zeros in the pad rows)."""
    rng = np.random.default_rng(seed)
    Pb = Pp = 1 << log2_rows
    nb, np_ = Pb - 100, Pp - 177
    kb = np.zeros(Pb, np.uint64)
    kb[:nb] = rng.integers(0, 50_000, nb)
    kp = np.zeros(Pp, np.uint64)
    kp[:np_] = rng.integers(0, 50_000, np_)
    vb = rng.integers(0, 1 << 20, (2, Pb)).astype(np.uint64)
    vp = rng.integers(0, 1 << 20, (2, Pp)).astype(np.uint64)
    return kb, vb, nb, kp, vp, np_


def _counts() -> dict:
    from ..ops import ms_join, qd_join, radix_join

    return {"K1": ms_join.LAUNCHES, **dict(radix_join.LAUNCHES),
            "radix": dict(radix_join.BRANCHES), "qd": dict(qd_join.BRANCHES)}


def check_member(member: str, sides: Sides, want: tuple, cuda: bool) -> None:
    before = _counts()
    got = as_u64(member_call(member, sides))
    after = _counts()
    if got != want:
        raise AssertionError(f"got {got}, want {want}")
    if member in ("radix", "qd"):
        if after[member]["kernel"] <= before[member]["kernel"]:
            raise AssertionError(f"the kernel branch did not serve: "
                                 f"{after[member]}")
        if cuda and not all(after[k] > before[k]
                            for k in ("slot_fill", "probe_counts")):
            raise AssertionError(f"K4/K5 did not launch: {after}")
    if member == "ms" and cuda and after["K1"] <= before["K1"]:
        raise AssertionError("K1 did not launch")


def merge_case(host, device) -> None:
    from ..ops import radix_join

    kb, vb, nb, kp, vp, np_ = host
    kb = kb.copy()
    kb[:MERGE_HOT_ROWS] = 7  # one bucket past its slots
    kp = kp.copy()
    kp[:50] = 7
    want = numpy_fused(kb, vb, nb, kp, vp, np_)
    sides = make_sides(kb, vb, nb, kp, vp, np_, device)
    for run in range(3):
        before = radix_join.BRANCHES["merge"]
        got = as_u64(member_call("radix", sides))
        if got != want:
            raise AssertionError(f"run {run + 1}: got {got}, want {want}")
        if radix_join.BRANCHES["merge"] != before + 1:
            raise AssertionError(f"run {run + 1}: the merge branch did not "
                                 f"serve: {radix_join.BRANCHES}")


def emitting_case(sides: Sides, cuda: bool) -> None:
    from ..ops import join_build, join_probe_count, join_probe_count_ms
    from ..ops import ms_join

    sk, _ = join_build(sides.kb, sides.nb)
    a = join_probe_count(sk, sides.nb, sides.kp, sides.np_)
    for run in range(3):
        before = ms_join.LAUNCHES
        b = join_probe_count_ms(sk, sides.nb, sides.kp, sides.np_)
        hit = a[1] > 0
        if not (torch.equal(a[1], b[1]) and torch.equal(a[0][hit], b[0][hit])
                and int(a[3]) == int(b[3])):
            raise AssertionError(f"run {run + 1}: cnt/lo/total differ "
                                 f"(totals {int(a[3])} / {int(b[3])})")
        if cuda and ms_join.LAUNCHES <= before:
            raise AssertionError("K1 did not launch")


def _serve_three_times(eng, q, want: str) -> None:
    for run in range(3):
        got = eng.execute(q)
        if got != want:
            raise AssertionError(f"run {run + 1}: got {got}, want {want}")


def engine_case(platform: str) -> None:
    from ..config import EngineConfig
    from ..engine.compiled import CompiledTorchEngine
    from ..engine.oracle import execute_query_numpy
    from ..frontend.parser import parse_query
    from .fuzz import catalog_of

    rng = np.random.default_rng(3)
    cat = catalog_of([[rng.integers(0, 800, 4000).astype(np.uint64)
                       for _ in range(3)] for _ in range(4)])
    eng = CompiledTorchEngine(cat, EngineConfig(platform=platform))
    q = parse_query("0 1 2|0.0=1.0&1.1=2.1|0.2 2.0")
    _serve_three_times(eng, q, execute_query_numpy(q, cat))


def factorized_case(platform: str) -> None:
    from ..config import EngineConfig
    from ..engine.compiled import CompiledTorchEngine
    from ..engine.factorized import execute_query_factorized_np
    from ..frontend.parser import parse_query
    from .fuzz import catalog_of

    rng = np.random.default_rng(5)
    cat = catalog_of([[rng.integers(0, 500, 50000).astype(np.uint64),
                       rng.integers(0, 1 << 20, 50000).astype(np.uint64)]
                      for _ in range(4)])
    eng = CompiledTorchEngine(cat, EngineConfig(
        platform=platform, factorize_min=1 << 16, max_intermediate=1 << 30))
    q = parse_query("0 1 2 3|0.0=1.0&1.0=2.0&2.0=3.0|1.1 0.1")
    _serve_three_times(eng, q, execute_query_factorized_np(q, cat))
    if eng.tiers["factorized_proactive"] != 3:
        raise AssertionError(f"not served by message passing: {eng.tiers}")


def run_gate(platform: str = "cuda", log2_rows: int = 18) -> list:
    """Every case once; returns the names of the failing ones."""
    from ..utils.timing import tool_device

    device = tool_device(platform)
    cuda = device.type == "cuda"
    log(f"device {device} "
        f"({torch.cuda.get_device_name(device) if cuda else 'CPU'}), "
        f"2^{log2_rows} rows a side")
    failures = []

    def check(name, fn):
        t0 = time.monotonic()
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 -- every case must report
            log(f"FAIL {name}: {exc!r}")
            if name not in failures:
                failures.append(name)
            return
        log(f"PASS {name} ({time.monotonic() - t0:.2f}s)")

    host = fixture(log2_rows)
    want = numpy_fused(*host)
    sides = make_sides(*host, device)
    for rnd in range(3):
        for member in MEMBERS:
            check(f"member:{member}",
                  lambda m=member: check_member(m, sides, want, cuda))
    check("radix:merge-branch", lambda: merge_case(host, device))
    check("emitting:jpc_ms", lambda: emitting_case(sides, cuda))
    check("engine:compiled-3rel-x3", lambda: engine_case(platform))
    check("engine:factorized-blowup-x3", lambda: factorized_case(platform))
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--log2-rows", type=int, default=18)
    args = ap.parse_args(argv)
    done = arm_deadline(float(os.environ.get("SMOKE_DEADLINE", "1500")))
    try:
        failures = run_gate(args.platform, args.log2_rows)
    finally:
        done.set()
    if failures:
        log(f"SMOKE FAILED: {failures}")
        return 1
    log("SMOKE PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
