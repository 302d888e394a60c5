#!/usr/bin/env python3
"""Smoke test of the torch port (`sigmod2018_tpu_torch`) on one NVIDIA GPU.

Phases, each of which must pass:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions;
2. build: csrc/stair_counts.cu, csrc/slot_fill.cu and
   csrc/probe_counts.cu, one nvcc each, and the native loader
   (storage/native/loader.cpp, g++), all started together, timed, with
   ptxas's report;
3. kernels vs plain, on the card, each with the median time of kernel
   and plain twin (CUDA events, L2 flushed before every run) and the
   bound of `bound()` (bytes over the card's memory rate):
   - K1 `ops.ms_join.staircase_counts` against `staircase_counts_plain`
     at the serving path's shapes, cnt exactly and lo where cnt > 0
     (its 2^24-row build is the size where the TPU needed the rolled
     kernels K2/K3, whose contract K1 serves), also timed against two
     `torch.searchsorted` calls, the library yardstick;
   - K4 `ops.radix_join.slot_fill` against `slot_fill_plain`, the whole
     [K, B, SP] matrix exactly, at the radix member's and the
     equi-depth member's 2^21 shapes;
   - K5 `ops.radix_join.probe_counts` against `probe_counts_plain`, mc
     and pc exactly, at those shapes, the radix windows shuffled (not
     ascending), zipf-like keys (buckets near the 2,048-slot cap), a
     window of MAX_SLOTS keys in no order, keys over the full u64 range
     with live 2^64-1 keys, and empty windows;
3b. range expansion: `ops.sort_join.join_emit` with a device total at
   the TPC-H cells' Q7/Q10 shape (2^23 probe rows, ~4% of the 6,000,000
   live ones matching once, out_size 2^18) and at a bigdom emit of
   4,264,621 pairs, exactly against the NumPy expansion computed on the
   host, with its median time (CUDA events) and the share of the card's
   memory rate that its bytes (`emit_bytes`) take in that time;
4. factorized message: one message of engine/factorized.py at 2^21
   padded rows, on an edge of workloads/zipfbig (relation 1 joined with
   itself), held exactly against the NumPy twin's message and timed
   (CUDA events) in the port's gather form and in a sort form; then that
   query whole through `factorized_result`, its line against the NumPy
   twin's, the host's dispatch time beside the card's;
5. end to end: the relation binaries of workloads/big, bigdom, zipfbig,
   scaled and zipf are regenerated from their seeds
   (sigmod2018_tpu_torch.tools.workload, parameters of
   tools/regen_workloads.sh, full size), and `init + Done + .work` goes
   through the port's protocol driver (`io.repl.serve`) on the card:
   with the compiled engine (the default) under the auto member choice
   twice, each run a fresh engine, the prep cache (S18_PREP_CACHE) an
   emptied directory under build/smoke/ when the script starts; with the
   operator engine (S18_COMPILE_QUERIES=0) under auto once; and, for big
   and bigdom, with the compiled engine and the radix and the
   equi-depth members forced (once each).
   Every output line must equal the committed .result; under auto K1
   launches on the 2,000,000-row workloads, under radix and qd K4 and K5
   launch and the members' kernel branch serves at least one join per
   workload.  The engine's tier counts must add up to the queries sent;
   on zipfbig a factorized tier must serve at least one query and on
   scaled `factorized_proactive` must.  The second compiled auto run of
   each workload, sized from the classes the first run learned, must
   retry no query and serve none with host reads.  Each run prints the
   engine, its counts and its host syncs (reads of intermediate totals
   plus the forced members' branch reads).  Every kernel count is
   set to 0 just before each run and read just after it.  A count is of
   kernel launches: one K1 call launches two (the bounds pass and the
   merge pass), or the merge pass alone when host counts leave no live
   row;
6. sync-free dispatch: on bigdom, a compiled engine with the learned
   classes dispatches a query with an intermediate join of 2,000,000
   rows twice (planned, then from the per-text fast path) under
   `torch.cuda.set_sync_debug_mode("error")`, K1 launching inside; it is
   fetched after the mode is reset and must equal its .result line;
7. prep and instruments, on big and bigdom:
   a. big's 12 columns: the native loader's stats must equal NumPy's
      `compute_column_stats` in all six fields (and its zero-copy columns
      the files' values); the seconds of stats by NumPy, by the native
      loader and from a stats-cache hit;
   b. fresh processes under the contest harness: `tools/harness.py INIT
      WORK RESULT -- python -m sigmod2018_tpu_torch` (1 s prep window):
      big and bigdom from an emptied prep cache with the defaults (async
      prep, native stats, the warm-up tier), again warm, and warm with
      S18_ASYNC_PREP=0; zipfbig, scaled and zipf warm (from a copy of
      phase 5's prep cache) with the defaults and with
      S18_WARMUP_ORACLE=0.  Each must exit 0 (every line exact) and end
      its serving normally; its timed ms prints beside phase 5's
      in-process timed phase, with the engine's counts, the tier counts
      (`warmup_host`: the warm-up tier's answers) and the process's start
      timeline (the `start {..}` line of io/repl.py).  The tier must
      answer nothing on big, bigdom and zipfbig (every query references
      more than 2^21 base rows) and under S18_WARMUP_ORACLE=0.  One more
      fresh process times `import torch`, CUDA's start with a first
      launch, and the import of the port's serving modules; another
      times `import torch` in a thread as the driver's card thread does
      it; and the five largest cumulative imports of `python -X
      importtime -c "import torch"` print;
   c. one bigdom query with an intermediate join under S18_TRACE=json
      and S18_EXPLAIN=1 (the operator engine, one batch thread): its
      line equal to the .result's, every trace record parsed, device_ms
      >= 0, a floor on every join-family op, the summed device_ms at
      most the query's wall time, and the `actual` lines equal to the
      totals the engine read; its five largest ops print.

8. the mesh (parallel/), every shard on the one card: first the
   shard-to-device maps of 4 and 8 shards; then, from an emptied prep
   cache (build/smoke/mesh-prep), the whole-query engine on 4 shards with
   the all_to_all exchange on all five workloads twice (the second run
   sized from what the first learned: no retry, no host read of a
   total), the operator engine on 4 shards once on big and bigdom, 8
   shards with the ring exchange on bigdom and zipf, and on zipf
   S18_SKEW=1 and S18_BCAST=2^22 on 4 shards.  Every line must equal the
   .result and the tiers add up; K1 must launch in bigdom's 4-shard
   runs, and broadcast, shuffle and skew must each serve a join.  Each
   run prints its collectives by kind, join strategies, K1 launches,
   host syncs, and its prep and timed phase beside phase 5's
   single-device ones.

9. the tools (sigmod2018_tpu_torch/tools/), on the card: the smoke gate
   (tools.smoke: every fused-join member three times, the radix merge
   branch, the emitting counts, a compiled and a factorized query) must
   pass; the differential fuzz (tools.fuzz, seed 99) must find 0
   failures in 200 queries under auto and under the forced ms, radix and
   qd members, and in 60 queries on a 4-shard mesh, each mode's kernel
   counts set to 0 just before it and read just after (K1 must launch
   under ms, K4 and K5 under radix and qd); then the probe and fused
   crossovers (tools.bench_probe, 2^12..2^22), the members and stages
   against their floors (tools.roofline, 2^21, without the K1, K4 and K5
   stages that phase 3 times) and the primitive rates (tools.microbench,
   2^23) print with the card's name and power limit, and so do the
   phase's seconds.  Each timed call waits on at least twice its host
   issue time (utils/timing.py), and a line names the calls whose host
   issue takes as long as their device time (host-bound).

10. multi-process serving: for each workload, two ranks of
   `python -m sigmod2018_tpu_torch` (S18_COORD_ADDR on a free port,
   S18_NUM_PROCS=2, S18_PROC_ID 0 and 1, S18_MESH=4: two shards a rank,
   all on the card; collectives over gloo staged through host memory),
   the same protocol on each one's stdin, from an emptied prep cache
   (build/smoke/mp-prep): the all_to_all on all five workloads twice,
   then phase 8's zipf runs under S18_SKEW=1 and S18_BCAST=2^22.  Every
   line of both ranks must equal the .result, the tiers add up, both
   ranks call the same collectives, K1 launches on bigdom on both ranks,
   the second run of each workload retries nothing and reads no total,
   and broadcast, shuffle and skew each serve a join.  Each rank's line
   prints its collectives and transport, host syncs, prep and timed
   phase beside phase 8's one-process mesh-4 run and phase 5's single
   device.  Each run has a deadline, and a rank that fails or hangs
   ends both (parallel/launch.py).  Then tools.collective_cost times one
   call of each collective on 4 shards as two ranks and in one process
   (host clock around the call and a synchronize).

11. the routing thresholds S18_EMIT_MS_MIN and S18_RADIX_MIN, in fresh
   processes under the contest harness (as in phase 7b), each arm on each
   workload from its own copy of phase 5's prep cache: on all five
   workloads with the warm-up tier off, once at 0/0 (every emitting count
   and every auto fused join takes K1, zipf's joins of 2^16 padded rows
   too) and once at 2^62/2^62 (K1 never launches); each run
   must exit 0 with every line exact, K1 must launch on every workload
   of the first arm and on none of the second.  Then on big, bigdom and
   zipfbig the defaults (2^18/2^18) against the crossovers that
   tools.bench_probe measured on the H100 (2^22/2^20), three runs an arm
   in turns: each run's timed ms and K1/K4/K5 launches, each arm's
   median, and the pairs each arm won print with the card's name and
   power limit.  No default moves.

12. the benchmark's cells (sigmod2018_tpu_torch/tools/bench.py, every
   cell of BENCHMARK.json), each once in a fresh process with
   BENCH_PASSES timed passes: each must exit 0 with 0 mismatches (every
   pass's lines checked by the bench against its own reference), name
   the card in its device line, launch each kernel as often in every
   timed pass and K1 at least once a pass, and keep the card busy for
   part of its traced pass.  Each cell's passes, prep, dispatch and
   fetch split, launches per pass and the traced pass's device busy
   share print with the card's name and power limit.

Before them come the prep and timed phases of both engines per workload,
side by side.  The line before the last is the kernel table as JSON (per
kernel: time, plain and library times, bound and its share, launches on
the path that runs it, on the compiled engine's auto main path, per
compiled auto run of each workload, under the operator engine, under
the forced members and, for K1, on the mesh and per rank of phase 10);
the last line is {"ok": true, "device": {...}}.
Any failure exits non-zero before either is printed, as does a machine
without a CUDA device.

Run from the repository root:  python3 chip_smoke.py

`python -m sigmod2018_tpu_torch.tools.cold_start` compares phase 7b's
fresh processes with variants of the driver and with another checkout,
in turns.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from sigmod2018_tpu_torch.utils.floors import kernel_bound as bound
from sigmod2018_tpu_torch.utils.timing import (card_line, flush_buffer,
                                                median_ms)

ROOT = Path(__file__).resolve().parent
SMOKE_DIR = ROOT / "build" / "smoke"
PREP_CACHE = SMOKE_DIR / "prep"  # learned size classes of this run only
RUNS_PER_WORKLOAD = 2
KERNEL_SOURCES = ("stair_counts", "slot_fill", "probe_counts")
K1_MAIN_CASE = "2^21 keys<2^20"
K1_BIG_BUILD_CASE = "build 2^24 x probe 2^21"

# tools/regen_workloads.sh
WORKLOADS = {
    "big": dict(profile="uniform", rows=2_000_000, relations=4,
                keyspace=1_048_576, seed=7),
    "bigdom": dict(profile="bigdom", rows=2_000_000, relations=4,
                   keyspace=1_048_576, seed=11),
    "zipfbig": dict(profile="zipfbig", rows=2_000_000, relations=4,
                    keyspace=1_048_576, seed=13),
    "scaled": dict(profile="scaled", rows=20_000, scale=10, relations=6,
                   keyspace=20_000, seed=3),
    "zipf": dict(profile="zipf", rows=50_000, relations=6, keyspace=5_000,
                 seed=4),
}
FORCED_WORKLOADS = ("big", "bigdom")  # the others run under auto only
K1_WORKLOADS = ("big", "bigdom", "zipfbig")  # joins at 2^21 padded rows
# the serving tiers of which at least one query must come, under auto
REQUIRED_TIERS = {"zipfbig": ("factorized_proactive", "factorized_blowup"),
                  "scaled": ("factorized_proactive",)}
# zipfbig's 4th query joins relation 1 with itself on these columns
MESSAGE_EDGE = dict(srel=1, scol=2, rrel=1, rcol=0)
MESSAGE_QUERY = 3  # index of that query among zipfbig's


def kernel_cases(dev):
    """(name, kb, n_b, kp, n_p) at the serving path's shapes: sorted u64
    keys as int64, pads 2^64-1, made on the card from a seed."""
    from sigmod2018_tpu_torch.ops.sort_join import join_build

    gen = torch.Generator(device=dev).manual_seed(2018)
    P, N = 1 << 21, 2_000_000

    def rand(size, lo, hi):
        return torch.randint(lo, hi, (size,), generator=gen, device=dev)

    def side(keys, n):
        return join_build(keys, n)[0]

    def full_range(size):  # every u64 bit pattern
        return rand(size, -(1 << 62), 1 << 62) * 2 + rand(size, 0, 2)

    lut = rand(1 << 20, 0, 1 << 40)
    pool = full_range(1 << 20)
    hot = rand(P, 0, 1 << 20)
    hot[rand(P // 4, 0, P)] = 12345
    maxkey = rand(P, 0, 1 << 20)
    maxkey[rand(P // 100, 0, P)] = -1  # live keys 2^64-1
    n_small = torch.tensor(N - 3, device=dev)
    return [
        ("2^21 keys<2^20", side(rand(P, 0, 1 << 20), N), N,
         side(rand(P, 0, 1 << 20), N), N),
        ("2^21 keys<2^40 (bigdom lut)", side(lut[rand(P, 0, 1 << 20)], N), N,
         side(lut[rand(P, 0, 1 << 20)], N), N),
        ("2^21 keys over the full u64 range", side(pool[rand(P, 0, 1 << 20)], N),
         N, side(pool[rand(P, 0, 1 << 20)], N), N),
        ("2^21 hot key (1/4 of rows)", side(hot, N), N,
         side(hot.flip(0).contiguous(), N), N),
        ("2^21 live 2^64-1 keys", side(maxkey, N), N,
         side(maxkey.flip(0).contiguous(), N - 1), N - 1),
        ("2^21 device-side counts", side(rand(P, 0, 1 << 20), N - 3), n_small,
         side(rand(P, 0, 1 << 20), N), torch.tensor(N, device=dev)),
        ("2^21 n_b=0", side(rand(P, 0, 1 << 20), 0), 0,
         side(rand(P, 0, 1 << 20), N), N),
        ("2^21 n_p=0", side(rand(P, 0, 1 << 20), N), N,
         side(rand(P, 0, 1 << 20), 0), 0),
        ("build 2^24 x probe 2^21", side(rand(1 << 24, 0, 1 << 22), 16_000_000),
         16_000_000, side(rand(P, 0, 1 << 22), N), N),
    ]


def phase_kernel(dev, card: str, flush: torch.Tensor):
    """K1 against its plain twin: (max_abs_err, {case: (kernel ms, plain
    ms, library ms, bound ms)}).  The library yardstick is two
    torch.searchsorted calls (left and right) on keys flipped beforehand;
    the port never calls it."""
    from sigmod2018_tpu_torch.ops import ms_join
    from sigmod2018_tpu_torch.ops.u64 import flip

    before = ms_join.LAUNCHES
    max_err = 0
    times = {}
    for name, kb, n_b, kp, n_p in kernel_cases(dev):
        cnt_k, lo_k = ms_join.staircase_counts(kb, n_b, kp, n_p)
        cnt_p, lo_p = ms_join.staircase_counts_plain(kb, n_b, kp, n_p)
        torch.cuda.synchronize()
        hit = cnt_p > 0
        err = max(int((cnt_k.long() - cnt_p.long()).abs().max()),
                  int((lo_k[hit].long() - lo_p[hit].long()).abs().max())
                  if bool(hit.any()) else 0)
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"kernel != plain on {name}: max abs "
                                 f"err {err}")
        k_ms = median_ms(lambda: ms_join.staircase_counts(kb, n_b, kp, n_p),
                         flush)
        p_ms = median_ms(
            lambda: ms_join.staircase_counts_plain(kb, n_b, kp, n_p), flush)
        fb, fp = flip(kb[:int(n_b)]), flip(kp)
        lib_ms = median_ms(
            lambda: (torch.searchsorted(fb, fp, side="left"),
                     torch.searchsorted(fb, fp, side="right")), flush)
        b_ms, nbytes = bound("K1", n_b=int(n_b), n_p=int(n_p),
                             Pp=kp.shape[0])
        times[name] = (k_ms, p_ms, lib_ms, b_ms)
        print(f"K1 kernel-vs-plain [{name}] Pb={kb.shape[0]} "
              f"Pp={kp.shape[0]} n_b={int(n_b)} n_p={int(n_p)} "
              f"matches={int(cnt_p.sum())}: cnt/lo exact; kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, 2x searchsorted "
              f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({nbytes} bytes; "
              f"{b_ms / k_ms:.1%} of it) (median, {card})", flush=True)
    if ms_join.LAUNCHES <= before:
        raise AssertionError("the kernel's launch count did not grow")
    return max_err, times


def _radix_side(dev, gen, P: int, n: int, bits: int, keys=None):
    """A real radix prep of n keys (uniform below 2^20 unless given) and
    3 value columns: (krot_sorted, vals_sorted [3, P], starts, cnts)."""
    from sigmod2018_tpu_torch.ops import radix_join

    if keys is None:
        keys = torch.randint(0, 1 << 20, (P,), generator=gen, device=dev)
    vals = torch.randint(-(1 << 62), 1 << 62, (3, P), generator=gen,
                         device=dev)
    ks, vs, st, ct, _ = radix_join._prep_side(keys, vals, n, bits)
    return ks, vs, st, ct


def _qd_sides(dev, gen, P: int, n: int):
    """The equi-depth member's sorted sides at its plan for P rows:
    (plan, build keys, build halo windows, probe sorted keys and values,
    probe starts, probe cnts)."""
    from sigmod2018_tpu_torch.ops import qd_join

    SPb, H, SPp = qd_join.qd_static_plan(P, P)
    kb = torch.randint(0, 1 << 20, (P,), generator=gen, device=dev)
    kp = torch.randint(0, 1 << 20, (P,), generator=gen, device=dev)
    vp = torch.randint(-(1 << 62), 1 << 62, (3, P), generator=gen,
                       device=dev)
    kb_s, _ = qd_join._sort_side(kb, vp[:0], n)
    kp_s, vp_s = qd_join._sort_side(kp, vp, n)
    pstart = qd_join._pstarts(kp_s, kb_s[::SPb], n)
    pend = torch.cat([pstart[1:], torch.full((1,), n, device=dev)])
    ct = torch.clamp(pend - pstart, min=0)
    return ((SPb, H, SPp), kb_s, kp_s, vp_s, pstart.to(torch.int32),
            ct.to(torch.int32))


def _window_lengths(w: torch.Tensor, S: int) -> torch.Tensor:
    """Live slots of each int32 [B, 2] window, clamped to a row of S."""
    lo, hi = torch.clamp(w[:, 0], 0, S), torch.clamp(w[:, 1], 0, S)
    return torch.clamp(hi - lo, min=0)


def _zipf_keys(dev, gen, P: int, n_hot: int = 64, top: int = 1500):
    """P keys uniform below 2^20, with n_hot hot keys of multiplicity
    top / rank spread over them: at radix 2^21 (4,096 buckets, ~490 rows
    each) the hot keys' buckets hold up to ~2,000 rows."""
    keys = torch.randint(0, 1 << 20, (P,), generator=gen, device=dev)
    hot = torch.randint(0, 1 << 20, (n_hot,), generator=gen, device=dev)
    reps = torch.tensor([top // (r + 1) for r in range(n_hot)], device=dev)
    rows = torch.randperm(P, generator=gen, device=dev)[:int(reps.sum())]
    keys[rows] = torch.repeat_interleave(hot, reps)
    return keys


def _shuffle_windows(mat: torch.Tensor, ct: torch.Tensor, gen):
    """Each row's window [0, ct) in a random order (slots past it stay)."""
    S = mat.shape[1]
    r = torch.rand(mat.shape, generator=gen, device=mat.device)
    s = torch.arange(S, device=mat.device)
    r = torch.where(s[None, :] < ct[:, None], r, 2.0 + s[None, :])
    return torch.gather(mat, 1, torch.argsort(r, 1)).contiguous()


def phase_radix_kernels(dev, card: str, flush: torch.Tensor):
    """K4 and K5 against their plain twins at the forced members' 2^21
    shapes: {kernel: (max_abs_err, {case: (kernel ms, plain ms, None,
    bound ms)})}: no single PyTorch call computes either."""
    from sigmod2018_tpu_torch.ops import qd_join, radix_join as rj

    gen = torch.Generator(device=dev).manual_seed(2019)
    P, N = 1 << 21, 2_000_000
    bits, SPb, SPp = rj.static_radix_plan(P, P)
    out = {"slot_fill": [0, {}], "probe_counts": [0, {}]}
    before = dict(rj.LAUNCHES)

    def k4(name, st, ct, srcs, SP):
        got = rj.slot_fill(st, ct, srcs, SP)
        want = rj.slot_fill_plain(st, ct, srcs, SP)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if err:
            raise AssertionError(f"K4 kernel != plain on {name}: {err}")
        out["slot_fill"][0] = max(out["slot_fill"][0], err)
        k_ms = median_ms(lambda: rj.slot_fill(st, ct, srcs, SP), flush)
        p_ms = median_ms(lambda: rj.slot_fill_plain(st, ct, srcs, SP),
                         flush)
        b_ms, nbytes = bound("K4", K=len(srcs), B=st.shape[0], SP=SP,
                             live=int(torch.clamp(ct, max=SP).sum()))
        out["slot_fill"][1][name] = (k_ms, p_ms, None, b_ms)
        print(f"K4 kernel-vs-plain [{name}] K={len(srcs)} "
              f"B={st.shape[0]} SP={SP} live={int(ct.sum())}: whole "
              f"matrix exact; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({nbytes} bytes; {b_ms / k_ms:.1%} of "
              f"it) (median, {card})", flush=True)
        return got

    def k5(name, kb, wb, kp, wp):
        mc, pc = rj.probe_counts(kb, wb, kp, wp)
        wmc, wpc = rj.probe_counts_plain(kb, wb, kp, wp)
        torch.cuda.synchronize()
        err = max(int((mc - wmc).abs().max()), int((pc - wpc).abs().max()))
        if err:
            raise AssertionError(f"K5 kernel != plain on {name}: {err}")
        out["probe_counts"][0] = max(out["probe_counts"][0], err)
        k_ms = median_ms(lambda: rj.probe_counts(kb, wb, kp, wp), flush)
        p_ms = median_ms(lambda: rj.probe_counts_plain(kb, wb, kp, wp),
                         flush)
        (B, Sb), Sp = kb.shape, kp.shape[1]
        nw_b, nw_p = _window_lengths(wb, Sb), _window_lengths(wp, Sp)
        both = (nw_b > 0) & (nw_p > 0)  # else the bucket's counts are 0
        b_ms, nbytes = bound("K5", B=B, Sb=Sb, Sp=Sp,
                             live_b=int(nw_b[both].sum()),
                             live_p=int(nw_p[both].sum()))
        out["probe_counts"][1][name] = (k_ms, p_ms, None, b_ms)
        print(f"K5 kernel-vs-plain [{name}] B={B} Sb={Sb} Sp={Sp} "
              f"matches={int(mc.sum())} largest windows "
              f"{int(nw_b.max())}/{int(nw_p.max())}: "
              f"mc/pc exact; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({nbytes} bytes; {b_ms / k_ms:.1%} of "
              f"it) (median, {card})", flush=True)

    def wins(ct, lo=None):
        lo = torch.zeros_like(ct) if lo is None else lo
        return rj._windows(lo, ct)

    # radix at 2^21: bits 12, B 4,096, SP 2,048, key + 3 value columns
    kb, vb, st_b, ct_b = _radix_side(dev, gen, P, N, bits)
    kp, vp, st_p, ct_p = _radix_side(dev, gen, P, N, bits)
    mb = k4("radix 2^21 build", st_b, ct_b, [kb, *vb], SPb)
    mp = k4("radix 2^21 probe", st_p, ct_p, [kp, *vp], SPp)
    k5("radix 2^21", mb[0], wins(ct_b), mp[0], wins(ct_p))
    k5("radix 2^21 n_b=0", mb[0], wins(torch.zeros_like(ct_b)), mp[0],
       wins(ct_p))
    k5("radix 2^21 n_p=0", mb[0], wins(ct_b), mp[0],
       wins(torch.zeros_like(ct_p)))
    # the same windows in a random order: the kernel sorts them itself
    k5("radix 2^21 unsorted windows", _shuffle_windows(mb[0], ct_b, gen),
       wins(ct_b), _shuffle_windows(mp[0], ct_p, gen), wins(ct_p))
    del mb, mp

    # zipf-like keys: a few buckets near the 2,048-slot cap, most ~490
    zk = _zipf_keys(dev, gen, P)
    zb, _, zst_b, zct_b = _radix_side(dev, gen, P, N, bits, keys=zk)
    zp, _, zst_p, zct_p = _radix_side(dev, gen, P, N, bits,
                                      keys=zk.flip(0).contiguous())
    k5("radix 2^21 zipf-like keys", rj.slot_fill(zst_b, zct_b, [zb], SPb)[0],
       wins(zct_b), rj.slot_fill(zst_p, zct_p, [zp], SPp)[0], wins(zct_p))

    # qd at 2^21: B 8,192, build rows SPb + H = 320, probe SPp 2,048
    (qSPb, H, qSPp), qkb, qkp, qvp, qst, qct = _qd_sides(dev, gen, P, N)
    B = P // qSPb
    qmp = k4("qd 2^21 probe", qst, qct, [qkp, *qvp], qSPp)
    b = torch.arange(B, device=dev)
    lo_b = torch.where(b == 0, H, 0)
    live = torch.clamp(N - b * qSPb, 0, qSPb)
    k5("qd 2^21", qd_join._halo_mat(qkb, B, qSPb, H), wins(H + live, lo_b),
       qmp[0], wins(qct))
    del qmp

    # one bucket row of MAX_SLOTS + ALIGN slots: 12 x 9,216 bytes of
    # shared memory per block (past the 48 KB default)
    S = rj.MAX_SLOTS + rj.ALIGN
    hk = torch.randint(0, 64, (4, S), generator=gen, device=dev)
    hk[:, ::7] = 12345
    hw = torch.tensor([[0, rj.MAX_SLOTS], [100, rj.MAX_SLOTS + 100],
                       [0, S], [5, 5]], dtype=torch.int32, device=dev)
    k5("MAX_SLOTS windows", hk, hw, hk.flip(1).contiguous(),
       hw.flip(0).contiguous())

    # keys over the full u64 range with 512 live 2^64-1 keys (their
    # bucket, the last, still fits its slots)
    pool = (torch.randint(-(1 << 62), 1 << 62, (1 << 20,), generator=gen,
                          device=dev) * 2
            + torch.randint(0, 2, (1 << 20,), generator=gen, device=dev))
    keys = pool[torch.randint(0, 1 << 20, (P,), generator=gen, device=dev)]
    keys[torch.randint(0, N, (512,), generator=gen, device=dev)] = -1
    fk, fv, fst, fct = _radix_side(dev, gen, P, N, bits, keys=keys)
    fm = k4("radix 2^21 full-range keys", fst, fct, [fk, *fv], SPb)
    k5("radix 2^21 full-range keys, live 2^64-1", fm[0], wins(fct), fm[0],
       wins(fct))
    del fm

    for name in out:
        if rj.LAUNCHES[name] <= before[name]:
            raise AssertionError(f"{name}: the kernel's launch count did "
                                 f"not grow")
    return out


# Phase 3b: the range expansion ops/sort_join.py::join_emit at two serving
# shapes.  (label, Pp, live probe rows, Pb, share of the live rows that
# match once, or None, exact total spread at random over the live rows,
# or None, out_size, or None for the total's size class)
EMIT_CASES = (
    # the TPC-H cells' Q7 and Q10 cuts: lineitem (~6,000,000 rows padded
    # to 2^23) probes one nation's suppliers (one quarter's orders), and
    # ~4% of its live rows match once
    ("Q7/Q10 shape", 1 << 23, 6_000_000, 1 << 14, 0.04, None, 1 << 18),
    # an intermediate join of workloads/bigdom: 2,000,000-row sides
    # emitting 4,264,621 pairs into their 2^23 class
    ("bigdom", 1 << 21, 2_000_000, 1 << 21, None, 4_264_621, None),
)


def emit_inputs(Pp: int, live: int, Pb: int, share, total, seed: int = 15):
    """(perm int32 [Pb], lo int32 [Pp], cnt int64 [Pp]) made with numpy
    from a seed: pad rows past `live` match nothing; lo is in range where
    cnt > 0 and 0 elsewhere."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if total is None:
        cnt = (rng.random(Pp) < share).astype(np.int64)
        cnt[live:] = 0
    else:
        cnt = np.bincount(rng.integers(0, live, total), minlength=Pp)
    lo = np.where(cnt > 0, rng.integers(0, Pb - cnt + 1), 0)
    return (rng.permutation(Pb).astype(np.int32), lo.astype(np.int32),
            cnt.astype(np.int64))


def emit_numpy(perm, lo, cnt, out_size: int) -> tuple:
    """The expansion on the host, row by row in probe order: each row's
    cnt pairs (perm[lo + k], row), the first out_size kept, 0 past
    them."""
    import numpy as np

    rows = np.repeat(np.arange(cnt.shape[0]), cnt)[:out_size]
    k = np.arange(rows.shape[0]) - (np.cumsum(cnt) - cnt)[rows]
    bpos = np.zeros(out_size, np.int32)
    ppos = np.zeros(out_size, np.int32)
    bpos[:rows.shape[0]] = perm[lo[rows] + k]
    ppos[:rows.shape[0]] = rows
    return bpos, ppos


def emit_bytes(cnt, out_size: int) -> int:
    """What an emit must move: lo (int32) and ccum (int64) of each row
    that owns a kept slot, perm (int32) at each kept slot, and both int32
    outputs over all out_size slots."""
    import numpy as np

    starts = np.cumsum(cnt) - cnt
    owners = int(np.count_nonzero((cnt > 0) & (starts < out_size)))
    return 12 * owners + 4 * min(int(cnt.sum()), out_size) + 8 * out_size


def phase_emit(dev, card: str, flush: torch.Tensor,
               cases=EMIT_CASES) -> dict:
    """join_emit at each case's shape with the total on the device (the
    compiled engine's form), exact against emit_numpy, then {label:
    median device ms}, each printed with its bytes and their share of the
    card's memory rate."""
    import numpy as np

    from sigmod2018_tpu_torch.ops.sort_join import join_emit
    from sigmod2018_tpu_torch.utils.floors import HBM_BYTES_PER_S
    from sigmod2018_tpu_torch.utils.padding import size_class

    out = {}
    for label, Pp, live, Pb, share, total, out_size in cases:
        perm, lo, cnt = emit_inputs(Pp, live, Pb, share, total)
        total = int(cnt.sum())
        out_size = out_size or size_class(total)
        args = (torch.from_numpy(perm).to(dev), torch.from_numpy(lo).to(dev),
                torch.from_numpy(np.cumsum(cnt)).to(dev),
                torch.tensor(total, device=dev))
        got = join_emit(*args, out_size=out_size)
        want = emit_numpy(perm, lo, cnt, out_size)
        for g, w, what in zip(got, want, ("build_pos", "probe_pos")):
            if not np.array_equal(g.cpu().numpy(), w):
                raise AssertionError(f"emit [{label}]: {what} differs from "
                                     f"the NumPy expansion")
        ms = median_ms(lambda: join_emit(*args, out_size=out_size), flush)
        nbytes = emit_bytes(cnt, out_size)
        share_of_rate = nbytes / (ms / 1e3) / HBM_BYTES_PER_S
        print(f"emit [{label}] Pp={Pp} live={live} Pb={Pb} matched rows="
              f"{int(np.count_nonzero(cnt))} total={total} out_size="
              f"{out_size}: exact against the NumPy expansion; {ms:.4f} ms "
              f"(median, device total); {nbytes} bytes (owners' lo and "
              f"ccum, kept slots' perm, both outputs), {share_of_rate:.2%} "
              f"of {HBM_BYTES_PER_S / 1e12:.2f} TB/s ({card})", flush=True)
        out[label] = ms
    return out


def generate_workloads() -> dict:
    """Write every workload's relation binaries: {name: seconds}."""
    from sigmod2018_tpu_torch.tools.workload import write_relations

    seconds = {}
    for name, params in WORKLOADS.items():
        t0 = time.perf_counter()
        write_relations(SMOKE_DIR / name, **params)
        seconds[name] = time.perf_counter() - t0
    return seconds


def workload_files(name: str):
    """(relation paths, .work lines, .result lines) of a workload."""
    src = ROOT / "workloads" / name
    init = [str(SMOKE_DIR / name / r)
            for r in (src / f"{name}.init").read_text().split()]
    return (init, (src / f"{name}.work").read_text().splitlines(),
            (src / f"{name}.result").read_text().splitlines())


def message_sort_form(sw, se, inv, lo, hi):
    """engine/factorized.py::message with the weights brought into key
    order by a sort keyed on the inverse permutation, where the port
    gathers by the prep-time permutation.  torch.sort takes one operand,
    so the other arrays follow by the indices it returns."""
    from sigmod2018_tpu_torch.engine.factorized import message

    return message(sw, se, torch.sort(inv)[1], lo, hi)


def phase_message(dev, card: str, flush: torch.Tensor) -> dict:
    """One factorized message on MESSAGE_EDGE of workloads/zipfbig, with
    random u64 weights on the live rows that pass a filter: exact against
    the NumPy twin's message, then {form: median device ms}."""
    import numpy as np

    from sigmod2018_tpu_torch.config import EngineConfig
    from sigmod2018_tpu_torch.engine import factorized
    from sigmod2018_tpu_torch.engine.executor import TorchEngine
    from sigmod2018_tpu_torch.storage.catalog import Catalog

    e = MESSAGE_EDGE
    catalog = Catalog.from_files(workload_files("zipfbig")[0],
                                 compute_stats=False)
    engine = TorchEngine(catalog, EngineConfig(platform="cuda"))
    perm, lo, hi = factorized.edge_ranks(engine, **e)
    P, n = perm.shape[0], catalog.relation(e["srel"]).num_tuples
    gen = torch.Generator(device=dev).manual_seed(2020)
    se = ((torch.arange(P, device=dev) < n)
          & (torch.rand(P, generator=gen, device=dev) < 0.7))
    sw = torch.randint(-(1 << 62), 1 << 62, (P,), generator=gen,
                       device=dev) * se
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(P, dtype=perm.dtype, device=dev)
    got_w, got_e = factorized.message(sw, se, perm, lo, hi)
    alt_w, alt_e = message_sort_form(sw, se, inv, lo, hi)
    skey = catalog.dense_column(e["srel"], e["scol"])
    rkey = catalog.dense_column(e["rrel"], e["rcol"])
    want_w, want_e = factorized._np_msg_cached(
        sw[:n].cpu().numpy().view(np.uint64), se[:n].cpu().numpy(),
        *factorized._np_edge_ranks(catalog, skey=skey, rkey=rkey, **e))
    n_r = rkey.shape[0]
    for form, (w, x) in (("gather", (got_w, got_e)),
                         ("sort", (alt_w, alt_e))):
        if not (np.array_equal(w[:n_r].cpu().numpy().view(np.uint64), want_w)
                and np.array_equal(x[:n_r].cpu().numpy(), want_e)):
            raise AssertionError(f"factorized message, {form} form != the "
                                 f"NumPy twin's on {e}")
    times = {
        "gather": median_ms(
            lambda: factorized.message(sw, se, perm, lo, hi), flush),
        "sort": median_ms(
            lambda: message_sort_form(sw, se, inv, lo, hi), flush)}
    print(f"factorized message [zipfbig edge {e}] Ps=Pr={P} live senders "
          f"{int(se.sum())} receivers with a sender {int(want_e.sum())}: "
          f"sums and exists exact against the NumPy twin; gather form "
          f"{times['gather']:.4f} ms, sort form {times['sort']:.4f} ms "
          f"(median, {card})", flush=True)

    # One whole query through factorized_result, its edge artifacts
    # cached: the host's time to dispatch it (no sync inside) beside the
    # card's time from its first launch to its last.
    from sigmod2018_tpu_torch.frontend.parser import parse_query

    text = [t for t in workload_files("zipfbig")[1] if t != "F"][
        MESSAGE_QUERY]
    query = parse_query(text)
    plan = factorized.plan_forest(query)
    n_msgs = (sum(len(edges) for edges in plan.edges)
              + len(factorized.down_edges(plan, query)))
    want = factorized.execute_query_factorized_np(query, catalog)
    if factorized.factorized_result(engine, query).line() != want:
        raise AssertionError(f"factorized_result != the NumPy twin on "
                             f"{text!r}")
    host = []
    for _ in range(15):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        factorized.factorized_result(engine, query)
        host.append((time.perf_counter() - t0) * 1e3)
    times["query_host"] = statistics.median(host)
    times["query_card"] = median_ms(
        lambda: factorized.factorized_result(engine, query), flush)
    print(f"factorized query [zipfbig {text!r}] {n_msgs} messages, line "
          f"equal to the NumPy twin's: host dispatch "
          f"{times['query_host']:.4f} ms, first launch to last on the card "
          f"{times['query_card']:.4f} ms (median, {card})", flush=True)
    return times


class _Feed:
    """Protocol stdin from a list of lines; notes when the first line
    after `Done` is requested, i.e. when prep has finished."""

    def __init__(self, lines, n_prep: int):
        self.lines, self.n_prep, self.i = lines, n_prep, 0
        self.t_serving = None

    def __iter__(self):
        return self

    def __next__(self) -> str:
        if self.i == self.n_prep and self.t_serving is None:
            self.t_serving = time.perf_counter()
        if self.i >= len(self.lines):
            raise StopIteration
        self.i += 1
        return self.lines[self.i - 1] + "\n"


def _reset_counts() -> None:
    from sigmod2018_tpu_torch.ops import ms_join, qd_join, radix_join

    ms_join.LAUNCHES = 0
    for counter in (radix_join.LAUNCHES, radix_join.BRANCHES,
                    qd_join.BRANCHES):
        for key in counter:
            counter[key] = 0


def _read_counts() -> dict:
    from sigmod2018_tpu_torch.ops import ms_join, qd_join, radix_join

    return {"K1": ms_join.LAUNCHES,
            "K4": radix_join.LAUNCHES["slot_fill"],
            "K5": radix_join.LAUNCHES["probe_counts"],
            "radix branches": dict(radix_join.BRANCHES),
            "qd branches": dict(qd_join.BRANCHES)}


# (label, compiled engine, fused-join member, runs per workload,
# workloads).  The compiled auto runs come first: their first run starts
# from an empty prep cache and teaches the second.
PATHS = [("compiled auto", True, "auto", RUNS_PER_WORKLOAD, tuple(WORKLOADS)),
         ("operator auto", False, "auto", 1, tuple(WORKLOADS)),
         ("compiled radix", True, "radix", 1, FORCED_WORKLOADS),
         ("compiled qd", True, "qd", 1, FORCED_WORKLOADS)]
MAIN_PATH = "compiled auto"


def host_syncs(counts: dict) -> int:
    """Host reads of one run: the engine's reads of intermediate totals
    and one branch read per forced radix or qd join."""
    return (counts["engine"]["segment_reads"]
            + sum(counts["radix branches"].values())
            + sum(counts["qd branches"].values()))


def phase_end_to_end(dev, card: str, prepared: dict) -> tuple:
    """Every workload under every path it runs under: ({path: summed
    kernel counts}, {path: {workload: K1 launches of its last run}},
    {(path, workload, run): (prep s, timed s)})."""
    import sigmod2018_tpu_torch.ops as ops
    from sigmod2018_tpu_torch.config import EngineConfig
    from sigmod2018_tpu_torch.io.repl import serve

    # Counts fused joins whose build side has a key table: there the
    # probe-only prefix-table member must stay off when radix or qd is
    # forced, and the forced member must serve the join.
    table_joins = []
    real_fused = ops.fused_join_auto

    def fused(*args, **kw):
        if kw.get("table") is not None:
            table_joins.append(kw.get("algo"))
        return real_fused(*args, **kw)

    ops.fused_join_auto = fused
    totals, k1_per_run, phases = {}, {}, {}
    try:
        for label, comp, algo, runs, names in PATHS:
            # prep before serving, so that _Feed's split is prep / timed
            config = EngineConfig(platform="cuda", join_algo=algo,
                                  compile_queries=comp, async_prep=False)
            total = {"K1": 0, "K4": 0, "K5": 0}
            k1_per_run[label] = {}
            for name in names:
                init, work, want = workload_files(name)
                for run in range(1, runs + 1):
                    feed = _Feed(init + ["Done"] + work, len(init) + 1)
                    out = io.StringIO()
                    del table_joins[:]
                    torch.cuda.reset_peak_memory_stats(dev)
                    _reset_counts()  # count this run's launches only
                    t0 = time.perf_counter()
                    engine = serve(feed, out, config)
                    t1 = time.perf_counter()
                    tiers = dict(engine.tiers)
                    counts = dict(_read_counts(), tiers=tiers,
                                  engine=dict(engine.counts))
                    got = out.getvalue().splitlines()
                    ok = sum(g == w for g, w in zip(got, want))
                    if len(got) != len(want) or ok != len(want):
                        raise AssertionError(
                            f"{name} under {label} run {run}: {ok}/"
                            f"{len(want)} lines equal the .result "
                            f"({len(got)} lines out)\n got: {got}\nwant: "
                            f"{want}")
                    _check_path(name, algo, counts, table_joins)
                    _check_tiers(name, algo, tiers,
                                 sum(line != "F" for line in work))
                    if comp and algo == "auto" and run > 1:
                        _check_taught(name, engine.counts)
                    for k in total:
                        total[k] += counts[k]
                    k1_per_run[label][name] = counts["K1"]
                    prep, timed = feed.t_serving - t0, t1 - feed.t_serving
                    phases[label, name, run] = (prep, timed)
                    print(f"end-to-end [{name} {label} run {run}] {ok}/"
                          f"{len(want)} lines equal {name}.result; engine "
                          f"{type(engine).__name__} {engine.counts}; host "
                          f"syncs {host_syncs(counts)}; "
                          f"launches K1 {counts['K1']} K4 {counts['K4']} "
                          f"K5 {counts['K5']}; radix branches "
                          f"{counts['radix branches']}, qd branches "
                          f"{counts['qd branches']}; served by tier "
                          f"{tiers}; fused joins with a "
                          f"key-table build side {len(table_joins)}; "
                          f"relations generated in {prepared[name]:.3f} s; "
                          f"prep {prep:.3f} s; timed phase {timed:.3f} s; "
                          f"peak device memory "
                          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
                          f" GiB ({card})", flush=True)
                    del engine  # the next run's peak holds its engine only
            totals[label] = total
    finally:
        ops.fused_join_auto = real_fused
    return totals, k1_per_run, phases


def print_phases(phases: dict, card: str) -> None:
    """Prep and timed phase of both engines per workload, side by side."""
    for name in WORKLOADS:
        op = phases["operator auto", name, 1]
        c1 = phases["compiled auto", name, 1]
        c2 = phases["compiled auto", name, 2]
        print(f"phases [{name}] prep / timed s: operator engine {op[0]:.3f}"
              f" / {op[1]:.3f}; compiled engine run 1 {c1[0]:.3f} / "
              f"{c1[1]:.3f}, run 2 {c2[0]:.3f} / {c2[1]:.3f} ({card})",
              flush=True)


def _check_taught(name: str, counts: dict) -> None:
    """A compiled run after one that taught every query its classes:
    every query is sized beforehand and every size holds."""
    if counts["retried"] or counts["incremental"]:
        raise AssertionError(f"{name}, compiled run after a teaching run: "
                             f"{counts['retried']} retried, "
                             f"{counts['incremental']} served with host "
                             f"reads ({counts})")


def phase_sync_free(card: str) -> dict:
    """One bigdom query with an intermediate join of 2,000,000 rows,
    dispatched from the learned classes with host syncs made errors:
    {"host_ms": dispatch ms of the planned and the fast-path dispatch}."""
    from sigmod2018_tpu_torch.config import EngineConfig
    from sigmod2018_tpu_torch.engine.compiled import CompiledTorchEngine
    from sigmod2018_tpu_torch.engine.executor import format_batch
    from sigmod2018_tpu_torch.frontend.parser import parse_query
    from sigmod2018_tpu_torch.ops import ms_join
    from sigmod2018_tpu_torch.storage.catalog import Catalog

    init, work, want = workload_files("bigdom")
    engine = CompiledTorchEngine(Catalog.from_files(init),
                                 EngineConfig(platform="cuda"))
    engine.prefetch()
    texts = [t for t in work if t != "F"]
    pick = None
    for i, text in enumerate(texts):
        learned = engine._learned(parse_query(text))
        if learned and max(learned) >= 2_000_000:
            pick = i
            break
    if pick is None:
        raise AssertionError("bigdom: no learned query with an "
                             "intermediate join of 2,000,000 rows")
    query = parse_query(texts[pick])
    results, host_ms = [], []
    _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            results.append(engine.execute_async(query))
            host_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    k1 = ms_join.LAUNCHES
    lines = format_batch(results)
    if lines != [want[pick]] * 2:
        raise AssertionError(f"sync-free bigdom query {texts[pick]!r}: "
                             f"{lines} != {want[pick]!r}")
    if k1 <= 0:
        raise AssertionError("sync-free bigdom query: K1 never launched")
    if engine.counts["learned"] != 2 or engine.counts["retried"]:
        raise AssertionError(f"sync-free bigdom query not served from its "
                             f"learned classes: {engine.counts}")
    print(f"sync-free dispatch [bigdom query {pick + 1} {texts[pick]!r}, "
          f"classes {engine._learned(query)}] no host sync under "
          f"set_sync_debug_mode('error'); K1 {k1} launches; line equal "
          f"to bigdom.result; host dispatch {host_ms[0]:.3f} ms planned, "
          f"{host_ms[1]:.3f} ms fast path ({card})", flush=True)
    return {"host_ms": host_ms, "pick": pick}


def _stats_rows(catalog) -> list:
    return [[dataclasses.astuple(s) for s in rel] for rel in catalog.stats]


def phase_prep_stats(card: str) -> dict:
    """big's 12 columns: stats by NumPy, by the native loader and from a
    stats-cache hit, equal in all six fields: {way: seconds}."""
    import numpy as np

    from sigmod2018_tpu_torch.storage.catalog import Catalog

    init = workload_files("big")[0]
    cache = SMOKE_DIR / "prep-stats"
    shutil.rmtree(cache, ignore_errors=True)
    seconds, cats = {}, {}
    try:
        for way, loc, native in (("numpy", "0", False),
                                 ("native", "0", True),
                                 ("cache miss", str(cache), True),
                                 ("cache hit", str(cache), True)):
            os.environ["S18_PREP_CACHE"] = loc
            t0 = time.perf_counter()
            cats[way] = Catalog.from_files(init, native=native)
            seconds[way] = time.perf_counter() - t0
    finally:
        os.environ["S18_PREP_CACHE"] = str(PREP_CACHE)
    want = _stats_rows(cats["numpy"])
    for way in ("native", "cache hit"):
        if _stats_rows(cats[way]) != want:
            raise AssertionError(f"big: stats {way} != NumPy's")
    ncols = sum(len(r) for r in want)
    for rid, rel in enumerate(cats["native"].relations):
        for cid, col in enumerate(rel.columns):
            if not np.array_equal(col, cats["numpy"].column(rid, cid)):
                raise AssertionError(f"big: native column {rid}.{cid} != "
                                     f"the file's")
    # a hit maps the files (np.memmap) and takes the stats from the cache
    if not isinstance(cats["cache hit"].column(0, 0), np.memmap):
        raise AssertionError("big: the second cached load was not a hit")
    rows = cats["numpy"].relation(0).num_tuples
    print(f"prep stats [big, {ncols} columns of {rows:,} rows]: equal in "
          f"all six fields (NumPy, native, cache hit); NumPy "
          f"{seconds['numpy']:.3f} s, native {seconds['native']:.3f} s, "
          f"cache miss (native + write) {seconds['cache miss']:.3f} s, "
          f"cache hit {seconds['cache hit']:.3f} s ({card})", flush=True)
    return seconds


# Phase 7b's harness runs, (label, S18_* switches), per workload.  big and
# bigdom start from an emptied prep cache; the others start warm from
# phase 5's (the same relation files and sizing config), and run with the
# warm-up tier and without it.
HARNESS_RUNS = {
    name: ((("cold", {}), ("warm", {}),
            ("warm, blocking prep", {"S18_ASYNC_PREP": "0"}))
           if name in FORCED_WORKLOADS else
           (("warm", {}), ("warm, no tier", {"S18_WARMUP_ORACLE": "0"})))
    for name in WORKLOADS}
# workloads of which every query references more than 2^21 base rows
# (S18_WARMUP_ORACLE's default): the warm-up tier answers none of them
NO_TIER_WORKLOADS = ("big", "bigdom", "zipfbig")

# What every fresh `python -m sigmod2018_tpu_torch` pays before its first
# query, step by step (seconds on the process's own clock).
FRESH_PROCESS = """
import json, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
torch.zeros(1, device="cuda").sum().item()
t2 = time.perf_counter()
import sigmod2018_tpu_torch.engine.compiled, sigmod2018_tpu_torch.io.repl
t3 = time.perf_counter()
print(json.dumps({"import torch": t1 - t0,
                  "CUDA start + first launch": t2 - t1,
                  "import of the port": t3 - t2}))
"""


# `import torch` in a thread while the main thread waits, as the driver's
# card thread does it (on one malloc arena, io/repl.py::one_malloc_arena,
# which `python -m sigmod2018_tpu_torch` calls); seconds on the process's
# clock
THREAD_IMPORT = """
import json, threading, time
from sigmod2018_tpu_torch.io.repl import one_malloc_arena
if not one_malloc_arena():
    raise SystemExit("no mallopt")
t0 = time.perf_counter()
took = []

def run():
    import torch
    took.append(time.perf_counter() - t0)

thread = threading.Thread(target=run)
thread.start()
thread.join()
print(json.dumps(took[0]))
"""


def thread_import_seconds() -> float:
    """THREAD_IMPORT in a fresh process: seconds of its `import torch`."""
    proc = subprocess.run(
        [sys.executable, "-c", THREAD_IMPORT],
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"import in a thread: {proc.stderr[-4000:]}")
    return json.loads(proc.stdout.splitlines()[-1])


def import_time_top(n: int = 5) -> list:
    """The n largest cumulative entries of `python -X importtime -c
    "import torch"` in a fresh process: [(module, seconds)]."""
    proc = subprocess.run([sys.executable, "-X", "importtime", "-c",
                           "import torch"], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"-X importtime: {proc.stderr[-4000:]}")
    rows = []
    for line in proc.stderr.splitlines():
        parts = line.split("|")
        if line.startswith("import time:") and parts[1].strip().isdigit():
            rows.append((parts[2].strip(), int(parts[1]) / 1e6))
    return sorted(rows, key=lambda r: -r[1])[:n]


def fresh_process_steps(card: str) -> dict:
    """FRESH_PROCESS in a subprocess: {step: seconds}, with the whole
    process's wall time (interpreter start and exit included), then
    THREAD_IMPORT's; then the largest cumulative imports of `import
    torch`."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", FRESH_PROCESS],
                          env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"fresh process: {proc.stderr[-4000:]}")
    steps = json.loads(proc.stdout.splitlines()[-1])
    steps["whole process"] = wall
    steps["import torch in the card's thread"] = thread_import_seconds()
    top = import_time_top()
    print("fresh process: " + ", ".join(f"{k} {v:.3f} s"
                                        for k, v in steps.items())
          + "; import torch's largest cumulative imports (-X importtime): "
          + ", ".join(f"{m} {t:.3f} s" for m, t in top) + f" ({card})",
          flush=True)
    return steps


def harness_run(name: str, root: Path, cache: Path, extra: dict,
                driver=("-m", "sigmod2018_tpu_torch")) -> dict:
    """One fresh `python -m sigmod2018_tpu_torch` (or `python *driver`)
    of the package under `root` on workload `name` under tools/harness.py
    (1 s prep window), with prep cache `cache`: its timed ms, query count,
    whole run's seconds, the engine's counts line, tier counts, K1/K4/K5
    launches and start timeline (each of the last two None when it
    prints none).  Every line must be exact and
    the process must end its serving normally (its tier line printed)."""
    import re

    src = ROOT / "workloads" / name
    init = SMOKE_DIR / name / f"{name}.init"  # bare names, beside them
    init.write_text((src / f"{name}.init").read_text())
    env = dict(os.environ, PYTHONPATH=str(root), S18_PREP_CACHE=str(cache),
               **extra)
    cmd = [sys.executable, str(ROOT / "tools" / "harness.py"), str(init),
           str(src / f"{name}.work"), str(src / f"{name}.result"), "--",
           sys.executable, *driver]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300)
    wall = time.perf_counter() - t0
    hit = re.search(r"(\d+) queries, 0 mismatches, (\d+) ms", proc.stdout)
    err = proc.stderr.splitlines()
    tiers = next((ln for ln in err if ln.startswith("served by tier: ")),
                 None)
    engine = next((ln for ln in err if ln.startswith("engine ")), None)
    launches = next((ln for ln in err
                     if ln.startswith("kernel launches: ")), None)
    if proc.returncode != 0 or hit is None or tiers is None or engine is None:
        raise AssertionError(
            f"harness on {name} ({extra}, {root}): rc {proc.returncode}\n"
            f"{proc.stdout}\n{proc.stderr[-4000:]}")
    start = next((json.loads(ln[len("start "):])
                  for ln in err if ln.startswith("start {")), None)
    return dict(ms=int(hit.group(2)), queries=int(hit.group(1)), wall=wall,
                engine=engine, tiers=_counts(tiers),
                launches=None if launches is None else _counts(launches),
                start=start)


def _counts(line: str) -> dict:
    """{name: int} of a `label: name=N name=N ..` line of the driver."""
    return {k: int(v) for k, v in (kv.split("=")
                                   for kv in line.split(": ")[1].split())}


def _start_text(start) -> str:
    if start is None:
        return "no start line"
    return "start " + " ".join(
        f"{k} {'-' if v is None else f'{v:.3f}'}" for k, v in start.items())


def phase_harness(card: str, phases: dict) -> dict:
    """Fresh processes under the contest harness, per workload and run of
    HARNESS_RUNS: {(workload, run): timed ms}.  big and bigdom start from
    an emptied prep cache, the others from a copy of phase 5's."""
    timed = {}
    for name, runs in HARNESS_RUNS.items():
        cache = SMOKE_DIR / f"harness-prep-{name}"
        shutil.rmtree(cache, ignore_errors=True)
        if name in FORCED_WORKLOADS:
            cache.mkdir(parents=True)
        else:
            shutil.copytree(PREP_CACHE, cache)
        for label, extra in runs:
            rec = harness_run(name, ROOT, cache, extra)
            warm_host = rec["tiers"].get("warmup_host")
            if warm_host is None:
                raise AssertionError(f"harness on {name} ({label}): no "
                                     f"warmup_host count")
            if warm_host and (name in NO_TIER_WORKLOADS
                              or extra.get("S18_WARMUP_ORACLE") == "0"):
                raise AssertionError(
                    f"harness on {name} ({label}): the warm-up tier "
                    f"answered {warm_host} queries")
            timed[name, label] = rec["ms"]
            in_proc = [phases["compiled auto", name, run][1] * 1e3
                       for run in (1, 2)]
            print(f"harness [{name} {label}] {rec['queries']} queries exact; "
                  f"timed phase {rec['ms']} ms (in-process, phase 5: "
                  f"compiled run 1 {in_proc[0]:.1f} ms, run 2 "
                  f"{in_proc[1]:.1f} ms); whole harness run "
                  f"{rec['wall']:.3f} s; {rec['engine']}; served by tier "
                  f"{rec['tiers']}; {_start_text(rec['start'])} ({card})",
                  flush=True)
    return timed


def _recording(steps, seen: list):
    """A query's steps (TorchEngine._steps) passed through, keeping each
    intermediate join and its total as the engine reads it."""
    try:
        item = next(steps)
        while True:
            seen.append((str(item[0]), int(item[1])))
            item = steps.send((yield item))
    except StopIteration as done:
        return done.value
    finally:
        steps.close()


def phase_trace(card: str, pick: int) -> list:
    """bigdom query `pick` (it has an intermediate join) served by the
    operator engine under S18_TRACE=json and S18_EXPLAIN=1: the checks of
    the module docstring; returns its trace records."""
    import contextlib

    from sigmod2018_tpu_torch.config import EngineConfig
    from sigmod2018_tpu_torch.engine.executor import TorchEngine
    from sigmod2018_tpu_torch.io.repl import serve
    from sigmod2018_tpu_torch.utils import floors

    init, work, want = workload_files("bigdom")
    text = [t for t in work if t != "F"][pick]
    config = EngineConfig(platform="cuda", compile_queries=False,
                          trace="json", explain=True, async_prep=False,
                          batch_workers=1)
    seen, err, out = [], io.StringIO(), io.StringIO()
    real_sized = TorchEngine._sized
    TorchEngine._sized = lambda self, steps, guard: real_sized(
        self, _recording(steps, seen), guard)
    feed = _Feed(init + ["Done", text, "F"], len(init) + 1)
    try:
        with contextlib.redirect_stderr(err):
            t0 = time.perf_counter()
            engine = serve(feed, out, config)
            t1 = time.perf_counter()
    finally:
        TorchEngine._sized = real_sized
    if type(engine) is not TorchEngine:
        raise AssertionError(f"S18_TRACE served with {type(engine)}")
    if out.getvalue().splitlines() != [want[pick]]:
        raise AssertionError(f"traced bigdom query {text!r}: "
                             f"{out.getvalue()!r} != {want[pick]!r}")
    lines = err.getvalue().splitlines()
    records = [json.loads(ln) for ln in lines if ln.startswith("{")]
    actual = [(ln.split(": actual ")[0][len("--   "):],
               int(ln.split(": actual ")[1]))
              for ln in lines if ": actual " in ln]
    ops_ = [op for rec in records for op in rec["ops"]]
    family = floors.FUSED_OPS + floors.COUNT_OPS + (floors.TABLE_COUNT_OP,)
    wall_ms = (t1 - feed.t_serving) * 1e3
    total_ms = sum(op["device_ms"] for op in ops_)
    problems = []
    if len(records) != 1 or records[0]["query"] != text:
        problems.append(f"{len(records)} trace records")
    if not any(ln.startswith("-- plan: ") for ln in lines):
        problems.append("no plan line")
    if any(op["device_ms"] < 0 for op in ops_):
        problems.append("a negative device_ms")
    if not any(op["op"] in family for op in ops_) or any(
            "floor_ms" not in op for op in ops_ if op["op"] in family):
        problems.append("a join-family op without floor_ms")
    if total_ms > wall_ms:
        problems.append(f"device ms {total_ms:.3f} > wall {wall_ms:.3f}")
    if not seen or actual != seen:
        problems.append(f"actual lines {actual} != totals read {seen}")
    if problems:
        raise AssertionError(f"traced bigdom query {text!r}: {problems}\n"
                             + "\n".join(lines[-40:]))
    print(f"trace [bigdom query {pick + 1} {text!r}, operator engine, "
          f"S18_TRACE=json S18_EXPLAIN=1] line equal to bigdom.result; "
          f"{len(ops_)} ops, {total_ms:.3f} ms on the card of {wall_ms:.3f} "
          f"ms of serving; actual totals {seen} equal the totals read "
          f"({card})", flush=True)
    for op in sorted(ops_, key=lambda o: -o["device_ms"])[:5]:
        print(f"trace top op: {op['op']} [{op['shapes']}] "
              f"{op['device_ms']:.4f} ms, {op['bytes']} bytes, hbm_frac "
              f"{op['hbm_frac']}, floor_ms {op.get('floor_ms')}, floor_frac "
              f"{op.get('floor_frac')} ({card})", flush=True)
    return records


# Phase 8: (label, mesh config, compiled engine, runs per workload,
# workloads).  The compiled mesh-4 runs come first, from an emptied prep
# cache: the first run teaches the second.  The strategy runs are set so
# that, with the default runs, broadcast, shuffle and skew each serve a
# join: on zipf the MCV sketch's hot key (a Zipf(1.3) head of about a
# quarter of the rows) passes skew_factor x the average shard share at
# S18_SKEW=1 on 4 shards and at the default 2 on 8, and every build side
# broadcasts under S18_BCAST=2^22 (the JAX package's DistCompiledEngine
# makes the same choices on the CPU).
MESH_PATHS = [
    ("mesh4 a2a compiled", dict(mesh_devices=4), True, RUNS_PER_WORKLOAD,
     tuple(WORKLOADS)),
    ("mesh4 a2a operator", dict(mesh_devices=4), False, 1,
     FORCED_WORKLOADS),
    ("mesh8 ring compiled", dict(mesh_devices=8, exchange="ring"), True, 1,
     ("bigdom", "zipf")),
    ("mesh4 skew compiled", dict(mesh_devices=4, skew_factor=1), True, 1,
     ("zipf",)),
    ("mesh4 broadcast compiled", dict(mesh_devices=4,
                                      bcast_threshold=1 << 22), True, 1,
     ("zipf",)),
]
MESH_PREP_CACHE = SMOKE_DIR / "mesh-prep"


def phase_mesh(card: str, phases: dict) -> dict:
    """The mesh path on the card: every line of every MESH_PATHS run
    equal to the .result, its tiers adding up, the second compiled
    mesh-4 run of each workload sized from what the first learned (no
    retry, no host read of a total), K1 launching in bigdom's mesh-4
    runs, and broadcast, shuffle and skew each serving a join.  Returns
    ({run label: K1 launches}, {(path, workload, run): (prep s, timed
    s)})."""
    import collections

    from sigmod2018_tpu_torch.config import EngineConfig
    from sigmod2018_tpu_torch.io.repl import serve
    from sigmod2018_tpu_torch.parallel import collectives, make_mesh

    for n in (4, 8):
        devs = make_mesh(n, "cuda").flat
        print(f"mesh of {n}: shard -> device "
              f"{ {i: str(d) for i, d in enumerate(devs)} }; "
              f"torch.cuda.device_count() {torch.cuda.device_count()}",
              flush=True)
    shutil.rmtree(MESH_PREP_CACHE, ignore_errors=True)
    MESH_PREP_CACHE.mkdir(parents=True)
    os.environ["S18_PREP_CACHE"] = str(MESH_PREP_CACHE)
    strategies = collections.Counter()
    k1, times = {}, {}
    for label, mesh_cfg, comp, runs, names in MESH_PATHS:
        config = EngineConfig(platform="cuda", compile_queries=comp,
                              async_prep=False, **mesh_cfg)
        for name in names:
            init, work, want = workload_files(name)
            for run in range(1, runs + 1):
                feed = _Feed(init + ["Done"] + work, len(init) + 1)
                out = io.StringIO()
                _reset_counts()
                collectives.reset_calls()
                t0 = time.perf_counter()
                engine = serve(feed, out, config)
                t1 = time.perf_counter()
                counts = _read_counts()
                calls = dict(collectives.CALLS)
                got = out.getvalue().splitlines()
                ok = sum(g == w for g, w in zip(got, want))
                if len(got) != len(want) or ok != len(want):
                    raise AssertionError(
                        f"{name} under {label} run {run}: {ok}/{len(want)} "
                        f"lines equal the .result\n got: {got}\nwant: "
                        f"{want}")
                _check_tiers(name, "auto", engine.tiers,
                             sum(line != "F" for line in work))
                if comp and run > 1:
                    _check_taught(name, engine.counts)
                    if engine.counts["segment_reads"]:
                        raise AssertionError(
                            f"{name} under {label} run {run}: "
                            f"{engine.counts['segment_reads']} totals read")
                run_strategies = collections.Counter(
                    getattr(engine, "join_strategies", ()))
                strategies.update(run_strategies)
                k1[f"{label} {name} run {run}"] = counts["K1"]
                prep, timed = feed.t_serving - t0, t1 - feed.t_serving
                times[label, name, run] = (prep, timed)
                single = phases["compiled auto" if comp else "operator auto",
                                name, min(run, 2 if comp else 1)]
                syncs = engine.counts["segment_reads"] + engine.counts.get(
                    "cap_reads", 0)
                print(f"mesh [{name} {label} run {run}] {ok}/{len(want)} "
                      f"lines equal {name}.result; engine "
                      f"{type(engine).__name__} {engine.counts}; "
                      f"collectives {calls}; join strategies "
                      f"{dict(run_strategies)}; K1 {counts['K1']} "
                      f"launches; host syncs {syncs}; served by tier "
                      f"{dict(engine.tiers)}; prep {prep:.3f} s, timed "
                      f"phase {timed:.3f} s (single device, phase 5: prep "
                      f"{single[0]:.3f} s, timed phase {single[1]:.3f} s) "
                      f"({card})", flush=True)
                del engine
    if not all(k1[f"mesh4 a2a compiled bigdom run {r}"] > 0
               for r in range(1, RUNS_PER_WORKLOAD + 1)):
        raise AssertionError(f"bigdom on the mesh: K1 never launched {k1}")
    missing = {"broadcast", "shuffle", "skew"} - set(strategies)
    if missing:
        raise AssertionError(f"phase 8 served no {sorted(missing)} join: "
                             f"{dict(strategies)}")
    print(f"mesh join strategies over phase 8: {dict(strategies)} ({card})",
          flush=True)
    return k1, times


# (label, --join, mesh shards or 0, queries) of phase 9's fuzz runs
FUZZ_SEED = 99
FUZZ_RUNS = [("auto", "auto", 0, 200), ("ms", "ms", 0, 200),
             ("radix", "radix", 0, 200), ("qd", "qd", 0, 200),
             ("mesh 4", "auto", 4, 60)]
# the kernels each forced member's fuzz run must launch
FUZZ_KERNELS = {"ms": ("K1",), "radix": ("K4", "K5"), "qd": ("K4", "K5")}


def phase_tools(card: str) -> None:
    """Phase 9: the smoke gate, the fuzz runs of FUZZ_RUNS (each held to
    0 failures and to the kernels FUZZ_KERNELS names), then the three
    measuring tools' lines."""
    from sigmod2018_tpu_torch.tools import (bench_probe, fuzz, microbench,
                                            roofline, smoke)

    t0 = time.perf_counter()
    if smoke.main(["--platform", "cuda"]) != 0:
        raise AssertionError("tools.smoke failed (its log names the cases)")
    for label, join, shards, n in FUZZ_RUNS:
        _reset_counts()
        t1 = time.perf_counter()
        fails = fuzz.run(n, FUZZ_SEED, platform="cuda", join=join,
                         shards=shards)
        counts = _read_counts()
        print(f"fuzz [{label}] seed {FUZZ_SEED}: {n} queries, {fails} "
              f"failures; K1 {counts['K1']}, K4 {counts['K4']}, K5 "
              f"{counts['K5']} launches; radix branches "
              f"{counts['radix branches']}, qd branches "
              f"{counts['qd branches']}; {time.perf_counter() - t1:.1f} s "
              f"({card})", flush=True)
        if fails:
            raise AssertionError(f"fuzz under {label}: {fails} failures")
        missing = [k for k in FUZZ_KERNELS.get(label, ()) if counts[k] <= 0]
        if missing:
            raise AssertionError(f"fuzz under {label}: {missing} never "
                                 f"launched: {counts}")
    bench_probe.run(12, 22, "cuda")
    # phase 3 times K1, K4 and K5 at the kernel table's shapes
    roofline.run(21, "cuda", kernel_stages=False)
    microbench.run(23, "cuda")
    print(f"phase 9 (tools): {time.perf_counter() - t0:.1f} s ({card})",
          flush=True)


# Phase 10: two ranks of `python -m sigmod2018_tpu_torch` serve together
# (S18_COORD_ADDR on a free port, S18_NUM_PROCS=2, S18_PROC_ID 0 and 1),
# S18_MESH=4: two shards a rank, both ranks' shards on the one card, the
# collectives over gloo through host memory.  (label, phase 8's run of
# the same switches on one process, S18_* switches, runs per workload,
# workloads.)  The a2a runs come first, from an emptied prep cache that
# both ranks share (rank 0 writes the learned file): the first run
# teaches the second.  The zipf runs are phase 8's strategy runs.
MP_WORLD = 2
MP_PATHS = [
    ("2 ranks mesh4 a2a", "mesh4 a2a compiled", {}, RUNS_PER_WORKLOAD,
     tuple(WORKLOADS)),
    ("2 ranks mesh4 skew", "mesh4 skew compiled", {"S18_SKEW": "1"}, 1,
     ("zipf",)),
    ("2 ranks mesh4 broadcast", "mesh4 broadcast compiled",
     {"S18_BCAST": str(1 << 22)}, 1, ("zipf",)),
]
MP_PREP_CACHE = SMOKE_DIR / "mp-prep"
MP_TIMEOUT_S = 300  # per run of both ranks; a hang fails the phase
MP_K1_WORKLOADS = ("bigdom",)  # K1 must launch on every rank here
MP_STRATEGIES = ("broadcast", "shuffle", "skew")


def _rank_env(**s18) -> dict:
    """A child's environment: this one without its S18_* switches (the
    earlier phases set S18_PREP_CACHE), the repository importable."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("S18_")}
    return dict(env, PYTHONPATH=str(ROOT), **s18)


def multiprocess_runs(platform: str, files: dict, paths=MP_PATHS,
                      prep_cache: Path = MP_PREP_CACHE,
                      timeout: float = MP_TIMEOUT_S,
                      k1_workloads=MP_K1_WORKLOADS,
                      strategies=MP_STRATEGIES) -> list:
    """Every run of `paths` as MP_WORLD ranks on `files` ({workload:
    (relation paths, .work lines, .result lines)}), each rank held to
    every line of the .result, its tiers adding up, the same collective
    calls as the other ranks, K1 launching on `k1_workloads`, and on a
    taught run (run > 1) no retry and no total read; over all runs each
    of `strategies` serves a join.  Returns one record per run: label,
    phase 8's label, workload, run, whole-run seconds and each rank's
    `process {..}` report with its lines equal."""
    from sigmod2018_tpu_torch.parallel.launch import run_ranks

    shutil.rmtree(prep_cache, ignore_errors=True)
    prep_cache.mkdir(parents=True)
    base = _rank_env(S18_PLATFORM=platform, S18_MESH="4",
                     S18_PREP_CACHE=str(prep_cache), S18_ASYNC_PREP="0")
    records, served = [], set()
    for label, mesh_label, extra, runs, names in paths:
        for name in names:
            init, work, want = files[name]
            text = "\n".join(init + ["Done"] + work) + "\n"
            queries = sum(line != "F" for line in work)
            for run in range(1, runs + 1):
                t0 = time.perf_counter()
                outs = run_ranks([sys.executable, "-m",
                                  "sigmod2018_tpu_torch"], MP_WORLD,
                                 dict(base, **extra), text, timeout)
                wall = time.perf_counter() - t0
                reports = []
                for rank, (stdout, stderr) in enumerate(outs):
                    got = stdout.splitlines()
                    ok = sum(g == w for g, w in zip(got, want))
                    if len(got) != len(want) or ok != len(want):
                        raise AssertionError(
                            f"{name} under {label} run {run}, rank {rank}:"
                            f" {ok}/{len(want)} lines equal the .result\n"
                            f" got: {got}\nwant: {want}")
                    rep = json.loads(next(
                        ln for ln in stderr.splitlines()
                        if ln.startswith("process {"))[len("process "):])
                    where = f"{name} under {label} run {run}, rank {rank}"
                    _check_tiers(name, "auto", rep["tiers"], queries)
                    if run > 1:
                        _check_taught(where, rep["counts"])
                        if rep["counts"]["segment_reads"]:
                            raise AssertionError(
                                f"{where}: {rep['counts']['segment_reads']}"
                                f" totals read")
                    if name in k1_workloads and rep["launches"]["K1"] <= 0:
                        raise AssertionError(f"{where}: K1 never launched")
                    served.update(rep["join_strategies"])
                    reports.append(dict(rep, lines_equal=ok))
                if any(r["collectives"] != reports[0]["collectives"]
                       for r in reports):
                    raise AssertionError(
                        f"{name} under {label} run {run}: the ranks' "
                        f"collective calls differ: "
                        f"{[r['collectives'] for r in reports]}")
                records.append(dict(label=label, mesh_label=mesh_label,
                                    name=name, run=run, wall=wall,
                                    ranks=reports))
    missing = set(strategies) - served
    if missing:
        raise AssertionError(f"the ranks served no {sorted(missing)} join")
    return records


def collective_costs(platform: str, timeout: float = MP_TIMEOUT_S) -> tuple:
    """tools/collective_cost.py on 4 shards in one process and as
    MP_WORLD ranks: (one process's report, [each rank's report])."""
    from sigmod2018_tpu_torch.parallel.launch import run_ranks

    argv = [sys.executable, "-m",
            "sigmod2018_tpu_torch.tools.collective_cost", "--platform",
            platform]
    env = _rank_env()
    one = subprocess.run(argv, env=env, capture_output=True, text=True,
                         timeout=timeout)
    if one.returncode != 0:
        raise AssertionError(f"collective_cost in one process: rc "
                             f"{one.returncode}\n{one.stderr[-4000:]}")
    ranks = run_ranks(argv, MP_WORLD, env, "", timeout)
    return (json.loads(one.stdout.splitlines()[-1]),
            [json.loads(out.splitlines()[-1]) for out, _ in ranks])


def phase_multiprocess(card: str, phases: dict, mesh_times: dict) -> dict:
    """Phase 10: MP_PATHS on the card, every rank's line beside phase 8's
    one-process mesh-4 run and phase 5's single device, then the cost of
    each collective as two ranks and in one process.  Returns {run and
    rank label: K1 launches}."""
    from sigmod2018_tpu_torch.tools import collective_cost

    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # this process's cached blocks, for the ranks
    records = multiprocess_runs("cuda", {n: workload_files(n)
                                         for n in WORKLOADS})
    k1 = {}
    for rec in records:
        name, run = rec["name"], rec["run"]
        mesh = mesh_times[rec["mesh_label"], name, run]
        single = phases["compiled auto", name, run]
        for rep in rec["ranks"]:
            k1[f"{rec['label']} {name} run {run} rank {rep['rank']}"] = (
                rep["launches"]["K1"])
            counts = rep["counts"]
            print(f"multi-process [{name} {rec['label']} run {run}] rank "
                  f"{rep['rank']} of {rep['world']}: {rep['lines_equal']}/"
                  f"{sum(rep['tiers'].values())} lines equal {name}.result; "
                  f"collectives "
                  f"{rep['collectives']} over {rep['transport']}; join "
                  f"strategies {rep['join_strategies']}; launches "
                  f"{rep['launches']}; host syncs "
                  f"{counts['segment_reads']}; engine {counts}; served by "
                  f"tier {rep['tiers']}; prep {rep['prep_s']:.3f} s, timed "
                  f"phase {rep['timed_s']:.3f} s; both ranks' processes "
                  f"{rec['wall']:.3f} s (one process on 4 shards, phase 8: "
                  f"prep {mesh[0]:.3f} s, timed phase {mesh[1]:.3f} s; one "
                  f"device, phase 5: prep {single[0]:.3f} s, timed phase "
                  f"{single[1]:.3f} s) ({card})", flush=True)
    one, ranks = collective_costs("cuda")
    for case, c in one["cases"].items():
        print(f"collective cost [{case}] as {MP_WORLD} ranks over "
              f"{ranks[0]['transport']}: "
              + " / ".join(f"{r['cases'][case]['ms']:.4f}" for r in ranks)
              + f" ms per rank; in one process ({one['transport']}): "
              f"{c['ms']:.4f} ms; bytes sent per rank "
              f"{ranks[0]['cases'][case]['bytes']:,} (host clock around the "
              f"call and a synchronize, median of "
              f"{collective_cost.REPS}) ({card})", flush=True)
    big = (f"all_to_all [{collective_cost.SHARDS}, "
           f"{collective_cost.A2A_ROWS[-1]:,}]")
    print(f"collective cost [{big} in parts] as {MP_WORLD} ranks: "
          + "; ".join(f"{part} " + " / ".join(
              f"{r['a2a_parts'][part]:.4f}" for r in ranks) + " ms"
              for part in ranks[0]["a2a_parts"])
          + " per rank (stage: device to host and the send buffer's "
          f"layout; exchange: gloo, after a barrier; unstage: layout and "
          f"host to device; median of {collective_cost.REPS}) ({card})",
          flush=True)
    print(f"phase 10 (multi-process): {time.perf_counter() - t0:.1f} s "
          f"({card})", flush=True)
    return k1


# Phase 11: the routing thresholds S18_EMIT_MS_MIN and S18_RADIX_MIN
# (read at import) in fresh processes under the contest harness, each arm
# on each workload from its own copy of phase 5's prep cache.  Edge arms,
# once per workload, with the warm-up tier off so that the card serves
# every query: at 0/0 every emitting count and every auto fused join takes
# K1, at 2^62/2^62 none does.  Crossover arms, in turns on the
# 2,000,000-row workloads: the defaults against the crossovers that
# tools/bench_probe measured on the H100 (probe 2^22, fused 2^20).
HUGE_ROWS = str(1 << 62)
THRESHOLD_EDGE = (
    ("0/0", {"S18_EMIT_MS_MIN": "0", "S18_RADIX_MIN": "0"}),
    ("2^62/2^62", {"S18_EMIT_MS_MIN": HUGE_ROWS, "S18_RADIX_MIN": HUGE_ROWS}))
# zipf too: its joins (2^16 padded rows a side) are the only ones of the
# five below the default thresholds, so only there does 0/0 change a route
THRESHOLD_EDGE_WORKLOADS = ("big", "bigdom", "zipfbig", "scaled", "zipf")
THRESHOLD_CROSSOVER = (
    ("defaults 2^18/2^18", {}),
    ("crossovers 2^22/2^20", {"S18_EMIT_MS_MIN": str(1 << 22),
                              "S18_RADIX_MIN": str(1 << 20)}))
THRESHOLD_RUNS = 3  # per crossover arm and workload


def _arm_cache(label: str, name: str) -> Path:
    """A fresh copy of phase 5's prep cache for one arm on one workload."""
    tag = "".join(c if c.isalnum() else "_" for c in label)
    cache = SMOKE_DIR / f"threshold-prep-{tag}-{name}"
    shutil.rmtree(cache, ignore_errors=True)
    shutil.copytree(PREP_CACHE, cache)
    return cache


def threshold_run(name: str, label: str, extra: dict, cache: Path,
                  card: str) -> dict:
    """One harness run of an arm (harness_run holds every line to the
    .result), printed with its kernel launches."""
    rec = harness_run(name, ROOT, cache, extra)
    if rec["launches"] is None:
        raise AssertionError(f"thresholds [{name} {label}]: no kernel "
                             f"launches line")
    launches = " ".join(f"{k} {v}" for k, v in rec["launches"].items())
    print(f"thresholds [{name} {label}] {rec['queries']} queries exact; "
          f"launches {launches}; timed phase {rec['ms']} ms; whole harness "
          f"run {rec['wall']:.3f} s; {rec['engine']}; served by tier "
          f"{rec['tiers']} ({card})", flush=True)
    return rec


def threshold_edges(card: str, workloads=THRESHOLD_EDGE_WORKLOADS) -> dict:
    """The edge arms on `workloads`: {(arm, workload): K1 launches}.
    Every query must be served by the engine, none by the warm-up tier."""
    k1 = {}
    for name in workloads:
        for label, env in THRESHOLD_EDGE:
            rec = threshold_run(name, label, dict(env, S18_WARMUP_ORACLE="0"),
                                _arm_cache(label, name), card)
            if rec["tiers"]["warmup_host"]:
                raise AssertionError(f"thresholds [{name} {label}]: the "
                                     f"warm-up tier answered")
            k1[label, name] = rec["launches"]["K1"]
    return k1


def check_edge_launches(k1: dict) -> None:
    """K1 launched on every workload of the 0/0 arm and on none of the
    2^62/2^62 arm's."""
    for (label, name), n in k1.items():
        if label == THRESHOLD_EDGE[0][0] and n <= 0:
            raise AssertionError(f"thresholds [{name} {label}]: K1 never "
                                 f"launched")
        if label == THRESHOLD_EDGE[1][0] and n:
            raise AssertionError(f"thresholds [{name} {label}]: K1 "
                                 f"launched {n} times")


def threshold_crossovers(card: str, workloads=K1_WORKLOADS,
                         runs: int = THRESHOLD_RUNS) -> dict:
    """The crossover arms, `runs` each in turns per workload (A B B A ..):
    {workload: {arm: [timed ms in run order]}}.  Prints each arm's median
    and launches and the pairs each arm won (pair i: the i-th run of
    each); this moves no default."""
    from sigmod2018_tpu_torch.tools.cold_start import turns

    out = {}
    for name in workloads:
        caches = [_arm_cache(label, name) for label, _ in THRESHOLD_CROSSOVER]
        recs = {label: [] for label, _ in THRESHOLD_CROSSOVER}
        for i in turns(runs):
            label, env = THRESHOLD_CROSSOVER[i]
            recs[label].append(threshold_run(name, label, env, caches[i],
                                             card))
        for label, rs in recs.items():
            launches = {k: [r["launches"][k] for r in rs]
                        for k in rs[0]["launches"]}
            print(f"thresholds median [{name} {label}] of {len(rs)} runs: "
                  f"timed phase {statistics.median(r['ms'] for r in rs)} ms "
                  f"({[r['ms'] for r in rs]}); launches per run {launches} "
                  f"({card})", flush=True)
        ms = [[r["ms"] for r in rs] for rs in recs.values()]
        won = [sum(a < b for a, b in zip(ms[0], ms[1])),
               sum(b < a for a, b in zip(ms[0], ms[1]))]
        print(f"thresholds pairs [{name}]: "
              + ", ".join(f"{label} won {w}" for (label, _), w
                          in zip(THRESHOLD_CROSSOVER, won))
              + f", ties {runs - sum(won)} ({card})", flush=True)
        out[name] = dict(zip(recs, ms))
    return out


def phase_thresholds(card: str) -> None:
    """Phase 11 (see THRESHOLD_EDGE): the edge arms, held to their K1
    launches, then the crossover arms."""
    t0 = time.perf_counter()
    check_edge_launches(threshold_edges(card))
    threshold_crossovers(card)
    print(f"phase 11 (thresholds): {time.perf_counter() - t0:.1f} s "
          f"({card})", flush=True)


# Phase 12: each cell of BENCHMARK.json once, in its own process, as
# `python -m sigmod2018_tpu_torch.tools.bench CELL` runs it
BENCH_PASSES = 3
BENCH_TIMEOUT_S = 300  # per cell; the bench's own deadline ends it first


def bench_run(target: str, passes: int = BENCH_PASSES,
              extra=()) -> tuple:
    """One bench process: (its stdout lines, its last line parsed).  It
    must exit 0, so with every pass's lines exact."""
    cmd = [sys.executable, "-m", "sigmod2018_tpu_torch.tools.bench", target,
           "--passes", str(passes), *extra]
    env = dict(os.environ, S18_BENCH_DEADLINE=str(BENCH_TIMEOUT_S - 30))
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=BENCH_TIMEOUT_S)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"bench {target}: rc {proc.returncode}\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return lines, json.loads(lines[-1])


def check_bench(cell: str, lines: list, rec: dict, kind: str) -> None:
    """A bench run names the card `kind` on its device line, matched
    every line, launched each kernel as often in every timed pass, and on
    the card launched K1 in every pass and kept the device busy for part
    of its traced pass."""
    if kind not in lines[0]:
        raise AssertionError(f"bench [{cell}]: device line {lines[0]!r} "
                             f"does not name {kind!r}")
    if rec["mismatches"]:
        raise AssertionError(f"bench [{cell}]: {rec['mismatches']} "
                             f"mismatches")
    diag = rec["diag"]
    for name, per_pass in diag["launches"].items():
        if per_pass != [per_pass[0]] * rec["passes"]:
            raise AssertionError(f"bench [{cell}]: {name} launches per "
                                 f"pass {per_pass}")
    if diag["platform"] != "cuda":
        return
    if diag["launches"]["K1"][0] <= 0:
        raise AssertionError(f"bench [{cell}]: K1 never launched")
    share = diag["traced"]["device_busy_share"]
    if not (isinstance(share, float) and share > 0):
        raise AssertionError(f"bench [{cell}]: the traced pass's device "
                             f"busy share is {share!r}")


def phase_bench(card: str) -> None:
    """Phase 12: every cell of BENCHMARK.json (see BENCH_PASSES)."""
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in (c["name"] for c in spec["workloads"]):
        lines, rec = bench_run(cell)
        check_bench(cell, lines, rec, kind)
        diag = rec["diag"]
        print(f"bench [{cell}] {rec['passes']} timed passes, 0 mismatches; "
              f"mean {rec['timed_pass_ms']:.3f} ms (passes "
              f"{[round(ms, 3) for ms in diag['pass_ms']]}, dispatch "
              f"{[round(ms, 3) for ms in diag['dispatch_ms']]}, fetch "
              f"{[round(ms, 3) for ms in diag['fetch_ms']]}); prep "
              f"{rec['prep_ms']:.1f} ms; launches per pass "
              f"{ {k: v[0] for k, v in diag['launches'].items()} }; host "
              f"syncs {diag['host_syncs']}; traced pass device busy share "
              f"{diag['traced']['device_busy_share']}; data written in "
              f"{diag['generate_s']:.1f} s, expected lines in "
              f"{diag['reference_s']:.1f} s ({card})", flush=True)
    print(f"phase 12 (bench): {time.perf_counter() - t0:.1f} s ({card})",
          flush=True)


def _check_path(name: str, label: str, counts: dict, table_joins) -> None:
    """The kernels of the path ran, and the forced member's kernel branch
    served at least one join.  `label` is the fused-join member."""
    if label == "auto":
        if name in K1_WORKLOADS and counts["K1"] <= 0:
            raise AssertionError(f"{name}: K1 never launched under auto")
        return
    if counts["K4"] <= 0 or counts["K5"] <= 0:
        raise AssertionError(f"{name} under {label}: K4/K5 launches "
                             f"{counts['K4']}/{counts['K5']}")
    if counts[f"{label} branches"]["kernel"] <= 0:
        raise AssertionError(f"{name} under {label}: the kernel branch "
                             f"served no join")
    if name == "big" and label == "qd" and not table_joins:
        raise AssertionError("big under qd: no fused join had a key-table "
                             "build side, so the prefs_mode repair went "
                             "unexercised")


def _check_tiers(name: str, label: str, tiers: dict, queries: int) -> None:
    """Every query was counted under one tier, and under auto the tiers
    that the workload exists to exercise served."""
    if sum(tiers.values()) != queries:
        raise AssertionError(f"{name} under {label}: tier counts {tiers} "
                             f"do not add up to {queries} queries")
    need = REQUIRED_TIERS.get(name, ()) if label == "auto" else ()
    if need and not any(tiers[t] > 0 for t in need):
        raise AssertionError(f"{name}: no query served by {' or '.join(need)}"
                             f": {tiers}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from sigmod2018_tpu_torch.ops import _kernels

    card = card_line()
    dev = torch.device("cuda", 0)
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), python "
          f"{sys.version.split()[0]}", flush=True)

    from concurrent.futures import ThreadPoolExecutor

    from sigmod2018_tpu_torch.storage import native

    def build_native() -> float:
        native.library_path().unlink(missing_ok=True)  # time a real build
        t0 = time.perf_counter()
        native.load()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=1) as pool:
        native_build = pool.submit(build_native)
        builds = _kernels.load_all(KERNEL_SOURCES)
        native_s = native_build.result()
    print(f"build native loader: {native_s:.2f} s (g++, with the nvcc "
          f"builds) -> {native.library_path().relative_to(ROOT)}")
    for name, seconds in builds.items():
        lib = _kernels.library_path(name)
        print(f"build {name}: {seconds:.2f} s (builds started together) "
              f"-> {lib.relative_to(ROOT)}")
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip(), flush=True)

    flush = flush_buffer(dev)  # 64 MB
    k1_err, k1_times = phase_kernel(dev, card, flush)
    radix_kernels = phase_radix_kernels(dev, card, flush)
    phase_emit(dev, card, flush)
    prepared = generate_workloads()
    message_ms = phase_message(dev, card, flush)
    shutil.rmtree(PREP_CACHE, ignore_errors=True)
    PREP_CACHE.mkdir(parents=True)
    os.environ["S18_PREP_CACHE"] = str(PREP_CACHE)
    totals, k1_per_run, phases = phase_end_to_end(dev, card, prepared)
    sync_free = phase_sync_free(card)
    print_phases(phases, card)
    phase_prep_stats(card)
    phase_harness(card, phases)
    fresh_process_steps(card)
    phase_trace(card, sync_free["pick"])
    mesh_k1, mesh_times = phase_mesh(card, phases)
    phase_tools(card)
    mp_k1 = phase_multiprocess(card, phases, mesh_times)
    phase_thresholds(card)
    phase_bench(card)

    k1_main, k1_big = k1_times[K1_MAIN_CASE], k1_times[K1_BIG_BUILD_CASE]
    k4_err, k4_times = radix_kernels["slot_fill"]
    k5_err, k5_times = radix_kernels["probe_counts"]
    forced = {k: totals["compiled radix"][k] + totals["compiled qd"][k]
              for k in ("K1", "K4", "K5")}

    def timed(t):  # (kernel, plain, library, bound) ms of one case
        return dict(ms=t[0], plain_ms=t[1], library_ms=t[2], bound_ms=t[3],
                    bound_by="bytes", bound_share=t[3] / t[0])

    # `launches`: the path that runs the kernel (the compiled engine under
    # auto for K1, the forced members for K4 and K5);
    # `main_path_launches`: the compiled engine's under auto
    main = totals[MAIN_PATH]
    stair = dict(route="cuda",
                 source="sigmod2018_tpu_torch/csrc/stair_counts.cu",
                 launches=main["K1"], main_path_launches=main["K1"],
                 main_path_launches_per_run=k1_per_run[MAIN_PATH],
                 operator_engine_launches_per_run=k1_per_run["operator auto"],
                 forced_launches=forced["K1"], max_abs_err=k1_err,
                 mesh_path_launches=sum(mesh_k1.values()),
                 mesh_path_launches_per_run=mesh_k1,
                 multiprocess_path_launches=sum(mp_k1.values()),
                 multiprocess_path_launches_per_run=mp_k1)
    rows = [
        dict(name="stair_counts", replaces="sigmod2018_tpu/ops/ms_join.py:123",
             **timed(k1_main), **stair),
        dict(name="stair_counts serving K2's contract (rolled layout)",
             replaces="sigmod2018_tpu/ops/ms_join.py:233", **timed(k1_big),
             **stair),
        dict(name="stair_counts serving K3's contract (natural layout)",
             replaces="sigmod2018_tpu/ops/ms_join.py:336", **timed(k1_big),
             **stair),
        dict(name="slot_fill", route="cuda",
             source="sigmod2018_tpu_torch/csrc/slot_fill.cu",
             replaces="sigmod2018_tpu/ops/radix_join.py:218",
             launches=forced["K4"], main_path_launches=main["K4"],
             forced_launches=forced["K4"], max_abs_err=k4_err,
             **timed(k4_times["radix 2^21 build"])),
        dict(name="probe_counts", route="cuda",
             source="sigmod2018_tpu_torch/csrc/probe_counts.cu",
             replaces="sigmod2018_tpu/ops/radix_join.py:282",
             launches=forced["K5"], main_path_launches=main["K5"],
             forced_launches=forced["K5"], max_abs_err=k5_err,
             **timed(k5_times["radix 2^21"])),
    ]
    print(f"factorized message at 2^21 rows: gather form "
          f"{message_ms['gather']:.4f} ms, sort form "
          f"{message_ms['sort']:.4f} ms; a query of it: host dispatch "
          f"{message_ms['query_host']:.4f} ms, on the card "
          f"{message_ms['query_card']:.4f} ms ({card})")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
