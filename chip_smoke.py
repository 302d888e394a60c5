#!/usr/bin/env python3
"""Smoke test of the torch port (`sigmod2018_tpu_torch`) on one NVIDIA GPU.

Phases, each of which must pass:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions;
2. build: csrc/stair_counts.cu, csrc/slot_fill.cu and
   csrc/probe_counts.cu, one nvcc each, all started together, timed,
   with ptxas's report;
3. kernels vs plain, on the card, each with the median time of kernel
   and plain twin (CUDA events, L2 flushed before every run):
   - K1 `ops.ms_join.staircase_counts` against `staircase_counts_plain`
     at the serving path's shapes, cnt exactly and lo where cnt > 0
     (its 2^24-row build is the size where the TPU needed the rolled
     kernels K2/K3, whose contract K1 serves);
   - K4 `ops.radix_join.slot_fill` against `slot_fill_plain`, the whole
     [K, B, SP] matrix exactly, at the radix member's and the
     equi-depth member's 2^21 shapes;
   - K5 `ops.radix_join.probe_counts` against `probe_counts_plain`, mc
     and pc exactly, at those shapes, a window of MAX_SLOTS keys, keys
     over the full u64 range with live 2^64-1 keys, and empty windows;
4. end to end: the relation binaries of workloads/big and
   workloads/bigdom are regenerated from their seeds
   (sigmod2018_tpu_torch.tools.workload, parameters of
   tools/regen_workloads.sh), `init + Done + .work` goes through the
   port's `run_protocol` on the card under the auto member choice (twice)
   and with the radix and the equi-depth members forced (once each).
   Every output line must equal the committed .result; under auto K1
   launches, under radix and qd K4 and K5 launch and the members' kernel
   branch serves at least one join per workload.  Every kernel count is
   set to 0 just before each run and read just after it.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Any failure exits non-zero before either
is printed, as does a machine without a CUDA device.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import io
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SMOKE_DIR = ROOT / "build" / "smoke"
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
}


def card_line() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is not None:
        proc = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        if proc.returncode == 0 and proc.stdout.strip():
            return proc.stdout.strip().splitlines()[0]
    return (f"{torch.cuda.get_device_name(0)}, power limit not read "
            f"(nvidia-smi unavailable)")


def median_ms(fn, flush: torch.Tensor, reps: int = 15) -> float:
    """Median device time of fn() by CUDA events, L2 flushed before each
    run (a 64 MB write evicts the card's 50 MB L2)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    ms)})."""
    from sigmod2018_tpu_torch.ops import ms_join

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
        times[name] = (k_ms, p_ms)
        print(f"K1 kernel-vs-plain [{name}] Pb={kb.shape[0]} "
              f"Pp={kp.shape[0]} n_b={int(n_b)} n_p={int(n_p)} "
              f"matches={int(cnt_p.sum())}: cnt/lo exact; kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms (median, {card})",
              flush=True)
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


def phase_radix_kernels(dev, card: str, flush: torch.Tensor):
    """K4 and K5 against their plain twins at the forced members' 2^21
    shapes: {kernel: (max_abs_err, {case: (kernel ms, plain ms)})}."""
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
        out["slot_fill"][1][name] = (k_ms, p_ms)
        print(f"K4 kernel-vs-plain [{name}] K={len(srcs)} "
              f"B={st.shape[0]} SP={SP} live={int(ct.sum())}: whole "
              f"matrix exact; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"(median, {card})", flush=True)
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
        out["probe_counts"][1][name] = (k_ms, p_ms)
        print(f"K5 kernel-vs-plain [{name}] B={kb.shape[0]} "
              f"Sb={kb.shape[1]} Sp={kp.shape[1]} matches={int(mc.sum())}: "
              f"mc/pc exact; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"(median, {card})", flush=True)

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
    del mb, mp

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


# (label, fused-join member, runs per workload)
PATHS = [("auto", "auto", RUNS_PER_WORKLOAD), ("radix", "radix", 1),
         ("qd", "qd", 1)]


def phase_end_to_end(dev, card: str) -> dict:
    """Every workload under every path: {path: summed kernel counts}."""
    import sigmod2018_tpu_torch.ops as ops
    from sigmod2018_tpu_torch.config import EngineConfig
    from sigmod2018_tpu_torch.io.repl import run_protocol
    from sigmod2018_tpu_torch.tools.workload import write_relations

    prepared = {}
    for name, params in WORKLOADS.items():
        t0 = time.perf_counter()
        write_relations(SMOKE_DIR / name, **params)
        prepared[name] = time.perf_counter() - t0

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
    totals = {}
    try:
        for label, algo, runs in PATHS:
            config = EngineConfig(platform="cuda", join_algo=algo)
            total = {"K1": 0, "K4": 0, "K5": 0}
            for name in WORKLOADS:
                src = ROOT / "workloads" / name
                init = [str(SMOKE_DIR / name / r)
                        for r in (src / f"{name}.init").read_text().split()]
                work = (src / f"{name}.work").read_text().splitlines()
                want = (src / f"{name}.result").read_text().splitlines()
                for run in range(1, runs + 1):
                    feed = _Feed(init + ["Done"] + work, len(init) + 1)
                    out = io.StringIO()
                    del table_joins[:]
                    torch.cuda.reset_peak_memory_stats(dev)
                    _reset_counts()  # count this run's launches only
                    t0 = time.perf_counter()
                    run_protocol(feed, out, config)
                    t1 = time.perf_counter()
                    counts = _read_counts()
                    got = out.getvalue().splitlines()
                    ok = sum(g == w for g, w in zip(got, want))
                    if len(got) != len(want) or ok != len(want):
                        raise AssertionError(
                            f"{name} under {label} run {run}: {ok}/"
                            f"{len(want)} lines equal the .result "
                            f"({len(got)} lines out)\n got: {got}\nwant: "
                            f"{want}")
                    _check_path(name, label, counts, table_joins)
                    for k in total:
                        total[k] += counts[k]
                    print(f"end-to-end [{name} {label} run {run}] {ok}/"
                          f"{len(want)} lines equal {name}.result; "
                          f"launches K1 {counts['K1']} K4 {counts['K4']} "
                          f"K5 {counts['K5']}; radix branches "
                          f"{counts['radix branches']}, qd branches "
                          f"{counts['qd branches']}; fused joins with a "
                          f"key-table build side {len(table_joins)}; "
                          f"relations generated in {prepared[name]:.3f} s; "
                          f"prep {feed.t_serving - t0:.3f} s; timed phase "
                          f"{t1 - feed.t_serving:.3f} s; peak device "
                          f"memory "
                          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
                          f" GiB ({card})", flush=True)
            totals[label] = total
    finally:
        ops.fused_join_auto = real_fused
    return totals


def _check_path(name: str, label: str, counts: dict, table_joins) -> None:
    """The kernels of the path ran, and the forced member's kernel branch
    served at least one join."""
    if label == "auto":
        if counts["K1"] <= 0:
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

    builds = _kernels.load_all(KERNEL_SOURCES)
    for name, seconds in builds.items():
        lib = _kernels.library_path(name)
        print(f"build {name}: {seconds:.2f} s (builds started together) "
              f"-> {lib.relative_to(ROOT)}")
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip(), flush=True)

    flush = torch.empty(1 << 26, dtype=torch.uint8, device=dev)
    k1_err, k1_times = phase_kernel(dev, card, flush)
    radix_kernels = phase_radix_kernels(dev, card, flush)
    totals = phase_end_to_end(dev, card)

    k1_main, k1_big = k1_times[K1_MAIN_CASE], k1_times[K1_BIG_BUILD_CASE]
    k4_err, k4_times = radix_kernels["slot_fill"]
    k5_err, k5_times = radix_kernels["probe_counts"]
    forced = {k: totals["radix"][k] + totals["qd"][k] for k in ("K4", "K5")}
    stair = dict(route="cuda",
                 source="sigmod2018_tpu_torch/csrc/stair_counts.cu",
                 launches=totals["auto"]["K1"], max_abs_err=k1_err)
    rows = [
        dict(name="stair_counts", replaces="sigmod2018_tpu/ops/ms_join.py:123",
             ms=k1_main[0], plain_ms=k1_main[1], **stair),
        dict(name="stair_counts serving K2's contract (rolled layout)",
             replaces="sigmod2018_tpu/ops/ms_join.py:233",
             ms=k1_big[0], plain_ms=k1_big[1], **stair),
        dict(name="stair_counts serving K3's contract (natural layout)",
             replaces="sigmod2018_tpu/ops/ms_join.py:336",
             ms=k1_big[0], plain_ms=k1_big[1], **stair),
        dict(name="slot_fill", route="cuda",
             source="sigmod2018_tpu_torch/csrc/slot_fill.cu",
             replaces="sigmod2018_tpu/ops/radix_join.py:218",
             launches=forced["K4"], max_abs_err=k4_err,
             ms=k4_times["radix 2^21 build"][0],
             plain_ms=k4_times["radix 2^21 build"][1]),
        dict(name="probe_counts", route="cuda",
             source="sigmod2018_tpu_torch/csrc/probe_counts.cu",
             replaces="sigmod2018_tpu/ops/radix_join.py:282",
             launches=forced["K5"], max_abs_err=k5_err,
             ms=k5_times["radix 2^21"][0],
             plain_ms=k5_times["radix 2^21"][1]),
    ]
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
