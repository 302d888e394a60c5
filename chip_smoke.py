#!/usr/bin/env python3
"""Smoke test of the torch port (`sigmod2018_tpu_torch`) on one NVIDIA GPU.

Phases, each of which must pass:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions;
2. build: csrc/stair_counts.cu with nvcc, timed, with ptxas's report;
3. kernel vs plain: `ops.ms_join.staircase_counts` (the CUDA kernel)
   against `staircase_counts_plain` on the card at the serving path's
   shapes — cnt exactly, lo exactly where cnt > 0 — with the median
   time of each (CUDA events, L2 flushed before every run);
4. end to end: the relation binaries of workloads/big and
   workloads/bigdom are regenerated from their seeds
   (sigmod2018_tpu_torch.tools.workload, parameters of
   tools/regen_workloads.sh), `init + Done + .work` goes through the
   port's `run_protocol` on the card, and every output line must equal
   the committed .result while the kernel's launch count grows.

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


def phase_kernel(dev, card: str):
    from sigmod2018_tpu_torch.ops import ms_join

    flush = torch.empty(1 << 26, dtype=torch.uint8, device=dev)
    before = ms_join.LAUNCHES
    max_err = 0
    main_ms = main_plain_ms = None
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
        if main_ms is None:
            main_ms, main_plain_ms = k_ms, p_ms
        print(f"kernel-vs-plain [{name}] Pb={kb.shape[0]} Pp={kp.shape[0]} "
              f"n_b={int(n_b)} n_p={int(n_p)} matches={int(cnt_p.sum())}: "
              f"cnt/lo exact; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"(median, {card})", flush=True)
    if ms_join.LAUNCHES <= before:
        raise AssertionError("the kernel's launch count did not grow")
    return max_err, main_ms, main_plain_ms


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


def phase_end_to_end(dev, card: str) -> int:
    from sigmod2018_tpu_torch.config import EngineConfig
    from sigmod2018_tpu_torch.io.repl import run_protocol
    from sigmod2018_tpu_torch.ops import ms_join
    from sigmod2018_tpu_torch.tools.workload import write_relations

    prepared = {}
    for name, params in WORKLOADS.items():
        t0 = time.perf_counter()
        write_relations(SMOKE_DIR / name, **params)
        prepared[name] = time.perf_counter() - t0

    config = EngineConfig(platform="cuda")
    ms_join.LAUNCHES = 0  # count the main path's launches only
    for name in WORKLOADS:
        src = ROOT / "workloads" / name
        init = [str(SMOKE_DIR / name / r)
                for r in (src / f"{name}.init").read_text().split()]
        work = (src / f"{name}.work").read_text().splitlines()
        want = (src / f"{name}.result").read_text().splitlines()
        for run in range(1, RUNS_PER_WORKLOAD + 1):
            feed = _Feed(init + ["Done"] + work, len(init) + 1)
            out = io.StringIO()
            launches = ms_join.LAUNCHES
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            run_protocol(feed, out, config)
            t1 = time.perf_counter()
            got = out.getvalue().splitlines()
            ok = sum(g == w for g, w in zip(got, want))
            if len(got) != len(want) or ok != len(want):
                raise AssertionError(
                    f"{name} run {run}: {ok}/{len(want)} lines equal the "
                    f".result ({len(got)} lines out)\n got: {got}\nwant: "
                    f"{want}")
            grew = ms_join.LAUNCHES - launches
            if grew <= 0:
                raise AssertionError(f"{name}: the kernel never launched")
            print(f"end-to-end [{name} run {run}] {ok}/{len(want)} lines "
                  f"equal {name}.result; kernel launches {grew}; relations "
                  f"generated in {prepared[name]:.3f} s; prep "
                  f"{feed.t_serving - t0:.3f} s; timed phase "
                  f"{t1 - feed.t_serving:.3f} s; peak device memory "
                  f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
                  f"({card})", flush=True)
    return ms_join.LAUNCHES


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

    t0 = time.perf_counter()
    _kernels.load("stair_counts")
    print(f"build stair_counts: {time.perf_counter() - t0:.2f} s "
          f"-> {_kernels.library_path('stair_counts').relative_to(ROOT)}")
    log = _kernels.library_path("stair_counts").with_suffix(".log")
    if log.exists():
        print(log.read_text().strip(), flush=True)

    max_err, k_ms, p_ms = phase_kernel(dev, card)
    launches = phase_end_to_end(dev, card)

    print(json.dumps({"kernels": [{
        "name": "stair_counts", "route": "cuda",
        "source": "sigmod2018_tpu_torch/csrc/stair_counts.cu",
        "replaces": "sigmod2018_tpu/ops/ms_join.py:123",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
