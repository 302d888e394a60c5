"""The operator and the compiled engine on the repo's workloads, in turns,
with the caching allocator's view of each run's timed phase.

Run from the repository root on a machine with an NVIDIA GPU:

    python -m sigmod2018_tpu_torch.tools.engine_ab [--reps 5]
        [--workloads big,scaled] [--mesh 4] [--profile bigdom]
        [--out build/engine_ab/engine_ab.json]

It takes the workloads of `chip_smoke.py` (`WORKLOADS`, the relation
binaries under build/smoke/, written from their seeds when missing) and,
per workload, with the prep cache an emptied directory under
build/engine_ab/:

1. one teaching run of the compiled engine (it learns the size classes)
   and one untimed round of every variant;
2. `reps` rounds of the variants, the order turned by one each round:
   the operator engine and the compiled engine (learned classes), each
   with the default 8 batch threads and with 1.  Every run starts with
   the allocator's cache emptied, as in a fresh process, and reports
   prep and timed phase (host clock), the timed phase split into host
   dispatch and the batch fetch (`format_batch`: the wait for the card,
   plus any retry), the peak allocated and reserved bytes of the timed
   phase, and the device allocations (new allocator segments) made in
   it;
3. a repeated-text pass: the workload's queries once more on an engine
   that served them, `reps` times: the operator engine, then the
   compiled engine with its per-text fast path emptied first (planned)
   and from its fast path, in turns.

4. with --profile, one more run of each engine (8 batch threads) on
   the named workloads under `torch.profiler`: the device time of the
   timed phase in all and its largest operators.

With --mesh N the variants are the compiled engine on one device and
on a mesh of N shards (parallel/, S18_MESH=N), each at 8 and 1 batch
threads, and there is no repeated-text pass (the mesh engine has no
per-text fast path); --profile then profiles those two.

Each run's line equals the committed .result or the script fails.  It
prints one line per run and, per workload, the medians of each variant,
with the card's name and power limit, and writes every record to --out.
"""

from __future__ import annotations

import argparse
import gc
import io
import json
import os
import shutil
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
PLATFORM = "cuda"
# (label, compiled engine, batch threads, mesh shards)
VARIANTS = (("operator", False, 8, 1), ("compiled", True, 8, 1),
            ("operator w1", False, 1, 1), ("compiled w1", True, 1, 1))


def mesh_variants(n: int) -> tuple:
    return (("compiled", True, 8, 1), (f"compiled mesh{n}", True, 8, n),
            ("compiled w1", True, 1, 1), (f"compiled mesh{n} w1", True, 1, n))
REPEATED = ("operator", "compiled planned", "compiled fast path")
GIB = float(1 << 30)


def _segments(stats: dict) -> int:
    return stats.get("segment.all.allocated", 0)


class _Feed:
    """Protocol stdin from a list of lines.  When prep has finished (the
    first line after `Done` is asked for) it calls `on_serving`, notes
    the time, resets the allocator's peaks and keeps its counters."""

    def __init__(self, lines, n_prep: int, on_serving=None):
        self.lines, self.n_prep, self.i = lines, n_prep, 0
        self.on_serving = on_serving
        self.t_serving = None
        self.stats0: dict = {}

    def __iter__(self):
        return self

    def __next__(self) -> str:
        if self.i == self.n_prep and self.t_serving is None:
            if self.on_serving is not None:
                self.on_serving()
            torch.cuda.reset_peak_memory_stats()
            self.stats0 = torch.cuda.memory_stats()
            self.t_serving = time.perf_counter()
        if self.i >= len(self.lines):
            raise StopIteration
        self.i += 1
        return self.lines[self.i - 1] + "\n"


class _FetchClock:
    """Sums the time spent in the driver's batch fetch (format_batch)."""

    def __init__(self, executor_module):
        self.mod, self.real, self.seconds = (executor_module,
                                             executor_module.format_batch, 0.0)

    def __enter__(self):
        def timed(results):
            t0 = time.perf_counter()
            try:
                return self.real(results)
            finally:
                self.seconds += time.perf_counter() - t0

        self.mod.format_batch = timed
        return self

    def __exit__(self, *exc):
        self.mod.format_batch = self.real


def serve_once(name: str, compiled: bool, workers: int, files,
               on_serving=None, mesh: int = 1) -> tuple:
    """One protocol run of a workload: (record, engine)."""
    from sigmod2018_tpu_torch.config import EngineConfig
    from sigmod2018_tpu_torch.engine import executor
    from sigmod2018_tpu_torch.io.repl import serve

    init, work, want = files
    gc.collect()
    torch.cuda.empty_cache()
    feed = _Feed(init + ["Done"] + work, len(init) + 1, on_serving)
    out = io.StringIO()
    # prep before serving, so that _Feed's split is prep / timed phase
    config = EngineConfig(platform=PLATFORM, compile_queries=compiled,
                          batch_workers=workers, async_prep=False,
                          mesh_devices=mesh)
    t0 = time.perf_counter()
    with _FetchClock(executor) as clock:
        engine = serve(feed, out, config)
    t1 = time.perf_counter()
    stats = torch.cuda.memory_stats()
    if out.getvalue().splitlines() != want:
        raise AssertionError(f"{name}, {type(engine).__name__} with "
                             f"{workers} batch threads: lines differ from "
                             f"{name}.result")
    timed = t1 - feed.t_serving
    return dict(
        prep_s=feed.t_serving - t0, timed_s=timed,
        dispatch_s=timed - clock.seconds, fetch_s=clock.seconds,
        peak_allocated_gib=torch.cuda.max_memory_allocated() / GIB,
        peak_reserved_gib=torch.cuda.max_memory_reserved() / GIB,
        new_segments=_segments(stats) - _segments(feed.stats0),
        alloc_retries=(stats.get("num_alloc_retries", 0)
                       - feed.stats0.get("num_alloc_retries", 0)),
        counts=dict(engine.counts), tiers=dict(engine.tiers)), engine


def repeated_pass(engine, work, want, workers: int) -> float:
    """The workload's batches once more on an engine that served them:
    host seconds from the first dispatch to the last line."""
    from sigmod2018_tpu_torch.engine.executor import format_batch
    from sigmod2018_tpu_torch.frontend.parser import parse_query

    batches, batch = [], []
    for line in work:
        if line == "F":
            batches.append(batch)
            batch = []
        else:
            batch.append(parse_query(line))
    if batch:
        batches.append(batch)
    torch.cuda.synchronize()
    lines = []
    t0 = time.perf_counter()
    with ThreadPoolExecutor(workers) as pool:
        for b in batches:
            lines += format_batch(list(pool.map(engine.execute_async, b)))
    seconds = time.perf_counter() - t0
    if lines != want:
        raise AssertionError("repeated-text pass: lines differ from "
                             ".result")
    return seconds


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def profile_engines(name: str, files, card: str, mesh: int = 1) -> dict:
    """One run of each engine (the compiled one on one device and on the
    mesh with mesh > 1) under torch.profiler, timed phase only:
    {engine: (device ms in all, [(op, device ms, calls)] largest 12)}."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    engines = ((("operator", False, 1), ("compiled", True, 1)) if mesh == 1
               else (("compiled", True, 1), (f"compiled mesh{mesh}", True,
                                             mesh)))
    for label, compiled, shards in engines:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        try:
            rec = serve_once(name, compiled, 8, files, prof.start,
                             mesh=shards)[0]
        finally:
            torch.cuda.synchronize()
            prof.stop()
        events = [e for e in prof.key_averages() if _device_us(e) > 0]
        events.sort(key=_device_us, reverse=True)
        total = sum(_device_us(e) for e in events) / 1e3
        top = [(e.key, _device_us(e) / 1e3, e.count) for e in events[:12]]
        out[label] = dict(device_ms=total, timed_s=rec["timed_s"], top=top)
        print(f"engine_ab profile [{name} {label}] timed phase "
              f"{rec['timed_s']:.6f} s (profiled), device time "
              f"{total:.3f} ms; largest: " + "; ".join(
                  f"{k} {ms:.3f} ms ({n})" for k, ms, n in top)
              + f" ({card})", flush=True)
    return out


def run_workload(name: str, reps: int, card: str,
                 profiled: bool = False, mesh: int = 1) -> dict:
    import chip_smoke

    files = chip_smoke.workload_files(name)
    variants = VARIANTS if mesh == 1 else mesh_variants(mesh)
    records = {v[0]: [] for v in variants}
    for shards in sorted({v[3] for v in variants}):
        serve_once(name, True, 8, files, mesh=shards)  # teaches the classes
    for r in range(-1, reps):  # round -1 is untimed
        turn = r % len(variants)
        for label, compiled, workers, shards in (variants[turn:]
                                                 + variants[:turn]):
            # the engine goes at once: the next run's peaks hold one
            rec = serve_once(name, compiled, workers, files,
                             mesh=shards)[0]
            if r < 0:
                continue
            records[label].append(dict(rec, round=r))
            print(f"engine_ab [{name} {label} round {r}] " + " ".join(
                f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()), flush=True)
    summary = {label: {k: statistics.median(rec[k] for rec in recs)
                       for k in ("prep_s", "timed_s", "dispatch_s", "fetch_s",
                                 "peak_allocated_gib", "peak_reserved_gib",
                                 "new_segments")}
               for label, recs in records.items()}
    repeated = {}
    if mesh == 1:
        repeated = repeated_passes(name, files, reps)
        summary["repeated-text pass s"] = {
            label: statistics.median(secs)
            for label, secs in repeated.items()}
    print(f"engine_ab summary [{name}] medians of {reps} rounds ({card}): "
          f"{json.dumps(summary)}", flush=True)
    result = dict(runs=records, repeated=repeated, summary=summary)
    if profiled:
        result["profile"] = profile_engines(name, files, card, mesh)
    return result


def repeated_passes(name: str, files, reps: int) -> dict:
    """{variant: seconds of each repeated-text pass} (REPEATED)."""
    work, want = files[1], files[2]
    repeated = {label: [] for label in REPEATED}
    _, engine = serve_once(name, False, 8, files)
    for _ in range(reps):
        repeated["operator"].append(repeated_pass(engine, work, want, 8))
    del engine
    _, engine = serve_once(name, True, 8, files)
    for r in range(reps):
        for label in REPEATED[1:] if r % 2 else REPEATED[:0:-1]:
            if label == "compiled planned":
                engine._fastpath.clear()
            repeated[label].append(repeated_pass(engine, work, want, 8))
    return repeated


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--workloads", default="big,bigdom,zipfbig,scaled,zipf")
    ap.add_argument("--profile", default="",
                    help="workloads to profile once per engine, e.g. big")
    ap.add_argument("--mesh", type=int, default=1,
                    help="compare the compiled engine on one device with "
                         "it on a mesh of this many shards")
    ap.add_argument("--out", default=str(ROOT / "build" / "engine_ab"
                                         / "engine_ab.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("engine_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from sigmod2018_tpu_torch.tools.workload import write_relations
    from sigmod2018_tpu_torch.utils.timing import card_line

    card = card_line()
    print(card, flush=True)
    prep = ROOT / "build" / "engine_ab" / "prep"
    shutil.rmtree(prep, ignore_errors=True)
    prep.mkdir(parents=True)
    os.environ["S18_PREP_CACHE"] = str(prep)
    names = args.workloads.split(",")
    for name in names:
        if not (chip_smoke.SMOKE_DIR / name / "r0").exists():
            write_relations(chip_smoke.SMOKE_DIR / name,
                            **chip_smoke.WORKLOADS[name])
    result = {"card": card, "reps": args.reps, "mesh": args.mesh,
              "workloads": {n: run_workload(n, args.reps, card,
                                            n in args.profile.split(","),
                                            args.mesh)
                            for n in names}}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(f"engine_ab: records written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
