"""One timer for chip_smoke.py and the measuring tools (tools/microbench.py,
tools/roofline.py, tools/bench_probe.py).

On a CUDA device a call is timed by a pair of CUDA events, the card's L2
flushed before each run and the card kept busy while the host issues the
call's launches, so the events time the device work and not the host's
dispatch.  The wait lasts at least twice the host's issue time of one
call, measured before the timed runs.  The host's issue time of each run
is kept too: a call whose host issue takes as long as its device time
(or that waits on the card inside, which makes its host time hold the
device time) is host-bound, and its line says so.  On the CPU the host
clock (`time.perf_counter`) times the call, and `clock_note` says so:
such a number is never a device time.
"""

from __future__ import annotations

import shutil
import statistics
import subprocess
import time
from dataclasses import dataclass

import torch

REPS = 15  # timed runs of a call, after 3 untimed ones
SPIN_CYCLES = 400_000  # the least wait before a timed call, ~0.2 ms
# the H100's top SM clock in cycles per ms: a wait of this many cycles per
# ms lasts at least that long at any clock the card runs
SPIN_CYCLES_PER_MS = 1_980_000
FLUSH_BYTES = 64 << 20  # past the H100's 50 MB L2


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = shutil.which("nvidia-smi")
    if smi is not None:
        proc = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        if proc.returncode == 0 and proc.stdout.strip():
            return proc.stdout.strip().splitlines()[0]
    return (f"{torch.cuda.get_device_name(0)}, power limit not read "
            f"(nvidia-smi unavailable)")


def clock_note(device: torch.device) -> str:
    """What a time taken on `device` is, for the line that prints it."""
    if device.type == "cuda":
        return f"CUDA events, L2 flushed; {card_line()}"
    return "host clock (time.perf_counter) on the CPU, not a device time"


def flush_buffer(device: torch.device) -> torch.Tensor:
    """The tensor median_ms reads before each run: 64 MB on a card, a
    token on the CPU (no cache of the card to flush)."""
    n = FLUSH_BYTES // 8 if device.type == "cuda" else 1
    return torch.ones(n, dtype=torch.int64, device=device)


@dataclass
class Timing:
    """A call's median device time (`ms`; the host clock's on the CPU)
    and its median host issue time (`host_ms`)."""
    ms: float
    host_ms: float
    on_card: bool

    @property
    def host_bound(self) -> bool:
        """On a card: the host takes as long to issue the call as the card
        takes to run it, so back to back the card would wait on the host."""
        return self.on_card and self.host_ms >= self.ms

    def tag(self) -> str:
        """What a tool's line adds after the time: the host issue time on
        a card, and whether the call is host-bound."""
        if not self.on_card:
            return ""
        bound = ", host-bound" if self.host_bound else ""
        return f" [host issue {self.host_ms:.4f} ms{bound}]"


def spin_cycles(host_ms: float) -> int:
    """The wait before a timed call: twice the host's issue time of one
    call, and never less than SPIN_CYCLES."""
    return max(SPIN_CYCLES, int(2 * host_ms * SPIN_CYCLES_PER_MS) + 1)


def time_call(fn, flush: torch.Tensor, reps: int = REPS) -> Timing:
    """Median times of fn() over `reps` runs after 3 untimed ones.

    On a card: CUDA events, L2 flushed before each run: a 64 MB read
    evicts the card's 50 MB L2 and leaves it clean (a write would leave
    dirty lines whose write-back the timed call pays).  The card then
    spins for spin_cycles(the last untimed run's host issue time), so
    the host has issued every launch before the card reaches them.  On
    the CPU (`flush` on the CPU): the host clock around each run."""
    on_card = flush.device.type == "cuda"
    host_ms = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        if on_card:
            torch.cuda.synchronize()
    times, host_times = [], []
    if not on_card:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        return Timing(ms, ms, False)
    spin = spin_cycles(host_ms)
    for _ in range(reps):
        flush.sum()
        # keep the card busy while the host prepares fn's launches, so the
        # events time the device work and not the host's dispatch
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host_times.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return Timing(statistics.median(times), statistics.median(host_times),
                  True)


def median_ms(fn, flush: torch.Tensor, reps: int = REPS) -> float:
    """time_call(fn, flush, reps).ms: the median device time on a card,
    the host clock's on the CPU."""
    return time_call(fn, flush, reps).ms


def tool_device(platform: str) -> torch.device:
    """The device a tool measures on: "cuda" (the default; raises without
    a usable card, nothing falls back to the CPU) or "cpu"."""
    from ..config import EngineConfig

    return EngineConfig(platform=platform).device()
