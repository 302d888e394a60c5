"""Per-op tracing of the operator engine (S18_TRACE).

Counterpart of `sigmod2018_tpu/engine/trace.py`.  With
`EngineConfig.trace` on, `TorchEngine` calls its ops through `TimedOps`,
which times every call that returns a tensor, and each materializing
dispatch reports its query on stderr: op name, input shapes, time,
bytes touched (inputs and outputs) and, for the join family, the floor
of `utils/floors.py`.

Timing follows the engine's device:

- on the card, a pair of `torch.cuda.Event(enable_timing=True)` recorded
  on the current stream around the call; the report synchronizes once.
  An event pair spans the card's time from the op's first launch to its
  last, so an op that reads a value to the host inside (a forced radix
  or qd join's branch) includes the card's wait for that read, and with
  several batch threads (S18_WORKERS) it includes other queries'
  launches queued between its two events: for per-op times serve with
  one thread;
- on the CPU, the host clock around the call, since CPU ops run
  synchronously.

Records are kept per thread: io/repl.py dispatches a batch from
several threads, and a query's report holds only its own ops.

`S18_TRACE=json` prints one JSON object per query instead of the table:
{"query", "device", "ops": [{"op", "shapes", "device_ms", "bytes",
"hbm_frac", "floor_ms", "floor_frac"}]}; the shares against the H100's
memory rate are null on the CPU.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, List, Optional, Tuple

import torch

from ..utils.floors import HBM_BYTES_PER_S, floors_for_op


def _nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(v) for v in x)
    return 0


def _has_tensor(x: Any) -> bool:
    if isinstance(x, torch.Tensor):
        return True
    return isinstance(x, (tuple, list)) and any(_has_tensor(v) for v in x)


class Tracer:
    """Per-thread op records of the query being dispatched, and their
    report."""

    def __init__(self, device: torch.device, out=None, mode: str = "table"):
        self.device = torch.device(device)
        self.out = out  # None: sys.stderr at report time
        self.mode = mode
        self._local = threading.local()

    @property
    def records(self) -> List[Tuple[str, str, Any, int, Optional[dict]]]:
        """(op, shapes, timing, bytes, floors) of this thread's query."""
        if not hasattr(self._local, "records"):
            self._local.records = []
        return self._local.records

    def reset(self) -> None:
        self._local.records = []

    def start(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def record(self, name: str, args, result, start) -> None:
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            timing = (start, end)
        else:
            timing = (time.perf_counter() - start) * 1e3
        shapes = ",".join(str(tuple(a.shape)) for a in args
                          if isinstance(a, torch.Tensor))
        self.records.append((name, shapes, timing,
                             _nbytes(args) + _nbytes(result),
                             floors_for_op(name, args)))

    def _timed_records(self):
        """(op, shapes, ms, bytes, floors); one sync on the card."""
        recs = self.records
        if self.device.type == "cuda" and recs:
            recs[-1][2][1].synchronize()
        return [(name, shapes,
                 t if isinstance(t, float) else t[0].elapsed_time(t[1]),
                 nbytes, fl)
                for name, shapes, t, nbytes, fl in recs]

    def report(self, label: str = "") -> None:
        recs = self._timed_records()
        on_card = self.device.type == "cuda"

        def share(ms: float, floor_ms: float) -> Optional[float]:
            return round(floor_ms / ms, 4) if on_card and ms > 0 else None

        if self.mode == "json":
            text = json.dumps({
                "query": label,
                "device": str(self.device),
                "ops": [
                    {"op": name, "shapes": shapes,
                     "device_ms": round(ms, 4), "bytes": nbytes,
                     "hbm_frac": share(ms, nbytes / HBM_BYTES_PER_S * 1e3),
                     **({"floor_ms": round(fl["floor_ms"], 4),
                         "floor_frac": share(ms, fl["floor_ms"])}
                        if fl else {})}
                    for name, shapes, ms, nbytes, fl in recs]})
        else:
            total = sum(ms for _, _, ms, _, _ in recs)
            lines = [f"-- trace {label}: {total:.2f} ms device total "
                     f"({self.device})"]
            for name, shapes, ms, nbytes, fl in recs:
                sol = nbytes / HBM_BYTES_PER_S * 1e3  # ms at the memory rate
                frac = (f" sol={sol / ms * 100:5.1f}%"
                        if on_card and ms > 0 and sol > 0 else "")
                if fl and on_card and ms > 0:
                    frac += (f" floor={fl['floor_ms']:.2f}ms"
                             f" ({fl['floor_ms'] / ms * 100:.0f}% of SOL)")
                lines.append(f"--   {name:22s} {ms:8.3f} ms  [{shapes}]{frac}")
            text = "\n".join(lines)
        # one write per report: batch threads report concurrently
        (self.out or sys.stderr).write(text + "\n")


class TimedOps:
    """Proxy over the ops module that times every call returning a tensor
    (an op that returns none, such as a member choice, is not recorded)."""

    def __init__(self, ops_module, tracer: Tracer):
        self._ops = ops_module
        self._tracer = tracer

    def __getattr__(self, name: str):
        fn = getattr(self._ops, name)
        if not callable(fn):
            return fn

        def timed(*args, **kwargs):
            start = self._tracer.start()
            result = fn(*args, **kwargs)
            if _has_tensor(result):
                self._tracer.record(name, args, result, start)
            return result

        return timed
