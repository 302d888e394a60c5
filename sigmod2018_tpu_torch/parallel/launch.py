"""Start the ranks of a process group and wait for all of them.

`run_ranks` starts `world` copies of one command on this host, rank p
with S18_COORD_ADDR=127.0.0.1:<a free port>, S18_NUM_PROCS=world and
S18_PROC_ID=p added to its environment (parallel/multihost.py's
contract) and the same text on its stdin.  A rank that fails leaves the
others waiting in a collective until the group's timeout, so the first
rank to exit nonzero, or the deadline, ends every rank still running,
and `RanksFailed` names each rank's exit code and the ends of its
output.  Used by chip_smoke.py's multi-process phase and by the tests.
"""

from __future__ import annotations

import socket
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Sequence, Tuple


class RanksFailed(RuntimeError):
    """A rank exited nonzero, or the ranks passed their deadline."""


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(fh, limit: int = 4000) -> str:
    fh.seek(0)
    return fh.read().decode(errors="replace")[-limit:]


def run_ranks(argv: Sequence[str], world: int, env: Dict[str, str],
              stdin: str, timeout: float,
              per_rank: Sequence[Dict[str, str]] = ()
              ) -> List[Tuple[str, str]]:
    """Run `argv` as ranks 0..world-1 (module docstring), rank p's
    environment `env` updated by per_rank[p] where given: [(stdout,
    stderr)] per rank, once every rank has exited 0 within `timeout`
    seconds; else every rank is killed and RanksFailed raised."""
    port = free_port()
    procs, outs, feeders = [], [], []
    try:
        for rank in range(world):
            out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            outs.append((out, err))
            rank_env = dict(env, S18_COORD_ADDR=f"127.0.0.1:{port}",
                            S18_NUM_PROCS=str(world), S18_PROC_ID=str(rank))
            if rank < len(per_rank):
                rank_env.update(per_rank[rank])
            proc = subprocess.Popen(
                list(argv), stdin=subprocess.PIPE, stdout=out, stderr=err,
                env=rank_env)
            procs.append(proc)
            feeder = threading.Thread(target=_feed, args=(proc, stdin),
                                      daemon=True)
            feeder.start()
            feeders.append(feeder)
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None:
            rcs = [p.poll() for p in procs]
            if all(rc == 0 for rc in rcs):
                break
            if any(rc not in (None, 0) for rc in rcs):
                failed = "a rank exited nonzero"
            elif time.monotonic() > deadline:
                failed = f"the ranks passed their {timeout} s deadline"
            else:
                time.sleep(0.05)
        if failed is not None:
            _kill(procs)
            report = "\n".join(
                f"--- rank {r}: rc {p.returncode}\n{_tail(o)}\n{_tail(e)}"
                for r, (p, (o, e)) in enumerate(zip(procs, outs)))
            raise RanksFailed(f"{' '.join(argv)} as {world} ranks: "
                              f"{failed}\n{report}")
        return [(_tail(o, 1 << 30), _tail(e, 1 << 30)) for o, e in outs]
    finally:
        _kill(procs)
        for feeder in feeders:
            feeder.join(timeout=5)
        for o, e in outs:
            o.close()
            e.close()


def _feed(proc: subprocess.Popen, text: str) -> None:
    """Write the protocol to a rank's stdin and close it; a rank that
    already exited has closed its end."""
    try:
        proc.stdin.write(text.encode())
        proc.stdin.close()
    except (BrokenPipeError, ValueError):
        pass


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()
