"""The driver's cold start (io/repl.py) on the CPU: the card starts in a
thread while the relations load, and the warm-up tier answers small
queries on the host until the card's thread has made the engine.

- the JAX package's two warm-up tests' inputs through both packages'
  run_protocol, the window held open and with S18_WARMUP_ORACLE=0: equal
  lines, the NULL of a garbage line included;
- the bound, the oracle's intermediate cap and a host fault;
- the tier closing once the engine is made (its prefetch still
  running) and once the card's thread has failed;
- in fresh processes: the first batch written while torch is held back
  (the main thread imports none), no tier under a process group, no
  torch at all under S18_BACKEND=numpy, and a run without the card it
  asks for exits non-zero even when the tier answered every line;
- the start timeline.
"""

import io
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from sigmod2018_tpu.config import EngineConfig as JaxConfig
from sigmod2018_tpu.engine.executor import JaxEngine
from sigmod2018_tpu.io.repl import run_protocol as jax_run_protocol
from sigmod2018_tpu_torch.config import EngineConfig
from sigmod2018_tpu_torch.engine import factorized
from sigmod2018_tpu_torch.engine.executor import TIERS, TorchEngine
from sigmod2018_tpu_torch.engine.oracle import execute_query_numpy
from sigmod2018_tpu_torch.frontend.parser import parse_query
from sigmod2018_tpu_torch.io import repl
from sigmod2018_tpu_torch.parallel.launch import run_ranks
from sigmod2018_tpu_torch.storage.catalog import Catalog
from sigmod2018_tpu_torch.storage.relation import (Relation,
                                                   make_identity_relation,
                                                   store_relation)

ROOT = Path(__file__).resolve().parent.parent
RUN_TIMEOUT_S = 120

# tests/test_executor_modes.py::test_warmup_oracle_tier_exact's protocol
# (test_warmup_oracle_disabled's is its first batch)
JAX_TEXTS = ["0 1|0.0=1.0|0.0 1.1", "garbage query line", "F",
             "0|0.1>4|0.2", "F", "Exit"]
JAX_LINES = ["45 45", "NULL", str(sum(range(5, 20)))]


@pytest.fixture
def identity_paths(tmp_path):
    """The JAX tests' two identity relations of 20 and 10 rows."""
    paths = []
    for i, n in enumerate((20, 10)):
        paths.append(str(tmp_path / f"r{i}"))
        store_relation(make_identity_relation(n, 3), paths[-1])
    return paths


class _Stdin:
    """Protocol lines that set `exhausted` once `Exit` (or the end) has
    been read: an engine (or, in the JAX package, a prefetch) that waits
    on it keeps the tier's window open for every query."""

    def __init__(self, lines, exhausted: threading.Event):
        self._lines = iter(lines)
        self.exhausted = exhausted

    def __iter__(self):
        return self

    def __next__(self) -> str:
        try:
            line = next(self._lines)
        except StopIteration:
            self.exhausted.set()
            raise
        if line == "Exit":
            self.exhausted.set()
        return line + "\n"


def _hold_prefetch(monkeypatch, cls, exhausted: threading.Event) -> None:
    real = cls.prefetch

    def held(self):
        assert exhausted.wait(RUN_TIMEOUT_S)
        real(self)

    monkeypatch.setattr(cls, "prefetch", held)


def _hold_engine(monkeypatch, release: threading.Event) -> None:
    """The card's thread makes the engine only once `release` is set or a
    query asks for the engine: the tier's window is open until then."""
    real_make, real_engine = repl.make_engine, repl._Card.engine

    def held(catalog, config):
        assert release.wait(RUN_TIMEOUT_S)
        return real_make(catalog, config)

    def engine(card):
        release.set()
        return real_engine(card)

    monkeypatch.setattr(repl, "make_engine", held)
    monkeypatch.setattr(repl._Card, "engine", engine)


@pytest.mark.parametrize("bound", [1 << 30, 0])
def test_lines_equal_jax_with_the_window_open_and_closed(
        identity_paths, monkeypatch, bound):
    monkeypatch.setenv("S18_WARMUP_ORACLE", str(bound))
    monkeypatch.setenv("S18_ASYNC_PREP", "1")
    lines = identity_paths + ["Done"] + JAX_TEXTS
    jax_done, done = threading.Event(), threading.Event()
    _hold_prefetch(monkeypatch, JaxEngine, jax_done)
    jout = io.StringIO()
    jax_run_protocol(_Stdin(lines, jax_done), jout,
                     JaxConfig(batch_workers=4, vault=False))
    _hold_engine(monkeypatch, done)
    for k, v in (("S18_PLATFORM", "cpu"), ("S18_WORKERS", "4")):
        monkeypatch.setenv(k, v)
    out = io.StringIO()
    tiers = repl.run_protocol(_Stdin(lines, done), out)
    assert jout.getvalue().splitlines() == JAX_LINES
    assert out.getvalue().splitlines() == JAX_LINES
    # the two well-formed queries: all on the host with the window open,
    # all by the engine with the tier off
    assert tiers["warmup_host"] == (2 if bound else 0)
    assert sum(tiers[t] for t in TIERS) == (0 if bound else 2)


def _stream(paths, batches) -> list:
    lines = list(paths) + ["Done"]
    for batch in batches:
        lines += list(batch) + ["F"]
    return lines


@pytest.fixture
def skewed_paths(tmp_path):
    """Three relations of 300, 200 and 100 rows, keys below 12."""
    rng = np.random.default_rng(5)
    paths = []
    for i, n in enumerate((300, 200, 100)):
        cols = [rng.integers(0, 12, n).astype(np.uint64) for _ in range(3)]
        paths.append(str(tmp_path / f"r{i}"))
        store_relation(Relation(columns=cols), paths[-1])
    return paths


CHAIN = "0 1 2|0.0=1.0&1.1=2.0|0.2 2.1"  # a forest: message passing
CYCLE = "0 1 2|0.0=1.0&1.1=2.0&2.2=0.1|0.1 1.2"  # the oracle materializes
SMALL = "1 2|0.1=1.0&1.2<9|0.0 1.1"  # 300 rows referenced


def _oracle(paths, texts):
    cat = Catalog.from_files(paths, native=False)
    return [execute_query_numpy(parse_query(t), cat) for t in texts]


def _held_serve(monkeypatch, paths, batches, done=None, **cfg):
    """(lines, tiers) of serve, one batch thread, with the window open
    until `done` is set or a query asks for the engine."""
    done = threading.Event() if done is None else done
    _hold_engine(monkeypatch, done)
    out, log = io.StringIO(), repl.ServeLog()
    config = EngineConfig(**dict(dict(platform="cpu", batch_workers=1), **cfg))
    engine = repl.serve(_Stdin(_stream(paths, batches), done), out, config,
                        log)
    return out.getvalue().splitlines(), dict(engine.tiers,
                                              warmup_host=log.warmup_host)


def test_a_query_past_the_bound_waits_for_the_engine(skewed_paths,
                                                     monkeypatch):
    texts = [SMALL, CHAIN, CYCLE]  # 300, 600 and 600 rows referenced
    lines, tiers = _held_serve(monkeypatch, skewed_paths, [texts],
                               warmup_oracle=300)
    assert lines == _oracle(skewed_paths, texts)
    assert tiers["warmup_host"] == 1
    assert sum(tiers[t] for t in TIERS) == 2


def test_an_intermediate_past_the_cap_goes_to_the_engine(skewed_paths,
                                                         monkeypatch):
    """The cycle's first join makes more rows than max_intermediate: the
    oracle stops before it materializes them (OracleOverflow) and the
    engine answers; the forest before it answers on the host."""
    cat = Catalog.from_files(skewed_paths, native=False)
    first = execute_query_numpy(parse_query("0 1|0.0=1.0|0.1"), cat)
    assert first != "NULL"
    lines, tiers = _held_serve(monkeypatch, skewed_paths, [[CHAIN, CYCLE]],
                               max_intermediate=1000)
    assert lines == _oracle(skewed_paths, [CHAIN, CYCLE])
    assert tiers["warmup_host"] == 1
    assert sum(tiers[t] for t in TIERS) == 1


def test_a_host_fault_propagates(skewed_paths, monkeypatch):
    """Only OracleOverflow sends a query on to the engine: any other
    exception of the tier ends the run."""
    done = threading.Event()

    def broken(query, catalog):
        done.set()  # the engine may be made: serve joins it before it raises
        raise ArithmeticError("host fault on purpose")

    monkeypatch.setattr(factorized, "execute_query_factorized_np", broken)
    with pytest.raises(ArithmeticError, match="host fault on purpose"):
        _held_serve(monkeypatch, skewed_paths, [[CHAIN]], done)


class _Gated:
    """Protocol lines of two batches; the second is read only once the
    card's thread has made the engine or failed (`built`)."""

    def __init__(self, paths, first, second, monkeypatch):
        self._lines = iter(_stream(paths, [first]))
        self._second = iter(list(second) + ["F"])
        self.card = None
        real = repl._Card.__init__

        def init(card, *args):
            self.card = card
            real(card, *args)

        monkeypatch.setattr(repl._Card, "__init__", init)

    def __iter__(self):
        return self

    def __next__(self) -> str:
        line = next(self._lines, None)
        if line is None:
            assert self.card.built.wait(RUN_TIMEOUT_S)
            line = next(self._second)
        return line + "\n"


class _Out(io.StringIO):
    """stdout that sets `written` at its first flush (the first batch)."""

    def __init__(self):
        super().__init__()
        self.written = threading.Event()

    def flush(self):
        super().flush()
        self.written.set()


def test_the_tier_closes_once_the_engine_is_made(skewed_paths, monkeypatch):
    """The engine is made after the first batch is written, and its
    prefetch is held to the end: the second batch goes to the engine
    (building its columns on demand) although the prefetch has not
    ended."""
    out, log = _Out(), repl.ServeLog()
    _hold_engine(monkeypatch, out.written)
    prefetched = threading.Event()
    _hold_prefetch(monkeypatch, TorchEngine, prefetched)
    stdin = _Gated(skewed_paths, [CHAIN, SMALL], [SMALL, CYCLE], monkeypatch)
    real_answer = repl._answer

    def answer(*args):
        try:
            real_answer(*args)
        finally:
            assert "prefetch_done" not in log.marks
            prefetched.set()

    monkeypatch.setattr(repl, "_answer", answer)
    engine = repl.serve(stdin, out, EngineConfig(platform="cpu"), log)
    assert out.getvalue().splitlines() == _oracle(skewed_paths,
                                                  [CHAIN, SMALL, SMALL, CYCLE])
    assert log.warmup_host == 2 and sum(engine.tiers.values()) == 2


def test_a_failed_start_closes_the_tier(skewed_paths, monkeypatch):
    """The card's thread fails after the first batch: the next query
    raises its exception at once instead of going to the host."""
    out, log = _Out(), repl.ServeLog()

    def failing(catalog, config):
        assert out.written.wait(RUN_TIMEOUT_S)
        raise RuntimeError("the card failed on purpose")

    monkeypatch.setattr(repl, "make_engine", failing)
    stdin = _Gated(skewed_paths, [CHAIN, SMALL], [SMALL], monkeypatch)
    with pytest.raises(RuntimeError, match="the card failed on purpose"):
        repl.serve(stdin, out, EngineConfig(platform="cpu"), log)
    assert out.getvalue().splitlines() == _oracle(skewed_paths,
                                                  [CHAIN, SMALL])
    assert log.warmup_host == 2 and "engine_built" not in log.marks


def test_blocking_prep_keeps_the_tier_closed(skewed_paths):
    out, log = io.StringIO(), repl.ServeLog()
    engine = repl.serve(
        _Stdin(_stream(skewed_paths, [[CHAIN, SMALL]]), threading.Event()),
        out, EngineConfig(platform="cpu", async_prep=False), log)
    assert out.getvalue().splitlines() == _oracle(skewed_paths,
                                                  [CHAIN, SMALL])
    assert log.warmup_host == 0 and sum(engine.tiers.values()) == 2
    # every step of the start was noted: the card's in order, the
    # engine after the catalog and the first line after the prefetch
    assert set(log.marks) == set(repl.STEPS)
    card = [log.marks[s] for s in (
        "card_started", "torch_imported", "cuda_ready", "kernels_loaded",
        "engine_imported", "engine_built", "prefetch_done")]
    assert card == sorted(card)
    assert log.marks["catalog_loaded"] <= log.marks["engine_built"]
    assert log.marks["prefetch_done"] <= log.marks["first_line"]


def test_warmup_oracle_is_read_and_checked(monkeypatch):
    assert EngineConfig().warmup_oracle == 1 << 21
    monkeypatch.setenv("S18_WARMUP_ORACLE", "0")
    assert EngineConfig.from_env().warmup_oracle == 0
    monkeypatch.setenv("S18_WARMUP_ORACLE", "-1")
    with pytest.raises(ValueError, match="S18_WARMUP_ORACLE"):
        EngineConfig.from_env()


def test_timeline_counts_from_the_origin():
    log = repl.ServeLog()
    log.marks["done_read"] = 12.5
    log.marks["last_line"] = 13.0
    got = log.timeline(10.0)
    assert list(got) == list(repl.STEPS)
    assert got["done_read"] == 2.5 and got["last_line"] == 3.0
    assert got["torch_imported"] is None
    start = repl.process_start()
    assert time.perf_counter() - 600 < start <= time.perf_counter()


# ---- fresh processes ---------------------------------------------------------

# sys.meta_path finder of the subprocesses.  MODE "hold": torch's module
# body runs only once the first batch is flushed (or after 30 s), and a
# main thread that asks for torch before that fails; the wait is in the
# loader, since a finder runs under the global import lock.  "block":
# torch is refused in every thread.
_FINDER = """
import importlib.machinery, sys, threading
released = threading.Event()
asked = []

class HeldLoader:
    def __init__(self, real):
        self.real = real

    def create_module(self, spec):
        return self.real.create_module(spec)

    def exec_module(self, module):
        released.wait(30)
        self.real.exec_module(module)

class TorchFinder:
    def find_spec(self, name, path=None, target=None):
        if name != "torch":
            return None
        asked.append(threading.current_thread().name)
        if MODE == "block":
            raise ImportError("torch is blocked in this process")
        if (threading.current_thread() is threading.main_thread()
                and not released.is_set()):
            raise ImportError("the main thread asked for torch before "
                              "the first batch was written")
        spec = importlib.machinery.PathFinder.find_spec(name, path)
        spec.loader = HeldLoader(spec.loader)
        return spec

sys.meta_path.insert(0, TorchFinder())
"""

_HOLD = _FINDER + """
class Out:
    def __init__(self, real):
        self.real, self.flushes = real, 0

    def write(self, s):
        return self.real.write(s)

    def flush(self):
        self.real.flush()
        self.flushes += 1
        if self.flushes == 1:
            ready = hasattr(sys.modules.get("torch"), "Tensor")
            print(f"first batch written; torch imported {ready}; asked "
                  f"by {sorted(set(asked))}",
                  file=sys.stderr, flush=True)
            released.set()

sys.stdout = Out(sys.stdout)
import runpy
runpy.run_module("sigmod2018_tpu_torch", run_name="__main__")
"""


def _python(code: str, mode: str, stdin: str, **s18):
    env = dict(os.environ, PYTHONPATH=str(ROOT), S18_PLATFORM="cpu")
    return subprocess.run(
        [sys.executable, "-c", f"MODE = {mode!r}\n" + code], input=stdin,
        env=dict(env, **s18), capture_output=True, text=True,
        timeout=RUN_TIMEOUT_S)


def _stderr_json(stderr: str, prefix: str) -> dict:
    """The JSON object of the stderr line `prefix {..}`."""
    return json.loads(next(ln for ln in stderr.splitlines()
                           if ln.startswith(prefix + " {"))[len(prefix):])


def test_first_batch_is_written_before_torch_imports(skewed_paths):
    batches = [[CHAIN, SMALL, CYCLE], [SMALL, CHAIN]]
    proc = _python(_HOLD, "hold", "\n".join(_stream(skewed_paths, batches))
                   + "\n")
    assert proc.returncode == 0, proc.stderr
    want = _oracle(skewed_paths, [t for b in batches for t in b])
    assert proc.stdout.splitlines() == want
    # torch was asked for by the card's thread only, and was still held
    # back when the first batch went out
    assert ("first batch written; torch imported False; asked by "
            "['s18card']") in proc.stderr
    start = _stderr_json(proc.stderr, "start")
    assert start["first_line"] < start["torch_imported"]
    # the first batch from the tier, the second from either
    served = proc.stderr.splitlines()[-1]
    assert 3 <= int(served.rsplit("warmup_host=", 1)[1]) <= 5, served


_HELD_ENGINE = """
import sys, threading
from sigmod2018_tpu_torch.io import repl

batch_read = threading.Event()

class Stdin:
    def __init__(self, real):
        self.real = real

    def __iter__(self):
        return self

    def __next__(self):
        line = next(self.real)
        if line.strip() == "F":
            batch_read.set()
        return line

def held(catalog, config, real=repl.make_engine):
    batch_read.wait(60)
    return real(catalog, config)

repl.make_engine = held
sys.stdin = Stdin(sys.stdin)
repl.main()
"""


def test_no_tier_under_a_process_group(skewed_paths, tmp_path):
    """Two ranks whose engines are made only once the batch is read:
    without a group the tier would take the batch, but under a group the
    engine answers each query on every rank."""
    texts = [CHAIN, SMALL, CYCLE]
    stream = "\n".join(_stream(skewed_paths, [texts]) + ["Exit"]) + "\n"
    env = dict(os.environ, PYTHONPATH=str(ROOT), S18_PLATFORM="cpu",
               S18_MESH="2", S18_PREP_CACHE=str(tmp_path / "cache"))
    outs = run_ranks([sys.executable, "-c", _HELD_ENGINE], 2, env, stream,
                     RUN_TIMEOUT_S)
    want = _oracle(skewed_paths, texts)
    for stdout, stderr in outs:
        assert stdout.splitlines() == want
        assert stderr.splitlines()[-2].endswith(" warmup_host=0")
        assert sum(_stderr_json(stderr, "process")["tiers"].values()) == 3


def test_numpy_backend_never_imports_torch(skewed_paths):
    code = _FINDER + textwrap.dedent("""
        import runpy
        runpy.run_module("sigmod2018_tpu_torch", run_name="__main__")
        assert "torch" not in sys.modules and not asked, asked
        """)
    proc = _python(code, "block", "\n".join(
        _stream(skewed_paths, [[CHAIN, SMALL, CYCLE]])) + "\n",
        S18_BACKEND="numpy", S18_PLATFORM="cuda")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == _oracle(skewed_paths,
                                               [CHAIN, SMALL, CYCLE])
    assert proc.stderr.splitlines()[-1] == (
        "served by tier: oracle=3 warmup_host=0")
    assert _stderr_json(proc.stderr, "start")["torch_imported"] is None


def test_a_missing_card_fails_the_run(skewed_paths):
    """S18_PLATFORM=cuda without a card: torch is held back until the
    tier has answered every (small) query, and the run still exits
    non-zero, naming the missing card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = _python(_HOLD, "hold", "\n".join(
        _stream(skewed_paths, [[CHAIN, SMALL]])) + "\n", S18_PLATFORM="cuda")
    assert proc.returncode != 0
    assert proc.stdout.splitlines() == _oracle(skewed_paths, [CHAIN, SMALL])
    assert ("S18_PLATFORM=cuda but torch.cuda.is_available() is False"
            in proc.stderr)
    assert _stderr_json(proc.stderr, "start")["cuda_ready"] is None
