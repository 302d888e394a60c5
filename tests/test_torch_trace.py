"""The serving process's instruments and prep, through `io.repl.serve` on
the CPU, against the JAX package's `run_protocol` on the same files:

- S18_EXPLAIN=1 prints the same plan and `actual` lines as the JAX
  operator engine;
- under S18_TRACE=json each query's join-family op names come in the
  same order as JAX's, every record parses, and the lines do not change;
- every `ops.` call of the operator engine's query path goes through
  `self._ops` (counted on a stub);
- S18_BACKEND=numpy answers as the JAX package's numpy backend and never
  asks for a device;
- async prep (S18_ASYNC_PREP) gives the lines of blocking prep, answers
  a first batch while the prefetch still waits, raises the prefetch's
  exception, and keeps the warm replay out of the serving counts;
- the per-key build of the engine's device caches under many threads;
- utils/floors.py's bytes, and the tracer's table and JSON output."""

import contextlib
import dataclasses
import io
import json
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sigmod2018_tpu.config import EngineConfig as JaxConfig
from sigmod2018_tpu.io.repl import run_protocol as jax_run_protocol
import sigmod2018_tpu_torch.ops as tops
from sigmod2018_tpu_torch.config import EngineConfig
from sigmod2018_tpu_torch.engine import executor as texec
from sigmod2018_tpu_torch.engine.compiled import CompiledTorchEngine
from sigmod2018_tpu_torch.engine.executor import TorchEngine
from sigmod2018_tpu_torch.engine.trace import TimedOps, Tracer
from sigmod2018_tpu_torch.frontend.parser import parse_query
from sigmod2018_tpu_torch.io.repl import serve
from sigmod2018_tpu_torch.ops import radix_join
from sigmod2018_tpu_torch.storage.catalog import Catalog
from sigmod2018_tpu_torch.storage.relation import Relation, store_relation
from sigmod2018_tpu_torch.utils import floors

QUERIES = [
    "0 1|0.0=1.0|0.1 1.2",
    "0 1 2|0.0=1.0&1.1=2.1|0.2 2.0",
    "0 1|0.0=1.0&0.1>250|1.1",
    "2 0|0.2=1.2&0.0<100|0.0 1.0",
    "1 1|0.1=1.2&0.2<300|1.1 0.2",
    "0 1 2|0.0=1.0&1.1=2.1&0.1>100|0.2 2.0",
    "0 1|0.0<5&1.1=7|0.1 1.0",                 # cartesian phase
    "0|0.0=0.1|0.2",                           # self-join
    "0 1|0.0=1.0&0.1=1.1|0.2 1.2",             # same-component join
    "0 1 2|0.0=1.0&1.1=2.1&2.2=0.2|0.0",       # cycle
    "0 1|0.0=1.0&0.1=18446744073709551615|1.1",  # NULL
    "0 1 2 1|0.0=1.0&1.1=2.1&2.2=3.0&3.1>50|0.1 3.2",  # 3 joins
]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    rng = np.random.default_rng(5)
    base = tmp_path_factory.mktemp("rels")
    out = []
    for i in range(3):
        cols = [rng.integers(0, 500, 3000).astype(np.uint64)
                for _ in range(3)]
        out.append(str(base / f"r{i}"))
        store_relation(Relation(columns=cols), out[-1])
    return out


def _stream(paths, texts=QUERIES, batches=2) -> str:
    half = len(texts) // batches + 1
    lines = list(paths) + ["Done"]
    for k in range(0, len(texts), half):
        lines += list(texts[k:k + half]) + ["F"]
    return "\n".join(lines) + "\n"


def _port(paths, texts=QUERIES, **cfg):
    """(lines, stderr lines, engine) of the port's serve on the CPU,
    without its warm-up tier."""
    cfg = dict(dict(platform="cpu", batch_workers=1, warmup_oracle=0), **cfg)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        engine = serve(io.StringIO(_stream(paths, texts)), out,
                       EngineConfig(**cfg))
    return out.getvalue().splitlines(), err.getvalue().splitlines(), engine


def _jax(paths, monkeypatch, texts=QUERIES, **cfg):
    """(lines, stderr lines) of the JAX package's run_protocol on the
    CPU, without its warm-up oracle tier."""
    monkeypatch.setenv("S18_WARMUP_ORACLE", "0")
    cfg = dict(dict(batch_workers=1, compile_queries=False), **cfg)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        jax_run_protocol(io.StringIO(_stream(paths, texts)), out,
                         dataclasses.replace(JaxConfig(), **cfg))
    return out.getvalue().splitlines(), err.getvalue().splitlines()


def _explain(lines):
    return [ln for ln in lines if ln.startswith("-- plan: ")
            or (ln.startswith("--   ") and ": actual " in ln)]


def _join_ops(lines):
    """{query text: [join-family op names]} of the JSON trace records."""
    out = {}
    for ln in lines:
        if ln.startswith("{"):
            rec = json.loads(ln)
            out.setdefault(rec["query"], []).append(
                [op["op"] for op in rec["ops"] if "join" in op["op"]])
    return out


@pytest.fixture(scope="module")
def jax_traced(paths):
    """JAX's operator engine under S18_EXPLAIN=1 and S18_TRACE=json."""
    mp = pytest.MonkeyPatch()
    try:
        return _jax(paths, mp, explain=True, trace="json")
    finally:
        mp.undo()


def test_explain_lines_equal_jax(paths, jax_traced):
    lines, err, engine = _port(paths, explain=True, compile_queries=False)
    assert type(engine) is TorchEngine
    assert lines == jax_traced[0]
    want = _explain(jax_traced[1])
    assert any(": actual " in ln for ln in want)
    assert _explain(err) == want


def test_trace_op_sequence_equals_jax(paths, jax_traced):
    lines, err, engine = _port(paths, trace="json", explain=True)
    assert type(engine) is TorchEngine  # S18_TRACE serves with it
    assert lines == jax_traced[0]
    assert _explain(err) == _explain(jax_traced[1])
    got, want = _join_ops(err), _join_ops(jax_traced[1])
    assert got == want and len(got) >= 8
    for ln in err:
        if ln.startswith("{"):
            rec = json.loads(ln)
            assert rec["device"] == "cpu"
            for op in rec["ops"]:
                assert op["device_ms"] >= 0 and op["hbm_frac"] is None
                fam = op["op"] in floors.FUSED_OPS + floors.COUNT_OPS + (
                    floors.TABLE_COUNT_OP,)
                assert ("floor_ms" in op) == fam


@pytest.mark.parametrize("mode", [True, "json"])
def test_lines_equal_with_and_without_trace(paths, mode):
    plain, _, _ = _port(paths, compile_queries=False)
    traced, err, _ = _port(paths, trace=mode, batch_workers=4)
    assert traced == plain
    heads = [ln for ln in err if ln.startswith(("-- trace ", "{"))]
    # one report per materializing dispatch: the queries that joined
    assert len(heads) == len(QUERIES)


class _Refuse:
    """Stands in for the ops module: the query path must not reach it."""

    def __getattr__(self, name):
        raise AssertionError(f"ops.{name} called off self._ops")


class _Counting:
    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        fn = getattr(tops, name)

        def counted(*a, **k):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*a, **k)

        return counted


@pytest.mark.parametrize("cfg", [dict(), dict(key_table_max=0),
                                 dict(join_algo="radix"),
                                 dict(join_algo="qd", key_table_max=0)])
def test_every_query_op_goes_through_self_ops(paths, monkeypatch, cfg):
    monkeypatch.setattr(radix_join, "RADIX_MIN_ROWS", 256)
    cat = Catalog.from_files(paths)
    want = [TorchEngine(cat, EngineConfig(platform="cpu", **cfg)).execute(
        parse_query(t)) for t in QUERIES]
    eng = TorchEngine(cat, EngineConfig(platform="cpu", **cfg))
    eng.prefetch()  # the untraced prep functions call the module
    counting = _Counting()
    eng._ops = counting
    monkeypatch.setattr(texec, "ops", _Refuse())
    assert [eng.execute(parse_query(t)) for t in QUERIES] == want
    for name in ("compare_mask", "mask_positions", "equal_mask",
                 "gather_u64", "take_cols", "checksum", "join_emit",
                 "fused_join_auto", "cartesian_indices"):
        assert counting.calls.get(name, 0) > 0, (name, counting.calls)
    probe = ("join_probe_count_table" if cfg.get("key_table_max", 1)
             else "join_probe_count_auto")
    assert counting.calls.get(probe, 0) > 0


def test_numpy_backend_equals_jax_and_touches_no_device(paths, monkeypatch):
    want, _ = _jax(paths, monkeypatch, backend="numpy")

    def refuse(self):
        raise AssertionError("EngineConfig.device called")

    monkeypatch.setattr(EngineConfig, "device", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    monkeypatch.setenv("S18_BACKEND", "numpy")
    monkeypatch.delenv("S18_PLATFORM", raising=False)  # the card default
    config = EngineConfig.from_env()
    assert (config.backend, config.platform) == ("numpy", "cuda")
    out = io.StringIO()
    engine = serve(io.StringIO(_stream(paths)), out, config)
    assert out.getvalue().splitlines() == want
    assert engine.tiers == {"oracle": len(QUERIES)}


def test_backend_must_be_known(monkeypatch):
    monkeypatch.setenv("S18_BACKEND", "jax")
    with pytest.raises(ValueError, match="S18_BACKEND"):
        EngineConfig.from_env()
    assert EngineConfig().backend == "torch"


def test_config_from_env(monkeypatch):
    fields = ("explain", "trace")
    assert ([getattr(EngineConfig(), f) for f in fields]
            == [getattr(JaxConfig(), f) for f in fields])
    assert (EngineConfig().async_prep, EngineConfig().native) == (True, True)
    for k, v in (("S18_EXPLAIN", "1"), ("S18_TRACE", "json"),
                 ("S18_ASYNC_PREP", "0"), ("S18_NATIVE", "0")):
        monkeypatch.setenv(k, v)
    got = EngineConfig.from_env()
    assert (got.explain, got.trace, got.async_prep, got.native) == (
        True, "json", False, False)
    assert [getattr(JaxConfig.from_env(), f) for f in fields] == [True,
                                                                  "json"]
    monkeypatch.setenv("S18_TRACE", "1")
    assert EngineConfig.from_env().trace is True


@pytest.mark.parametrize("compile_queries", [True, False])
def test_async_prep_gives_blocking_prep_lines(paths, compile_queries):
    blocking, _, _ = _port(paths, async_prep=False,
                           compile_queries=compile_queries)
    for workers in (1, 8):
        lines, _, engine = _port(paths, async_prep=True,
                                 compile_queries=compile_queries,
                                 batch_workers=workers)
        assert lines == blocking
        assert sum(engine.tiers.values()) == len(QUERIES)


class _FirstLineGate(io.StringIO):
    """stdout that opens `gate` once a line has been written."""

    def __init__(self, gate: threading.Event):
        super().__init__()
        self.gate = gate

    def write(self, s):
        n = super().write(s)
        if "\n" in s:
            self.gate.set()
        return n


def test_first_batch_answered_while_prefetch_waits(paths, monkeypatch):
    want, _, _ = _port(paths, async_prep=False)  # prefetch, then serve
    gate, seen = threading.Event(), SimpleNamespace(opened=None, done=False)
    real = TorchEngine.prefetch

    def gated(self):
        seen.opened = gate.wait(timeout=120)
        real(self)
        seen.done = True

    monkeypatch.setattr(TorchEngine, "prefetch", gated)
    out = _FirstLineGate(gate)
    engine = serve(io.StringIO(_stream(paths)), out,
                   EngineConfig(platform="cpu", batch_workers=1,
                                warmup_oracle=0))
    assert seen.opened is True  # released by the first line written
    assert seen.done  # joined before serve returned
    assert out.getvalue().splitlines() == want
    assert isinstance(engine, CompiledTorchEngine)


def test_raising_prefetch_makes_serve_raise(paths, monkeypatch):
    def boom(self):
        raise RuntimeError("prefetch failed on purpose")

    want, _, _ = _port(paths)
    monkeypatch.setattr(TorchEngine, "prefetch", boom)
    out = io.StringIO()
    with pytest.raises(RuntimeError, match="prefetch failed on purpose"):
        serve(io.StringIO(_stream(paths)), out,
              EngineConfig(platform="cpu"))
    assert out.getvalue().splitlines() == want  # every line went out first


def test_warm_replay_beside_serving_is_not_counted(paths, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path))
    want, _, _ = _port(paths)  # learns and persists the classes
    lines, _, engine = _port(paths, warm_replay=True, batch_workers=4)
    assert lines == want
    assert sum(engine.tiers.values()) == len(QUERIES)
    assert engine.counts["learned"] + engine.counts["no_class"] + \
        engine.counts["incremental"] + engine.counts["guessed"] <= \
        len(QUERIES)


def test_device_caches_build_each_key_once(paths, monkeypatch):
    """Many threads ask for the same artifacts at once with the
    interpreter switching often: each key is built exactly once."""
    builds = []
    real = tops.join_build
    monkeypatch.setattr(tops, "join_build",
                        lambda *a: builds.append(1) or real(*a))
    eng = TorchEngine(Catalog.from_files(paths), EngineConfig(platform="cpu"))
    keys = [(r, c) for r in range(3) for c in range(3)]
    barrier = threading.Barrier(24)
    got = [[] for _ in range(24)]

    def work(i):
        barrier.wait(timeout=60)
        for k in keys[i % 9:] + keys[:i % 9]:
            got[i].append(eng.device_sorted_column(*k))
            eng.device_prefix_table(k[0], k[1], (k[1] + 1) % 3)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == len(keys)
    for i in range(24):
        for k, hit in zip(keys[i % 9:] + keys[:i % 9], got[i]):
            assert hit is eng._sorted_columns[k]


# (op, positional args as shapes, bytes counted by hand)
FLOORS = {
    # 8 B keys both sides, 2 build and 3 probe value columns
    "fused_join_auto": (((1024,), (2, 1024), None, (2048,), (3, 2048)),
                        8 * 1024 + 8 * 2048 + 8 * (2 * 1024 + 3 * 2048)),
    # prefix-table member: no build values
    "ms_fused": (((1 << 21,), None, None, (1 << 21,), (1, 1 << 21)),
                 8 * (1 << 21) * 2 + 8 * (1 << 21)),
    "join_probe_count_auto": (((4096,), None, (8192,)), 8 * (4096 + 8192)),
    # a key table of u + 3 int32 entries, u = 2^20
    "join_probe_count_table": ((((1 << 20) + 3,), (1 << 21,)),
                               4 * ((1 << 20) + 3) + 8 * (1 << 21)),
}


@pytest.mark.parametrize("op", sorted(FLOORS))
def test_floors_count_bytes_by_hand(op):
    shapes, nbytes = FLOORS[op]
    args = [None if s is None else torch.zeros(
        s, dtype=torch.int32 if op.endswith("table") and i == 0
        else torch.int64) for i, s in enumerate(shapes)]
    fl = floors.floors_for_op(op, args)
    assert fl["bytes_min"] == nbytes
    assert fl["floor_ms"] == fl["mem_floor_ms"] == pytest.approx(
        nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert floors.floors_for_op("join_emit", args) is None


def test_tracer_reports_per_thread_in_both_modes():
    out = io.StringIO()
    tracer = Tracer(torch.device("cpu"), out=out, mode="json")
    timed = TimedOps(tops, tracer)
    keys = torch.arange(64, dtype=torch.int64)

    def query(label, n):
        tracer.reset()
        for _ in range(n):
            timed.join_probe_count_auto(keys, 64, keys, 64)
        timed.ms_member_selected(64, 64, "auto")  # no tensor: no record
        tracer.report(label)

    threads = [threading.Thread(target=query, args=(f"q{i}", i + 1))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    recs = {r["query"]: r for r in map(json.loads, out.getvalue().split(
        "\n")[:-1])}
    assert {q: len(r["ops"]) for q, r in recs.items()} == {
        "q0": 1, "q1": 2, "q2": 3, "q3": 4}
    op = recs["q0"]["ops"][0]
    assert op["op"] == "join_probe_count_auto"
    assert op["shapes"] == "(64,),(64,)"
    assert op["floor_ms"] == round(8 * 128 / 3.35e12 * 1e3, 4)
    table = io.StringIO()
    tracer = Tracer(torch.device("cpu"), out=table)
    TimedOps(tops, tracer).gather_u64(keys, torch.arange(8))
    tracer.report("q")
    head, line = table.getvalue().splitlines()
    assert head.startswith("-- trace q: ") and head.endswith("(cpu)")
    assert line.startswith("--   gather_u64") and "sol=" not in line
