"""The port's whole-query engine (sigmod2018_tpu_torch/engine/compiled.py)
held against the JAX package's CompiledEngine on the CPU, on relation
files made from a seed:

- the lines of a batch mixing filters, self-joins, fused single joins,
  1-3 intermediate joins, a cycle edge, a cartesian fallback and NULL
  results, run twice (the second time from learned classes and the
  per-text fast path), equal JAX's and the NumPy oracle's;
- the static plan and the guessed classes of every query;
- the learned classes after a run, and their reload by a fresh engine on
  the same files (another relation set sees none);
- speculative misses (estimates forced low) and truths past
  max_intermediate: the line, the serving tier and the engine's counts,
  and that no later appearance of such a text, in the engine or in a
  fresh one on the same prep cache, sizes a join past the guard;
- warm replay, the protocol driver's engine choice, the prep-cache keys,
  counts under many batch threads, and that serving traces and compiles
  nothing (why the JAX program vault is not ported)."""

import io
import sys
import threading

import numpy as np
import pytest
import torch

from sigmod2018_tpu.config import EngineConfig as JaxConfig
from sigmod2018_tpu.engine import compiled as jcompiled
from sigmod2018_tpu.engine.compiled import CompiledEngine
from sigmod2018_tpu.engine.executor import format_batch as jax_format_batch
from sigmod2018_tpu.engine.oracle import execute_query_numpy
from sigmod2018_tpu.frontend import parser as jparser
from sigmod2018_tpu.storage import catalog as jcatalog
from sigmod2018_tpu_torch.config import EngineConfig
from sigmod2018_tpu_torch.engine import compiled, executor as texec
from sigmod2018_tpu_torch.frontend import parser as tparser
from sigmod2018_tpu_torch.io.repl import serve
from sigmod2018_tpu_torch.storage import catalog as tcatalog
from sigmod2018_tpu_torch.storage.relation import Relation, store_relation

QUERIES = [
    "0 1|0.0=1.0|0.1 1.2",                                 # fused, no class
    "0 1|0.0=1.0&0.1>20|0.1 1.2",                          # filter + fused
    "0|0.0=0.1&0.2<30|0.0 0.2",                            # self-join, no join
    "0 1 2|0.0=1.0&1.1=2.1|0.2 1.0 2.2",                   # 1 intermediate
    "0 1 2|0.0=1.0&1.1=2.1&0.1=1.2|0.2 2.2",               # cycle edge
    "0 1 2 3|0.0=1.0&1.1=2.1&2.2=3.0|3.1 0.1",             # 2 intermediate
    "0 1 2 3 1|0.0=1.0&1.1=2.1&2.2=3.0&3.1=4.2|4.0 2.1",   # 3, rel 1 twice
    "0 1|0.0<5&1.1=7|0.1 1.0",                             # cartesian
    "0 1|0.0=1.0&0.0>100|0.0 1.1",                         # NULL (filter)
    "0 1 2|0.0=1.0&1.1=2.1&2.0>1000|0.1 2.2",              # NULL, 1 class
    "0 0|0.0=1.1|0.2 1.0",                                 # relation twice
]
CHAIN = QUERIES[3]  # one intermediate join, of 513 to 1,024 rows
CYCLE = QUERIES[4]


def _write(directory, seed, sizes=(300, 200, 150, 80), dom=40):
    rng = np.random.default_rng(seed)
    directory.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, n in enumerate(sizes):
        cols = [rng.integers(0, dom, size=n).astype(np.uint64)
                for _ in range(3)]
        paths.append(str(directory / f"r{i}"))
        store_relation(Relation(columns=cols), paths[-1])
    return paths


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("rels"), seed=7)


@pytest.fixture(scope="module")
def jax_run(paths, tmp_path_factory):
    """The JAX CompiledEngine on the files, with its own prep cache:
    (engine, lines of the batch run twice, the oracle's lines)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("S18_PREP_CACHE", str(tmp_path_factory.mktemp("jax_prep")))
    try:
        cat = jcatalog.Catalog.from_files(paths)
        eng = CompiledEngine(cat, JaxConfig(vault=False))
        eng.prefetch()
        queries = [jparser.parse_query(q) for q in QUERIES]
        lines = [jax_format_batch([eng.execute_async(q) for q in queries])
                 for _ in range(2)]
        want = [execute_query_numpy(q, cat) for q in queries]
    finally:
        mp.undo()
    return eng, lines, want


def _engine(paths, **cfg):
    eng = compiled.CompiledTorchEngine(tcatalog.Catalog.from_files(paths),
                                       EngineConfig(platform="cpu", **cfg))
    eng.prefetch()
    return eng


def _batch(eng, texts):
    return texec.format_batch(
        [eng.execute_async(tparser.parse_query(t)) for t in texts])


def _zero_counts(**nonzero):
    return dict(dict.fromkeys(("segment_reads",) + compiled.SPEC_COUNTS, 0),
                **nonzero)


def _tiers(**nonzero):
    return dict(dict.fromkeys(texec.TIERS, 0), **nonzero)


def test_batch_lines_match_jax(paths, jax_run, tmp_path, monkeypatch):
    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path))
    _, jax_lines, want = jax_run
    assert jax_lines == [want, want]
    eng = _engine(paths)
    assert _batch(eng, QUERIES) == want
    # every class was guessed right from the estimates on this catalog
    assert eng.counts == _zero_counts(no_class=5, guessed=5)
    assert _batch(eng, QUERIES) == want
    assert eng.counts == _zero_counts(no_class=10, guessed=5, learned=5)
    assert set(eng._fastpath) == set(QUERIES) - {QUERIES[7]}
    assert eng.tiers == _tiers(materialized=2 * len(QUERIES))


@pytest.mark.parametrize("text", QUERIES)
def test_static_plan_and_guesses_match_jax(paths, jax_run, text):
    jeng = jax_run[0]
    teng = compiled.CompiledTorchEngine(tcatalog.Catalog.from_files(paths),
                                        EngineConfig(platform="cpu"))
    jq, tq = jparser.parse_query(text), tparser.parse_query(text)
    if text == QUERIES[7]:
        with pytest.raises(compiled._Fallback):
            teng._static_plan(tq)
        with pytest.raises(jcompiled._Fallback):
            jeng._static_plan(jq)
        return
    jjoins, jcols, jn, jidx = jeng._static_plan(jq)
    tjoins, tcols, tn, tidx = teng._static_plan(tq)
    assert [str(j) for j in tjoins] == [str(j) for j in jjoins]
    assert (tcols, tn, tidx) == (jcols, jn, jidx)
    guess = teng._guess_classes(tq, tjoins, tidx)
    assert guess == jeng._guess_classes(jq, jjoins, jidx)
    # the operator engine's steps size exactly the joins the plan counts
    cols = {rc: teng.device_column(*rc) for rc in tcols}
    packed = compiled.run_segments(teng, tq, tjoins, guess, cols)
    assert packed.shape == (tn + 1 + len(tq.views),)


def test_learned_classes_match_jax_and_persist(paths, jax_run, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path))
    jax_learned = jax_run[0]._learned_cache()
    eng = _engine(paths)
    _batch(eng, QUERIES)
    assert eng._learned_classes == jax_learned
    assert len(jax_learned) == 5  # the queries with an intermediate join
    # a fresh engine on the same files reads them before it runs anything
    again = _engine(paths)
    assert again._learned_classes == jax_learned
    assert _batch(again, QUERIES) == jax_run[2]
    assert again.counts == _zero_counts(no_class=5, learned=5)
    # the file is the port's own
    assert again._learned_path.startswith(str(tmp_path))
    assert "learned-torch-" in again._learned_path
    # another relation set, or another sizing config, sees none
    other = _write(tmp_path / "other", seed=8)
    assert _engine(paths[:3] + other[3:])._learned_classes == {}
    assert _engine(paths, key_table_max=0)._learned_classes == {}
    monkeypatch.setenv("S18_PREP_CACHE", "0")
    assert _engine(paths)._learned_classes == {}


def _low_estimates(monkeypatch, est):
    monkeypatch.setattr(compiled, "estimate_cardinalities",
                        lambda q, cat, joins: [est] * len(joins))


@pytest.mark.parametrize("cfg,counts", [
    # the guess (class 128) is under the truth: retried at fetch
    (dict(), dict(guessed=1, retried=1, segment_reads=1)),
    # no speculation, or a guess past spec_max: one read per join at once
    (dict(speculate=False), dict(incremental=1, segment_reads=1)),
    (dict(spec_max=64), dict(incremental=1, segment_reads=1)),
])
def test_speculative_miss(paths, jax_run, tmp_path, monkeypatch, cfg,
                          counts):
    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path))
    _low_estimates(monkeypatch, 1)
    want = jax_run[2][QUERIES.index(CHAIN)]
    eng = _engine(paths, **cfg)
    assert _batch(eng, [CHAIN]) == [want]
    assert eng.counts == _zero_counts(**counts)
    assert eng.tiers == _tiers(materialized=1)
    learned = jax_run[0]._learned_cache()[CHAIN]
    assert eng._learned_classes == {CHAIN: learned}
    # with speculation on, the next run uses the learned class: no read,
    # no retry
    if cfg:
        return
    assert _batch(eng, [CHAIN]) == [want]
    assert eng.counts == _zero_counts(learned=1, **counts)
    assert eng.tiers == _tiers(materialized=2)


@pytest.mark.parametrize("est,text,tier,counts", [
    # a small guess misses; the retry's host read finds the total past
    # max_intermediate, and the forest query answers by message passing
    (1, CHAIN, "factorized_blowup",
     dict(guessed=1, retried=1, segment_reads=1)),
    # a guess past max_intermediate is cut to its class (512), which
    # the truth passes
    (3000, CHAIN, "factorized_blowup",
     dict(guessed=1, retried=1, segment_reads=1)),
    # a cyclic query is no forest: the text order answers (two reads)
    (1, CYCLE, "text_order",
     dict(guessed=1, retried=1, segment_reads=3)),
])
def test_miss_past_max_intermediate(paths, jax_run, tmp_path, monkeypatch,
                                    est, text, tier, counts):
    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path))
    _low_estimates(monkeypatch, est)
    eng = _engine(paths, max_intermediate=500)
    want = jax_run[2][QUERIES.index(text)]
    assert _batch(eng, [text]) == [want]
    assert eng.tiers == _tiers(**{tier: 1})
    assert eng.counts == _zero_counts(**counts)
    # the JAX engine answers the same line under the same guard
    jeng = CompiledEngine(jcatalog.Catalog.from_files(paths),
                          JaxConfig(vault=False, max_intermediate=500))
    assert jeng.execute(jparser.parse_query(text)) == want


@pytest.mark.parametrize("text,tier", [(CHAIN, "factorized_blowup"),
                                       (CYCLE, "text_order")])
def test_blowup_never_sized_past_max_intermediate(paths, jax_run, tmp_path,
                                                  monkeypatch, text, tier):
    """A truth past max_intermediate is never learned, and a class that a
    process without the guard learned on the same files is not used: on
    every appearance of the text, in one engine and in a fresh one on
    the same prep cache, no join is emitted past the guard's class
    before the blow-up net answers."""
    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path))
    _low_estimates(monkeypatch, 1)
    want = jax_run[2][QUERIES.index(text)]
    teach = _engine(paths)  # the default guard: learns the true class
    assert _batch(teach, [text]) == [want]
    assert max(teach._learned_classes[text]) > 512
    outside_net, in_net = [], []
    real_emit, real_net = texec.ops.join_emit, texec.TorchEngine._blowup_net

    def emit(*args, out_size, **kw):
        if not in_net:
            outside_net.append(out_size)
        return real_emit(*args, out_size=out_size, **kw)

    def net(self, query):
        in_net.append(query)
        try:
            return real_net(self, query)
        finally:
            in_net.pop()

    monkeypatch.setattr(texec.ops, "join_emit", emit)
    monkeypatch.setattr(compiled.CompiledTorchEngine, "_blowup_net", net)
    for _ in range(2):  # in one engine, then in a fresh one
        eng = _engine(paths, max_intermediate=500)
        for run in (1, 2):
            assert _batch(eng, [text]) == [want]
            assert eng.tiers == _tiers(**{tier: run})
            assert (eng.counts["guessed"], eng.counts["retried"]) == (run,
                                                                      run)
    assert outside_net and max(outside_net) <= 512, outside_net


def test_warm_replay(paths, jax_run, tmp_path, monkeypatch):
    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path))
    texts = [CHAIN, QUERIES[6]]
    want = [jax_run[2][QUERIES.index(t)] for t in texts]
    assert _batch(_engine(paths), texts) == want  # learns and persists
    eng = _engine(paths, warm_replay=True)
    # prefetch ran both texts; the serving counts start after it
    assert set(eng._fastpath) == set(texts)
    assert eng.counts == _zero_counts() and eng.tiers == _tiers()
    assert _batch(eng, texts) == want
    assert eng.counts == _zero_counts(learned=2)


def test_no_trace_or_compile_while_serving(paths, jax_run, tmp_path,
                                           monkeypatch):
    """The JAX package keeps a vault of exported programs so that no
    trace or compile happens while serving.  The port runs eager
    PyTorch: a whole batch, twice, goes through neither torch.compile
    nor TorchScript and leaves dynamo's counters empty, so it needs no
    vault."""
    from torch._dynamo.utils import counters

    def refuse(*a, **k):
        raise AssertionError("traced or compiled while serving")

    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path))
    monkeypatch.setattr(torch, "compile", refuse)
    monkeypatch.setattr(torch.jit, "script", refuse)
    monkeypatch.setattr(torch.jit, "trace", refuse)
    counters.clear()
    eng = _engine(paths)
    assert [_batch(eng, QUERIES) for _ in range(2)] == [jax_run[2]] * 2
    assert not any(counters.values()), dict(counters)


def _stream(paths, texts):
    return io.StringIO("\n".join(list(paths) + ["Done"] + texts + ["F"])
                       + "\n")


@pytest.mark.parametrize("env,engine", [
    ({}, "CompiledTorchEngine"),
    ({"S18_COMPILE_QUERIES": "1"}, "CompiledTorchEngine"),
    ({"S18_COMPILE_QUERIES": "0"}, "TorchEngine"),
])
def test_driver_engine_choice(paths, jax_run, tmp_path, monkeypatch, env,
                              engine):
    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path))
    monkeypatch.setenv("S18_PLATFORM", "cpu")
    monkeypatch.delenv("S18_COMPILE_QUERIES", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = io.StringIO()
    eng = serve(_stream(paths, QUERIES), out)
    assert type(eng).__name__ == engine
    assert out.getvalue().splitlines() == jax_run[2]
    assert eng.tiers == _tiers(materialized=len(QUERIES))
    # the operator engine reads every intermediate total (9 joins in all)
    assert eng.counts["segment_reads"] == (
        0 if engine == "CompiledTorchEngine" else 9)


def test_config_from_env(monkeypatch):
    fields = ("compile_queries", "speculate", "spec_margin", "spec_max",
              "warm_replay")
    assert ([getattr(EngineConfig(), f) for f in fields]
            == [getattr(JaxConfig(), f) for f in fields])
    for k, v in (("S18_COMPILE_QUERIES", "0"), ("S18_SPECULATE", "0"),
                 ("S18_SPEC_MARGIN", "3"), ("S18_SPEC_MAX", "4096"),
                 ("S18_WARM_REPLAY", "1")):
        monkeypatch.setenv(k, v)
    got = EngineConfig.from_env()
    assert ([getattr(got, f) for f in fields]
            == [getattr(JaxConfig.from_env(), f) for f in fields]
            == [False, False, 3, 4096, True])


def test_many_batch_threads(paths, jax_run, tmp_path, monkeypatch):
    """Counts, tiers and learned classes stay whole when many threads
    dispatch one batch with the interpreter switching threads often."""
    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path))
    texts = [t for t in QUERIES if t != QUERIES[7]] * 6
    want = [jax_run[2][QUERIES.index(t)] for t in texts]
    served, out = [], io.StringIO()

    def run():
        served.append(serve(_stream(paths, texts), out,
                            EngineConfig(platform="cpu", batch_workers=32)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive() and len(served) == 1
    eng = served[0]
    assert out.getvalue().splitlines() == want
    spec = sum(eng.counts[k] for k in ("no_class", "learned", "guessed",
                                        "incremental"))
    assert spec == len(texts) and eng.counts["retried"] == 0
    assert eng.tiers == _tiers(materialized=len(texts))
    assert eng._learned_classes == jax_run[0]._learned_cache()


@pytest.mark.parametrize("setting", [None, "0", "custom"])
def test_prep_cache_keys_match_jax(paths, tmp_path, monkeypatch, setting):
    if setting is None:
        monkeypatch.delenv("S18_PREP_CACHE", raising=False)
    else:
        monkeypatch.setenv("S18_PREP_CACHE", setting if setting == "0"
                           else str(tmp_path / setting))
    got, want = tcatalog.prep_cache_dir(), jcatalog.prep_cache_dir()
    if setting is None:
        # each package has a default directory of its own
        assert got.endswith("sigmod2018_tpu_torch")
        assert want.endswith("sigmod2018_tpu") and got != want
    else:
        assert got == want
    assert tcatalog.identity_digest(paths) == jcatalog.identity_digest(paths)
    assert tcatalog.identity_digest(paths + [str(tmp_path / "none")]) is None
    assert tcatalog.Catalog.from_files(paths).source_paths == paths
    cols = [np.arange(5, dtype=np.uint64)]
    assert tcatalog.Catalog([Relation(columns=cols)]).source_paths == []


def test_join_emit_without_host_total(paths):
    """run_segments with fewer classes returns the next total as a 0-d
    tensor and reads nothing; with a class under the truth the live
    count is cut to the class."""
    eng = compiled.CompiledTorchEngine(tcatalog.Catalog.from_files(paths),
                                       EngineConfig(platform="cpu"))
    q = tparser.parse_query(QUERIES[5])
    joins, cols_used, n, _ = eng._static_plan(q)
    cols = {rc: eng.device_column(*rc) for rc in cols_used}
    first = compiled.run_segments(eng, q, joins, (), cols)
    assert first.dim() == 0 and first.dtype == torch.int64
    P = 1 << (int(first) - 1).bit_length()
    second = compiled.run_segments(eng, q, joins, (P,), cols)
    assert second.dim() == 0
    packed = compiled.run_segments(eng, q, joins, (P, 128), cols)
    assert packed.shape == (n + 1 + len(q.views),)
    assert packed[:2].tolist() == [int(first), int(second)]
    assert int(second) > 128 and 0 < int(packed[2]) <= int(second)
