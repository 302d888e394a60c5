"""The torch port's serving slice as a whole, held against the JAX
package on the catalog of tests/test_ms_engine.py (3 x 3000 rows):

- TorchEngine lines == JaxEngine lines == the NumPy oracle's, with the
  default size dispatch and again with RADIX_MIN_ROWS / EMIT_MS_MIN_ROWS
  at 256, so the staircase member serves on the CPU;
- run_protocol on a small protocol stream with malformed lines;
- the serving tiers (materialized, factorized_proactive,
  factorized_blowup, text_order) against the tier JaxEngine chose;
- equal parse IR, ColumnStats and DP join orders."""

import dataclasses
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from sigmod2018_tpu.config import EngineConfig as JaxConfig
from sigmod2018_tpu.engine.executor import JaxEngine
from sigmod2018_tpu.engine.oracle import execute_query_numpy
from sigmod2018_tpu.frontend import parser as jparser
from sigmod2018_tpu.planner import join_order as jorder
from sigmod2018_tpu.planner import stats as jstats
from sigmod2018_tpu.storage import catalog as jcatalog
from sigmod2018_tpu.storage.relation import Relation as JaxRelation
from sigmod2018_tpu_torch.config import EngineConfig
from sigmod2018_tpu_torch.engine import executor as texec
from sigmod2018_tpu_torch.frontend import parser as tparser
from sigmod2018_tpu_torch.io.repl import run_protocol
from sigmod2018_tpu_torch.ops import ms_join, qd_join, radix_join
from sigmod2018_tpu_torch.planner import join_order as torder
from sigmod2018_tpu_torch.planner import stats as tstats
from sigmod2018_tpu_torch.storage.catalog import Catalog
from sigmod2018_tpu_torch.storage.relation import Relation, store_relation

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
]

ROOT = Path(__file__).resolve().parent.parent


def _columns(seed=5, rows=3000, dom=500, nrel=3):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, dom, rows).astype(np.uint64) for _ in range(3)]
            for _ in range(nrel)]


@pytest.fixture(scope="module")
def catalogs():
    cols = _columns()
    return (Catalog([Relation(columns=c) for c in cols]),
            jcatalog.Catalog([JaxRelation(columns=c) for c in cols]))


@pytest.fixture(scope="module")
def expected(catalogs):
    _, jcat = catalogs
    want = [execute_query_numpy(jparser.parse_query(q), jcat)
            for q in QUERIES]
    eng = JaxEngine(jcat, dataclasses.replace(JaxConfig(),
                                              compile_queries=False))
    eng.prefetch()
    assert [eng.execute(jparser.parse_query(q)) for q in QUERIES] == want
    return want


def _lines(cat, **cfg):
    eng = texec.TorchEngine(cat, EngineConfig(platform="cpu", **cfg))
    eng.prefetch()
    return [eng.execute(tparser.parse_query(q)) for q in QUERIES]


@pytest.mark.parametrize("key_table_max", [1 << 22, 0])
def test_engine_matches_jax(catalogs, expected, key_table_max):
    assert _lines(catalogs[0], key_table_max=key_table_max) == expected


@pytest.mark.parametrize("key_table_max", [1 << 22, 0])
def test_engine_staircase_dispatch_matches_jax(catalogs, expected,
                                               monkeypatch, key_table_max):
    calls = []
    real = ms_join.staircase_counts
    monkeypatch.setattr(ms_join, "staircase_counts",
                        lambda *a: calls.append(a[2].shape[0]) or real(*a))
    monkeypatch.setattr(radix_join, "RADIX_MIN_ROWS", 256)
    monkeypatch.setattr(ms_join, "EMIT_MS_MIN_ROWS", 256)
    assert _lines(catalogs[0], key_table_max=key_table_max) == expected
    assert calls, "the staircase member never ran"


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    return calls


def test_forced_members(catalogs, expected, monkeypatch):
    assert _lines(catalogs[0], join_algo="ms") == expected
    assert _lines(catalogs[0], join_algo="sort") == expected
    # radix and qd, with and without key tables; the lowered threshold
    # lets forced radix build its prep artifacts for these 4096-row columns
    monkeypatch.setattr(radix_join, "RADIX_MIN_ROWS", 256)
    for algo, module, member in (("radix", radix_join, "radix_fused_static"),
                                 ("qd", qd_join, "qd_fused_static")):
        for key_table_max in (1 << 22, 0):
            calls = _spy(monkeypatch, module, member)
            assert _lines(catalogs[0], join_algo=algo,
                          key_table_max=key_table_max) == expected
            assert calls, f"the {algo} member never ran"


def test_forced_qd_with_key_tables(catalogs, monkeypatch):
    """Forced qd on a join whose build side has a key table.  The JAX
    engine turns the probe-only prefix-table member on there, hands the
    qd member no build values and answers from its host oracle after an
    AttributeError (ROADMAP.md Queue 3); the port runs its qd member."""
    tcat, jcat = catalogs
    q = "0 1|0.0=1.0|0.1 1.2"
    eng = JaxEngine(jcat, dataclasses.replace(JaxConfig(), join_algo="qd",
                                              compile_queries=False))
    eng.prefetch()
    want = eng.execute(jparser.parse_query(q))
    assert want == execute_query_numpy(jparser.parse_query(q), jcat)
    calls = _spy(monkeypatch, qd_join, "qd_fused_static")
    teng = texec.TorchEngine(tcat, EngineConfig(platform="cpu",
                                                join_algo="qd"))
    teng.prefetch()
    assert teng.device_key_table(0, 0) is not None
    assert teng.execute(tparser.parse_query(q)) == want
    assert len(calls) == 1


def test_engine_uses_radix_artifacts_bit_exact(tmp_path, monkeypatch):
    """After tests/test_radix_join.py::
    test_engine_uses_radix_artifacts_bit_exact: forced radix with key
    tables off and the threshold lowered builds prep-time radix artifacts,
    passes them to the member for both base sides, and answers the
    oracle's line."""
    monkeypatch.setattr(radix_join, "RADIX_MIN_ROWS", 512)
    rng = np.random.default_rng(23)
    cols = [[rng.integers(0, 300, size=n).astype(np.uint64)
             for _ in range(3)] for n in (900, 700)]
    jcat = jcatalog.Catalog([JaxRelation(columns=c) for c in cols])
    eng = texec.TorchEngine(
        Catalog([Relation(columns=c) for c in cols]),
        EngineConfig(platform="cpu", join_algo="radix", key_table_max=0))
    eng.prefetch()
    assert eng.device_radix_keys(0, 0) is not None, \
        "prep must build radix artifacts under the lowered threshold"
    calls = _spy(monkeypatch, radix_join, "radix_fused_static")
    before = dict(radix_join.BRANCHES)
    for text in ("0 1|0.0=1.0|0.1 1.2", "0 1|0.0=1.0&0.1>100|1.1 0.2"):
        q = jparser.parse_query(text)
        assert eng.execute(tparser.parse_query(text)) == \
            execute_query_numpy(q, jcat)
    assert calls[0]["prep_b"] is not None and calls[0]["prep_p"] is not None
    # the filtered side sorts at query time; the base side uses its prep
    assert (calls[1]["prep_b"] is None) != (calls[1]["prep_p"] is None)
    assert radix_join.BRANCHES["kernel"] == before["kernel"] + 2


def test_blowup_reruns_in_text_order(catalogs, expected, monkeypatch):
    # every intermediate join trips the guard: a forest query answers by
    # message passing, the cyclic and the duplicate-pair query in text
    # order
    assert _lines(catalogs[0], max_intermediate=1) == expected
    monkeypatch.setattr(texec, "HARD_INTERMEDIATE_CAP", 1)
    with pytest.raises(texec.IntermediateBlowup):
        _lines(catalogs[0])


def _hot_columns(m=800):
    # one hot key everywhere: every join order's intermediate is m^2
    rng = np.random.default_rng(9)
    return [[np.full(m, 7, np.uint64),
             rng.integers(0, 1 << 40, m).astype(np.uint64),
             rng.integers(0, 9, m).astype(np.uint64)] for _ in range(3)]


def _fanout_columns(n=4000, dom=400):
    # 10x fanout per join: a 4-relation chain's planned intermediates grow
    rng = np.random.default_rng(3)
    return [[rng.integers(0, dom, n).astype(np.uint64),
             rng.integers(0, 1 << 20, n).astype(np.uint64),
             rng.integers(0, dom, n).astype(np.uint64)] for _ in range(4)]


def _dense_columns():
    # tests/test_factorized.py::_catalog(seed=4, keyspace=8)
    rng = np.random.default_rng(4)
    return [[rng.integers(0, 8, size=n).astype(np.uint64) for _ in range(3)]
            for n in (300, 250, 200, 150)]


def _jax_tier(eng, query, monkeypatch):
    """(line, tier) of JaxEngine.execute, the tier read off its calls."""
    import sigmod2018_tpu.engine.factorized as jfact

    seen = {"dispatch": 0, "factorized": 0}
    real_fact, real_disp = jfact.factorized_result, eng._dispatch

    def fact(*a):
        res = real_fact(*a)
        seen["factorized"] += res is not None  # None: not a forest
        return res

    def disp(*a, **k):
        seen["dispatch"] += 1
        return real_disp(*a, **k)

    with monkeypatch.context() as m:
        m.setattr(jfact, "factorized_result", fact)
        m.setattr(eng, "_dispatch", disp)
        line = eng.execute(query)
    tier = {(0, 1): "factorized_proactive", (1, 0): "materialized",
            (1, 1): "factorized_blowup", (2, 0): "text_order"}[
                seen["dispatch"], seen["factorized"]]
    return line, tier


FANOUT_CHAIN = "0 1 2 3|0.0=1.2&1.2=2.0&2.0=3.2|1.1 0.1"
ROUTING = [
    # (columns, config, query, tier)
    # the hot key's final estimate (800^3) reaches 16 x factorize_min, so
    # the blow-up net serves only with the proactive tier switched off
    (_hot_columns, dict(max_intermediate=1000, factorize_min=0),
     "0 1 2|0.0=1.0&1.0=2.0|1.1 0.1", "factorized_blowup"),
    (_hot_columns, dict(max_intermediate=1000),
     "0 1 2|0.0=1.0&1.0=2.0|1.1 0.1", "factorized_proactive"),
    (_dense_columns, dict(max_intermediate=1000),
     "0 1 2|0.0=1.0&1.1=2.1&2.2=0.2|0.1 2.0", "text_order"),
    (_fanout_columns, dict(factorize_min=1 << 16, max_intermediate=1 << 30),
     FANOUT_CHAIN, "factorized_proactive"),
    (_fanout_columns, dict(factorize_min=1 << 16, max_intermediate=1 << 30),
     "0 1|0.0=1.2&0.1>1000000|0.1 1.1", "materialized"),
    (_fanout_columns, dict(factorize_min=0, max_intermediate=1 << 30),
     "0 1 2|0.0=1.2&1.2=2.0|1.1 0.1", "materialized"),
]


@pytest.mark.parametrize("columns,cfg,text,tier", ROUTING,
                         ids=[f"{r[3]}-{i}" for i, r in enumerate(ROUTING)])
def test_serving_tier_matches_jax(columns, cfg, text, tier, monkeypatch):
    """The tier that answers, and _maybe_factorized's decision, equal
    JaxEngine's on the same catalog and configuration; the line is the
    oracle's (the factorized twin's where the oracle cannot materialize)."""
    from sigmod2018_tpu.engine.factorized import execute_query_factorized_np

    cols = columns()
    tcat = Catalog([Relation(columns=c) for c in cols])
    jcat = jcatalog.Catalog([JaxRelation(columns=c) for c in cols])
    jq, tq = jparser.parse_query(text), tparser.parse_query(text)
    want = (execute_query_factorized_np(jq, jcat) if columns is _hot_columns
            else execute_query_numpy(jq, jcat, max_rows=1 << 28))
    jeng = JaxEngine(jcat, dataclasses.replace(
        JaxConfig(), compile_queries=False, **cfg))
    jeng.prefetch()
    assert _jax_tier(jeng, jq, monkeypatch) == (want, tier)
    teng = texec.TorchEngine(tcat, EngineConfig(platform="cpu", **cfg))
    teng.prefetch()
    assert teng.execute(tq) == want
    assert teng.tiers == dict(dict.fromkeys(texec.TIERS, 0), **{tier: 1})
    assert ((teng._maybe_factorized(tq) is not None)
            == (jeng._maybe_factorized(jq) is not None)
            == (tier == "factorized_proactive"))
    # the decision is cached per text and a second run takes the same tier
    assert teng._fact_choice.get(text, False) == (
        tier == "factorized_proactive")
    assert teng.execute(tq) == want
    assert teng.tiers[tier] == 2


def test_estimator_error_propagates(catalogs, monkeypatch):
    """An estimator fault is not swallowed into the materializing path."""
    def boom(*a):
        raise ZeroDivisionError("estimator")

    monkeypatch.setattr(texec, "estimate_cardinalities", boom)
    eng = texec.TorchEngine(catalogs[0], EngineConfig(platform="cpu"))
    with pytest.raises(ZeroDivisionError):
        eng.execute(tparser.parse_query(QUERIES[1]))
    assert sum(eng.tiers.values()) == 0


def test_factorize_min_from_env(monkeypatch):
    assert EngineConfig().factorize_min == JaxConfig().factorize_min == 1 << 22
    monkeypatch.setenv("S18_FACTORIZE_MIN", "4096")
    monkeypatch.setenv("S18_PLATFORM", "cpu")
    assert EngineConfig.from_env().factorize_min == 4096
    assert JaxConfig.from_env().factorize_min == 4096


def test_cuda_platform_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        EngineConfig(platform="cuda").device()
    with pytest.raises(ValueError):
        EngineConfig(platform="tpu").device()


def test_run_protocol(tmp_path, catalogs, expected):
    paths = []
    for i, cols in enumerate(_columns()):
        paths.append(tmp_path / f"r{i}")
        store_relation(Relation(columns=cols), paths[-1])
    bad = ["0 1|0.0=1.0", "0 1|0.0=1.x|0.1", "0 7|0.0=1.0|0.1 1.1",
           "0 1|0.0=1.9|0.1"]
    stream = ([str(p) for p in paths] + ["Done"] + QUERIES[:4] + bad[:2]
              + ["F"] + bad[2:] + QUERIES[4:] + ["F", "Exit"])
    out = io.StringIO()
    tiers = run_protocol(io.StringIO("\n".join(stream) + "\n"), out,
                         EngineConfig(platform="cpu", batch_workers=4,
                                      warmup_oracle=0))
    want = (expected[:4] + ["NULL", "NULL"] + ["NULL NULL", "NULL"]
            + expected[4:])
    assert out.getvalue().splitlines() == want
    # every well-formed query is counted under the tier that served it
    assert tiers == dict(dict.fromkeys(texec.TIERS, 0),
                         materialized=len(QUERIES), warmup_host=0)


def test_main_prints_tier_counts(tmp_path):
    """`python -m sigmod2018_tpu_torch`: the lines on stdout, the
    engine's counts and the tier counts on stderr at exit;
    S18_FACTORIZE_MIN is read."""
    import os
    import subprocess
    import sys

    paths = []
    for i, cols in enumerate(_fanout_columns()):
        paths.append(tmp_path / f"r{i}")
        store_relation(Relation(columns=cols), paths[-1])
    text = FANOUT_CHAIN
    stream = "\n".join([str(p) for p in paths] + ["Done", text, QUERIES[0],
                                                  "F"]) + "\n"
    env = dict(os.environ, S18_PLATFORM="cpu", S18_FACTORIZE_MIN=str(1 << 16),
               S18_WARMUP_ORACLE="0", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "sigmod2018_tpu_torch"],
                          input=stream, env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.splitlines()) == 2
    assert proc.stderr.strip().splitlines()[-1] == (
        "served by tier: materialized=1 factorized_proactive=1 "
        "factorized_blowup=0 text_order=0 warmup_host=0")
    # before it, the default engine's counts: the fused single join
    # needed no size class and nothing was read back
    assert proc.stderr.strip().splitlines()[-2] == (
        "engine CompiledTorchEngine: segment_reads=0 no_class=1 learned=0 "
        "guessed=0 retried=0 incremental=0")


def test_parse_ir_matches():
    texts = QUERIES + (ROOT / "workloads/bigdom/bigdom.work").read_text(
    ).splitlines()
    for t in texts:
        if t == "F":
            continue
        tq, jq = tparser.parse_query(t), jparser.parse_query(t)
        assert str(tq) == str(jq)
        assert [dataclasses.astuple(p) for p in tq.predicates] == \
            [dataclasses.astuple(p) for p in jq.predicates]
        assert (tq.relations, tq.views, tq.text) == \
            (jq.relations, jq.views, jq.text)


def _planner_catalogs(tmp_path):
    rng = np.random.default_rng(17)
    cols = []
    for dom in (50, 3000, 200, 1 << 40):
        zipf = np.minimum(rng.zipf(1.5, 2000), dom).astype(np.uint64)
        cols.append([rng.integers(0, dom, 2000, dtype=np.uint64), zipf,
                     rng.integers(0, dom // 2 + 1, 2000, dtype=np.uint64)])
    paths = []
    for i, c in enumerate(cols):
        paths.append(str(tmp_path / f"r{i}"))
        store_relation(Relation(columns=c), paths[-1])
    return (Catalog.from_files(paths),
            jcatalog.Catalog([JaxRelation(columns=c) for c in cols]))


def test_column_stats_match(tmp_path):
    tcat, jcat = _planner_catalogs(tmp_path)
    assert ([[dataclasses.astuple(s) for s in r] for r in tcat.stats]
            == [[dataclasses.astuple(s) for s in r] for r in jcat.stats])


@pytest.mark.parametrize("estimator", ["dbound", "ref"])
def test_join_orders_match(tmp_path, monkeypatch, estimator):
    monkeypatch.setattr(tstats, "ESTIMATOR", estimator)
    monkeypatch.setattr(jstats, "ESTIMATOR", estimator)
    tcat, jcat = _planner_catalogs(tmp_path)
    texts = [t for w in ("big/big.work", "bigdom/bigdom.work")
             for t in (ROOT / "workloads" / w).read_text().splitlines()
             if t != "F"] + QUERIES
    for t in texts:
        got = torder.plan_joins(tparser.parse_query(t), tcat)
        want = jorder.plan_joins(jparser.parse_query(t), jcat)
        assert [str(j) for j in got] == [str(j) for j in want], t
