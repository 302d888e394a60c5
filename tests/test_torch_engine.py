"""The torch port's serving slice as a whole, held against the JAX
package on the catalog of tests/test_ms_engine.py (3 x 3000 rows):

- TorchEngine lines == JaxEngine lines == the NumPy oracle's, with the
  default size dispatch and again with RADIX_MIN_ROWS / EMIT_MS_MIN_ROWS
  at 256, so the staircase member serves on the CPU;
- run_protocol on a small protocol stream with malformed lines;
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
    # every intermediate join trips the guard: the text order serves
    assert _lines(catalogs[0], max_intermediate=1) == expected
    monkeypatch.setattr(texec, "HARD_INTERMEDIATE_CAP", 1)
    with pytest.raises(texec.IntermediateBlowup):
        _lines(catalogs[0])


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
    run_protocol(io.StringIO("\n".join(stream) + "\n"), out,
                 EngineConfig(platform="cpu", batch_workers=4))
    want = (expected[:4] + ["NULL", "NULL"] + ["NULL NULL", "NULL"]
            + expected[4:])
    assert out.getvalue().splitlines() == want


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
