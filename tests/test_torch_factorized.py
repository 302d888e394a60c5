"""The torch port's blow-up path against the JAX package, all exact
(uint64 checksum lines, tolerance 0), on seeded NumPy inputs fed to both:

- the host oracle (`execute_query_numpy`) and the NumPy factorized twin
  (`execute_query_factorized_np`), with `plan_forest` / `down_edges`;
- `factorized_result` on `platform="cpu"` against JAX
  `factorized_result` and the NumPy twin, with the NULL, wrap-around,
  blow-up, live 2^64-1 key and thrice-self-joined cases;
- no host sync inside `factorized_result`;
- `query_to_sql`.

The catalogs and queries are those of tests/test_factorized.py."""

import dataclasses

import numpy as np
import pytest
import torch

from sigmod2018_tpu.config import EngineConfig as JaxConfig
from sigmod2018_tpu.engine import factorized as jfact
from sigmod2018_tpu.engine import oracle as joracle
from sigmod2018_tpu.engine.executor import JaxEngine
from sigmod2018_tpu.frontend import parser as jparser
from sigmod2018_tpu.frontend.sql import query_to_sql as jax_query_to_sql
from sigmod2018_tpu.storage import catalog as jcatalog
from sigmod2018_tpu.storage.relation import Relation as JaxRelation
from sigmod2018_tpu_torch.config import EngineConfig
from sigmod2018_tpu_torch.engine import factorized as tfact
from sigmod2018_tpu_torch.engine import oracle as toracle
from sigmod2018_tpu_torch.engine.executor import PendingResult, TorchEngine
from sigmod2018_tpu_torch.frontend import parser as tparser
from sigmod2018_tpu_torch.frontend.sql import query_to_sql
from sigmod2018_tpu_torch.storage.catalog import Catalog
from sigmod2018_tpu_torch.storage.relation import Relation

FOREST_QUERIES = [
    "0 1|0.0=1.0|0.1 1.2",                          # single join
    "0 1 2|0.0=1.0&1.1=2.1|0.2 2.2",                # chain
    "0 1 2 3|0.0=1.0&0.1=2.1&0.2=3.2|1.1 2.2 3.0",  # star
    "0 1 2|0.0=1.0&1.1=2.1&0.1>20|0.2",             # chain + filter
    "0 1|0.0=1.0&1.1=1.2|0.1",                      # self-join mask
    "0 1 2 3|0.0=1.0&2.1=3.1|0.1 2.2",              # two components
    "0 1 2|0.0=1.0|0.1 2.2",                        # view-only binding
    "0 1|0.0=1.0&0.1=39&1.2<2|0.1 1.1",             # selective filters
    "0 0|0.0=1.1|0.2 1.0",                          # same relation twice
    "0 1|0.0=1.0&0.1>999|0.1",                      # empty -> NULL
    "0|0.1<20|0.0 0.2",                             # no joins at all
]
TRIANGLE = "0 1 2|0.0=1.0&1.1=2.1&2.2=0.2|0.1"
DUPLICATE_PAIR = "0 1|0.0=1.0&0.1=1.1|0.1"
# workloads/zipfbig's 4th and 5th query shapes: relation 1 bound three times
THRICE = ["1 1 1 3|0.0=1.2&1.2=2.2&2.0=3.0|3.1 3.2 2.2",
          "1 3 1 2|0.2=1.1&1.0=2.2&2.0=3.1|2.0 3.2 1.2"]
BLOWUP = "0 1 2|0.0=1.0&1.0=2.0|1.1 0.1"


def _random_chains(n=40):
    """The texts of tests/test_factorized.py::
    test_np_twin_randomized_chains (same seed, same draws)."""
    rng = np.random.default_rng(7)
    texts = []
    for _ in range(n):
        nrel = int(rng.integers(2, 5))
        bindings = rng.integers(0, 4, size=nrel)
        preds = [f"{b-1}.{rng.integers(0,3)}={b}.{rng.integers(0,3)}"
                 for b in range(1, nrel)]
        if rng.random() < 0.7:
            op = rng.choice(["<", ">", "="])
            preds.append(f"{rng.integers(0,nrel)}.{rng.integers(0,3)}"
                         f"{op}{rng.integers(0, 20)}")
        views = " ".join(f"{rng.integers(0,nrel)}.{rng.integers(0,3)}"
                         for _ in range(int(rng.integers(1, 4))))
        texts.append(f"{' '.join(map(str, bindings))}|{'&'.join(preds)}"
                     f"|{views}")
    return texts


RANDOM_CHAINS = _random_chains()


def _both(columns):
    """(port catalog, JAX catalog) over the same columns."""
    return (Catalog([Relation(columns=c) for c in columns]),
            jcatalog.Catalog([JaxRelation(columns=c) for c in columns]))


def _columns(seed=0, nrel=4, rows=(300, 250, 200, 150), keyspace=40):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, keyspace, size=rows[i]).astype(np.uint64)
             for _ in range(3)] for i in range(nrel)]


def _blowup_columns(m=1200):
    """One hot key of multiplicity m in three relations: count = m^3."""
    rng = np.random.default_rng(5)
    vals = [rng.integers(0, 1 << 40, m).astype(np.uint64) for _ in range(3)]
    return [[np.full(m, 7, np.uint64), v,
             rng.integers(0, 9, m).astype(np.uint64)] for v in vals]


def _wrap_columns():
    top = np.uint64((1 << 64) - 3)
    return [[np.array([1, 1, 2], np.uint64),
             np.array([top, top, top], np.uint64),
             np.array([0, 1, 2], np.uint64)],
            [np.array([1, 1, 1, 2], np.uint64),
             np.array([top, 5, 6, 7], np.uint64),
             np.array([3, 4, 5, 6], np.uint64)]]


def _maxkey_columns():
    """Join keys from a pool that holds 2^64-1 and 0 (the sort sentinel
    of join_build and the device columns' pad value), at row counts that
    leave pad rows."""
    rng = np.random.default_rng(11)
    pool = np.array([(1 << 64) - 1, 0, 5, (1 << 63), (1 << 64) - 2],
                    dtype=np.uint64)
    return [[pool[rng.integers(0, pool.size, n)] for _ in range(2)]
            + [rng.integers(0, 1 << 62, n).astype(np.uint64)]
            for n in (300, 257, 130)]


@pytest.fixture(scope="module")
def cats():
    return _both(_columns())


@pytest.fixture(scope="module")
def dense_cats():
    return _both(_columns(seed=3, keyspace=15))  # big multiplicities


@pytest.fixture(scope="module")
def engines():
    """(TorchEngine on the CPU, JaxEngine, port catalog, JAX catalog)."""
    tcat, jcat = _both(_columns(seed=1, keyspace=25))
    return (TorchEngine(tcat, EngineConfig(platform="cpu")),
            JaxEngine(jcat, JaxConfig.from_env()), tcat, jcat)


# ---- host half: oracle, NumPy twin, plan ---------------------------------


@pytest.mark.parametrize("text", FOREST_QUERIES + THRICE)
def test_np_oracle_and_twin_match_jax_package(cats, text):
    tcat, jcat = cats
    tq, jq = tparser.parse_query(text), jparser.parse_query(text)
    want = joracle.execute_query_numpy(jq, jcat)
    assert jfact.execute_query_factorized_np(jq, jcat) == want
    assert toracle.execute_query_numpy(tq, tcat) == want
    assert tfact.execute_query_factorized_np(tq, tcat) == want


@pytest.mark.parametrize("text", RANDOM_CHAINS)
def test_np_random_chains_match_jax_package(dense_cats, text):
    tcat, jcat = dense_cats
    tq, jq = tparser.parse_query(text), jparser.parse_query(text)
    want = joracle.execute_query_numpy(jq, jcat)
    assert toracle.execute_query_numpy(tq, tcat) == want
    assert (tfact.execute_query_factorized_np(tq, tcat)
            == jfact.execute_query_factorized_np(jq, jcat) == want)


def test_np_oracle_join_order_and_guard(cats):
    tcat, jcat = cats
    text = FOREST_QUERIES[2]
    tq, jq = tparser.parse_query(text), jparser.parse_query(text)
    want = joracle.execute_query_numpy(jq, jcat)
    assert toracle.execute_query_numpy(
        tq, tcat, join_order=list(reversed(tq.joins))) == want
    with pytest.raises(toracle.OracleOverflow):
        toracle.execute_query_numpy(tq, tcat, max_rows=100)
    with pytest.raises(joracle.OracleOverflow):
        joracle.execute_query_numpy(jq, jcat, max_rows=100)


def test_np_wraparound_sums():
    tcat, jcat = _both(_wrap_columns())
    text = "0 1|0.0=1.0|0.1 1.1"
    tq, jq = tparser.parse_query(text), jparser.parse_query(text)
    want = joracle.execute_query_numpy(jq, jcat)
    assert toracle.execute_query_numpy(tq, tcat) == want
    assert tfact.execute_query_factorized_np(tq, tcat) == want


def test_np_blowup_query_exact():
    """The smallest intermediate is 1,200^2 rows and the result 1,200^3:
    the oracle's guard fires; the twin answers the closed form."""
    m = 1200
    cols = _blowup_columns(m)
    tcat, jcat = _both(cols)
    tq, jq = tparser.parse_query(BLOWUP), jparser.parse_query(BLOWUP)
    with pytest.raises(toracle.OracleOverflow):
        toracle.execute_query_numpy(tq, tcat, max_rows=1_000_000)
    got = tfact.execute_query_factorized_np(tq, tcat)
    assert got == jfact.execute_query_factorized_np(jq, jcat)
    mask = (1 << 64) - 1
    want = [(m * m * int(np.add.reduce(cols[i][1], dtype=np.uint64))) & mask
            for i in (1, 0)]
    assert got == f"{want[0]} {want[1]}"


def _plan_tuple(module, query):
    plan = module.plan_forest(query)
    if plan is None:
        return None
    down = sorted(dataclasses.astuple(e)
                  for e in module.down_edges(plan, query))
    return dataclasses.astuple(plan), down


@pytest.mark.parametrize(
    "text", FOREST_QUERIES + THRICE + RANDOM_CHAINS[:8]
    + [TRIANGLE, DUPLICATE_PAIR])
def test_plan_forest_and_down_edges_match(text):
    got = _plan_tuple(tfact, tparser.parse_query(text))
    assert got == _plan_tuple(jfact, jparser.parse_query(text))
    assert (got is None) == (text in (TRIANGLE, DUPLICATE_PAIR))


def test_np_edge_ranks_cached_on_catalog(cats):
    tcat, _ = cats
    q = tparser.parse_query(THRICE[0])
    tfact.execute_query_factorized_np(q, tcat)
    keys = set(tcat.__dict__["_np_edge_ranks"])
    # relation 1's column 2 receives from 1.0 and sends to 1.2's partner
    assert {k for k in keys if k[:2] == (1, 2)} and \
        {k for k in keys if k[2:] == (1, 2)}
    hit = tcat.__dict__["_np_edge_ranks"][next(iter(keys))]
    tfact.execute_query_factorized_np(q, tcat)
    assert tcat.__dict__["_np_edge_ranks"][next(iter(keys))] is hit


# ---- device half on the CPU ----------------------------------------------


@pytest.mark.parametrize("text", FOREST_QUERIES + THRICE)
def test_factorized_result_matches_jax_and_twin(engines, text):
    teng, jeng, tcat, jcat = engines
    tq, jq = tparser.parse_query(text), jparser.parse_query(text)
    res = tfact.factorized_result(teng, tq)
    assert isinstance(res, PendingResult)
    want = jfact.factorized_result(jeng, jq).line()
    assert want == jfact.execute_query_factorized_np(jq, jcat)
    assert res.line() == want
    assert tfact.execute_query_factorized_np(tq, tcat) == want


@pytest.mark.parametrize("text", RANDOM_CHAINS)
def test_factorized_result_random_chains(dense_cats, text):
    tcat, jcat = dense_cats
    teng = TorchEngine(tcat, EngineConfig(platform="cpu"))
    res = tfact.factorized_result(teng, tparser.parse_query(text))
    assert res.line() == joracle.execute_query_numpy(
        jparser.parse_query(text), jcat)


@pytest.mark.parametrize("text", [TRIANGLE, DUPLICATE_PAIR])
def test_factorized_result_none_when_not_a_forest(engines, text):
    teng, jeng, _, _ = engines
    assert tfact.factorized_result(teng, tparser.parse_query(text)) is None
    assert jfact.factorized_result(jeng, jparser.parse_query(text)) is None


def test_factorized_result_null_on_empty():
    tcat, jcat = _both(_columns(seed=2))
    text = "0 1|0.0=1.0&0.1>999999|0.1 1.1"
    res = tfact.factorized_result(
        TorchEngine(tcat, EngineConfig(platform="cpu")),
        tparser.parse_query(text))
    assert res.packed.tolist()[0] == 0
    assert res.line() == "NULL NULL" == jfact.factorized_result(
        JaxEngine(jcat, JaxConfig.from_env()),
        jparser.parse_query(text)).line()


def test_factorized_result_blowup_exact():
    tcat, jcat = _both(_blowup_columns())
    res = tfact.factorized_result(
        TorchEngine(tcat, EngineConfig(platform="cpu")),
        tparser.parse_query(BLOWUP))
    want = jfact.factorized_result(JaxEngine(jcat, JaxConfig.from_env()),
                                   jparser.parse_query(BLOWUP)).line()
    assert res.line() == want == jfact.execute_query_factorized_np(
        jparser.parse_query(BLOWUP), jcat)


def test_factorized_result_wraparound():
    """Sums past 2^64 and a count that is 0 mod 2^64: int64 cumsum, mul
    and sum wrap; NULL follows the exact exists flag, not the count."""
    tcat, jcat = _both(_wrap_columns())
    text = "0 1|0.0=1.0|0.1 1.1"
    res = tfact.factorized_result(
        TorchEngine(tcat, EngineConfig(platform="cpu")),
        tparser.parse_query(text))
    assert res.line() == joracle.execute_query_numpy(
        jparser.parse_query(text), jcat)
    # 2^16 rows of one key in 4 relations: the result has 2^64 tuples, so
    # the wrapped count is 0 and every checksum is 0 mod 2^64 — not NULL
    col = np.full(1 << 16, 3, np.uint64)
    tcat, _ = _both([[col, col] for _ in range(4)])
    q = tparser.parse_query("0 1 2 3|0.0=1.0&1.0=2.0&2.0=3.0|0.1 3.1")
    res = tfact.factorized_result(
        TorchEngine(tcat, EngineConfig(platform="cpu")), q)
    assert res.packed.tolist() == [1, 0, 0]
    assert res.line() == "0 0" == tfact.execute_query_factorized_np(q, tcat)


@pytest.mark.parametrize("text", [
    "0 1|0.0=1.0|0.2 1.2",
    "0 1 2|0.0=1.1&1.0=2.0|0.2 2.2 1.2",
    "0 1 2|0.1=1.0&1.1=2.1&0.0=18446744073709551615|2.2 0.2",
    "0 0 2|0.0=1.1&1.0=2.0&2.1>5|1.2",
])
def test_live_max_key_stays_exact(text):
    tcat, jcat = _both(_maxkey_columns())
    teng = TorchEngine(tcat, EngineConfig(platform="cpu"))
    tq, jq = tparser.parse_query(text), jparser.parse_query(text)
    want = joracle.execute_query_numpy(jq, jcat)
    assert want.split()[0] != "NULL"
    assert tfact.factorized_result(teng, tq).line() == want
    assert tfact.execute_query_factorized_np(tq, tcat) == want
    assert jfact.factorized_result(JaxEngine(jcat, JaxConfig.from_env()),
                                   jq).line() == want


def test_edge_cache_key_holds_both_ends(engines):
    """Relation 1 bound three times: one base column is the sender of one
    edge and the receiver of another, so a key of the sender alone would
    hand an edge the other's ranks."""
    _, _, tcat, _ = engines
    teng = TorchEngine(tcat, EngineConfig(platform="cpu"))
    for text in THRICE:
        q = tparser.parse_query(text)
        assert (tfact.factorized_result(teng, q).line()
                == toracle.execute_query_numpy(q, tcat))
    keys = set(teng._edge_ranks)
    assert all(len(k) == 4 for k in keys)
    senders = {k[:2] for k in keys}
    assert len(keys) > len(senders)  # a sender column serves two edges
    assert senders & {k[2:] for k in keys}  # a column on both ends
    # a second run takes every artifact from the cache
    hits = dict(teng._edge_ranks)
    tfact.factorized_result(teng, tparser.parse_query(THRICE[0]))
    assert all(teng._edge_ranks[k] is v for k, v in hits.items())


@pytest.mark.parametrize("text", [FOREST_QUERIES[2], FOREST_QUERIES[9],
                                  THRICE[1]])
def test_factorized_result_makes_no_host_sync(engines, monkeypatch, text):
    """Between its entry and the returned PendingResult nothing reads a
    tensor back: no item / tolist / cpu / numpy and no Python bool, int
    or index of a tensor."""
    _, _, tcat, _ = engines
    teng = TorchEngine(tcat, EngineConfig(platform="cpu"))
    teng.prefetch()
    q = tparser.parse_query(text)
    want = toracle.execute_query_numpy(q, tcat)
    syncs = []
    with monkeypatch.context() as m:
        for name in ("item", "tolist", "cpu", "numpy", "__bool__",
                     "__int__", "__index__", "__float__"):
            m.setattr(torch.Tensor, name,
                      lambda self, *a, _n=name, **k: syncs.append(_n) or 1)
        res = tfact.factorized_result(teng, q)
    assert syncs == []
    assert res.line() == want


# ---- frontend/sql.py -----------------------------------------------------


@pytest.mark.parametrize(
    "text", FOREST_QUERIES + THRICE + [TRIANGLE, DUPLICATE_PAIR])
def test_query_to_sql_matches(text):
    got = query_to_sql(tparser.parse_query(text))
    assert got == jax_query_to_sql(jparser.parse_query(text))
    assert got.startswith("SELECT SUM(") and got.endswith(";")
