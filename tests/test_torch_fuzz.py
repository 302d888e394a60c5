"""The port's differential fuzz (sigmod2018_tpu_torch/tools/fuzz.py) held
against the JAX package on the CPU:

- `draw_case` replays the JAX fuzz body (tests/_fuzz_impl.py): the same
  relations and the same query texts for a seed;
- every text parses to the same IR under both parsers;
- the port's engine matrix (compiled, operator, compiled-nospec, and the
  repeat on the first engine) answers every text with the line of the
  JAX package's NumPy oracle: under auto, under the forced ms, radix and
  qd members (their plain twins on the CPU), and on an 8-shard CPU mesh;
- a wrong engine is reported, and the command line ends with the JAX
  body's summary line."""

import contextlib
import dataclasses
import io
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sigmod2018_tpu.engine import compiled as jcompiled
from sigmod2018_tpu.engine import executor as jexecutor
from sigmod2018_tpu.engine.oracle import execute_query_numpy as jax_oracle
from sigmod2018_tpu.frontend import parser as jparser
from sigmod2018_tpu.storage.catalog import Catalog as JaxCatalog
from sigmod2018_tpu.storage.relation import Relation as JaxRelation
from sigmod2018_tpu_torch.config import EngineConfig
from sigmod2018_tpu_torch.frontend import parser as tparser
from sigmod2018_tpu_torch.parallel import make_mesh
from sigmod2018_tpu_torch.tools import fuzz

ROOT = Path(__file__).resolve().parent.parent
SEED = 99
N = 30
N_FORCED = 10


@pytest.fixture(scope="module")
def case():
    """(relations, texts, port catalog, the JAX oracle's lines)."""
    rels, texts = fuzz.draw_case(SEED, N)
    jcat = JaxCatalog([JaxRelation(columns=list(cols)) for cols in rels])
    want = [jax_oracle(jparser.parse_query(t), jcat) for t in texts]
    return rels, texts, fuzz.catalog_of(rels), want


class _Recorder:
    """Stands in for the JAX body's engines: records each text it is
    asked and answers with the oracle."""

    texts = []
    catalogs = []

    def __init__(self, catalog, config=None, **kw):
        self.catalog = catalog
        _Recorder.catalogs.append(catalog)

    def execute(self, q):
        _Recorder.texts.append(q.text)
        return jax_oracle(q, self.catalog)


def test_draw_case_replays_the_jax_fuzz_body(monkeypatch):
    """The JAX body itself, run with recording engines, draws the
    relations and texts draw_case draws."""
    monkeypatch.setattr(jcompiled, "CompiledEngine", _Recorder)
    monkeypatch.setattr(jexecutor, "JaxEngine", _Recorder)
    monkeypatch.setattr(_Recorder, "texts", [])
    monkeypatch.setattr(_Recorder, "catalogs", [])
    monkeypatch.setattr(sys, "argv", ["_fuzz_impl.py", str(N), str(SEED)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(str(ROOT / "tests" / "_fuzz_impl.py"))
    assert out.getvalue().splitlines()[-1] == \
        f"{N} queries x 5 engines: 0 failures"
    rels, texts = fuzz.draw_case(SEED, N)
    # five engines, then the repeat on the first: six calls per text
    assert _Recorder.texts[::6] == texts
    jrels = _Recorder.catalogs[0].relations
    assert len(jrels) == len(rels) == 7
    for jrel, cols in zip(jrels, rels):
        assert len(jrel.columns) == len(cols) == 3
        for a, b in zip(jrel.columns, cols):
            assert a.dtype == b.dtype == np.uint64 and np.array_equal(a, b)


def test_relations_cover_big_values():
    rels, _ = fuzz.draw_case(SEED, 0)
    assert [len(r[0]) for r in rels] == [500, 350, 200, 120, 80, 150, 100]
    assert all(int(c.max()) < 50 for r in rels[:5] for c in r)
    for r, base in zip(rels[5:], (1 << 34, 1 << 22)):
        assert all(base <= int(c.min()) and int(c.max()) < base + 50
                   for c in r[:2])
        assert int(r[2].max()) < 50


def _ir(q):
    return (q.relations, [(type(p).__name__, dataclasses.astuple(p))
                          for p in q.predicates], q.views, q.text)


def test_texts_parse_to_the_same_ir(case):
    _, texts, _, _ = case
    for t in texts:
        assert _ir(tparser.parse_query(t)) == _ir(jparser.parse_query(t)), t


def _lines(engines, texts):
    """{engine name: [line per text]}, the repeat last, as fuzz.run
    runs them: every engine per text, then the first again."""
    got = {name: [] for name, _ in engines}
    got["repeat"] = []
    for t in texts:
        q = tparser.parse_query(t)
        for name, eng in engines:
            got[name].append(eng.execute(q))
        got["repeat"].append(engines[0][1].execute(q))
    return got


@pytest.mark.parametrize("join,count", [("auto", N), ("sort", N_FORCED),
                                        ("ms", N_FORCED),
                                        ("radix", N_FORCED),
                                        ("qd", N_FORCED)])
def test_engine_matrix_matches_jax_oracle(case, join, count):
    _, texts, tcat, want = case
    engines = fuzz.single_engines(tcat, EngineConfig(platform="cpu",
                                                     join_algo=join))
    assert [n for n, _ in engines] == ["compiled", "operator",
                                       "compiled-nospec"]
    for name, lines in _lines(engines, texts[:count]).items():
        assert lines == want[:count], name


def test_mesh_matrix_matches_jax_oracle(case):
    _, texts, tcat, want = case
    engines = fuzz.mesh_engines(tcat, EngineConfig(platform="cpu",
                                                   mesh_devices=8),
                                make_mesh(8, "cpu"))
    assert [n for n, _ in engines] == ["dist-compiled", "dist-operator",
                                       "dist-compiled-nospec"]
    assert all(eng.mesh.size == 8 for _, eng in engines)
    for name, lines in _lines(engines, texts).items():
        assert lines == want, name


def test_fuzz_reports_a_wrong_engine(monkeypatch, case):
    """An operator engine that answers one text wrong: one FAIL line and
    `1 failures` (the repeat runs on the compiled engine)."""
    _, texts, _, want = case
    real = fuzz.single_engines

    class Wrong:
        def __init__(self, eng):
            self.eng = eng

        def execute(self, q):
            line = self.eng.execute(q)
            return "0" if q.text == texts[1] else line

    def planted(catalog, config):
        engines = real(catalog, config)
        return [(n, Wrong(e) if n == "operator" else e) for n, e in engines]

    monkeypatch.setattr(fuzz, "single_engines", planted)
    out = io.StringIO()
    assert fuzz.run(3, SEED, platform="cpu", out=out) == 1
    lines = out.getvalue().splitlines()
    assert lines == [f"FAIL operator {texts[1]} got 0 want {want[1]}",
                     "3 queries x 3 engines: 1 failures"]


@pytest.mark.parametrize("argv,last", [
    (["30", "99", "--platform", "cpu"], "30 queries x 3 engines: 0 failures"),
    (["12", "99", "mesh", "--platform", "cpu"],
     "12 queries x 3 engines: 0 failures")])
def test_command_line(capsys, argv, last):
    assert fuzz.main(argv) == 0
    assert capsys.readouterr().out.splitlines()[-1] == last


def test_mesh_run_uses_the_shards_asked(monkeypatch):
    seen = []
    real = fuzz.mesh_engines

    def spy(catalog, config, mesh):
        seen.append((mesh.size, config.mesh_devices, config.join_algo))
        return real(catalog, config, mesh)

    monkeypatch.setattr(fuzz, "mesh_engines", spy)
    assert fuzz.run(2, SEED, platform="cpu", shards=3, join="ms",
                    out=io.StringIO()) == 0
    assert seen == [(3, 3, "ms")]


def test_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default platform runs")
    with pytest.raises(RuntimeError, match="cuda"):
        fuzz.run(1, SEED, out=io.StringIO())
    with pytest.raises(ValueError):
        fuzz.run(1, SEED, platform="cpu", join="hash", out=io.StringIO())
