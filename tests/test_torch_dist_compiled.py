"""The port's whole-query engine on a mesh
(sigmod2018_tpu_torch/parallel/dist_compiled.py) held against the JAX
package's DistCompiledEngine (vault off) on the 8-device virtual CPU mesh
of tests/conftest.py, the port on CPU meshes of the same sizes, and both
against the NumPy oracle.  Per query the packed result vector
[t.., m.., x.., count, sums..] and the line are equal; per engine the
join strategies, the communication model (bytes_ici included) and the
learned lists [k, classes.., xcaps..].  Configurations: meshes of 8 and
4 shards, the ring exchange against the all_to_all, broadcast on and
off, speculation off, Zipf keys (skew splits and speculative misses),
learned exchange caps shrinking the buffers and an undersized cap
retried.  The collectives each strategy calls stand in for the JAX
tests' checks of the compiled HLO.

Beside those: the reference's learned-class fault on a blow-up text and
the port's guard against it, the protocol driver with S18_MESH=4 line
for line against the JAX package's, the engine the driver picks, the
mesh switches, the topology helpers and the env contract of multi-process
bring-up."""

import contextlib
import io
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from sigmod2018_tpu.config import EngineConfig as JaxConfig
from sigmod2018_tpu.engine.oracle import execute_query_numpy
from sigmod2018_tpu.frontend.parser import parse_query as jparse
from sigmod2018_tpu.io.repl import run_protocol as jax_run_protocol
from sigmod2018_tpu.parallel import make_mesh as jax_make_mesh
from sigmod2018_tpu.parallel.dist_compiled import DistCompiledEngine
from sigmod2018_tpu.storage.catalog import Catalog as JaxCatalog
from sigmod2018_tpu.storage.relation import Relation as JaxRelation
from sigmod2018_tpu_torch import parallel as tpar
from sigmod2018_tpu_torch.config import EngineConfig
from sigmod2018_tpu_torch.engine import executor as texec
from sigmod2018_tpu_torch.engine.factorized import execute_query_factorized_np
from sigmod2018_tpu_torch.frontend.parser import parse_query as tparse
from sigmod2018_tpu_torch.io.repl import run_protocol
from sigmod2018_tpu_torch.ops import ms_join
from sigmod2018_tpu_torch.parallel import collectives, dist as tdist
from sigmod2018_tpu_torch.parallel import dist_compiled
from sigmod2018_tpu_torch.parallel.dist_compiled import (
    DistCompiledTorchEngine)
from sigmod2018_tpu_torch.storage.catalog import Catalog
from sigmod2018_tpu_torch.storage.relation import Relation, store_relation
from sigmod2018_tpu_torch.utils.padding import size_class

N_DEV = 8
_MASK64 = (1 << 64) - 1

QUERIES = [
    "0 1|0.0=1.0|0.1 1.2",                        # single join -> fused
    "0 1|0.0=1.0&0.1>20|0.1 1.2",                 # filter + fused join
    "0 1 2|0.0=1.0&1.1=2.1|0.2 1.0 2.2",          # chain: shuffle + fused
    "0 1 2|0.0=1.0&1.1=2.1&0.1=1.2|0.2 2.2",      # cycle edge (selection)
    "0 1|0.0=1.0&0.0>100|0.0 1.1",                # empty -> NULL
    "0 0|0.0=1.1|0.2 1.0",                        # same relation twice
    "0 1 2 3|0.0=1.0&1.1=2.1&2.2=3.0|3.1 0.1",    # 4-relation chain
    "0|0.0=0.1|0.2",                              # self-join only
    "2|0.0>5|0.1",                                # filter only
]
CHAIN = "0 1 2|0.0=1.0&1.1=2.1|0.2 1.0 2.2"


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < N_DEV:
        pytest.skip(f"need {N_DEV} JAX devices")
    return {n: (jax_make_mesh(n), tpar.make_mesh(n, "cpu")) for n in (8, 4)}


def _catalogs(cols):
    return (JaxCatalog([JaxRelation(columns=c) for c in cols]),
            Catalog([Relation(columns=c) for c in cols]))


@pytest.fixture(scope="module")
def catalogs():
    rng = np.random.default_rng(31)
    return _catalogs([[rng.integers(0, 60, size=n).astype(np.uint64)
                       for _ in range(3)] for n in (700, 450, 230, 120)])


def _skewed_cols(n=4096, dom=40):
    """A small key domain: per-destination sends far below a shard's
    length, so learned caps shrink the exchange."""
    rng = np.random.default_rng(77)
    return [[rng.integers(0, dom, n).astype(np.uint64),
             rng.integers(0, 1 << 30, n).astype(np.uint64),
             rng.integers(0, 1 << 30, n).astype(np.uint64)]
            for _ in range(3)]


def _zipf_cols(n=4096, hot_frac=0.5, hot_key=7):
    """Key column 0 with one heavy hitter holding hot_frac of the rows,
    a uniform medium-domain column 1 and a wide value column 2."""
    rng = np.random.default_rng(99)

    def keycol(n):
        k = rng.integers(100, 5000, n).astype(np.uint64)
        k[rng.choice(n, int(n * hot_frac), replace=False)] = hot_key
        return k

    return [[keycol(n), rng.integers(0, 500, n).astype(np.uint64),
             rng.integers(0, 1 << 30, n).astype(np.uint64)]
            for _ in range(3)]


def _engines(meshes, cats, ndev=N_DEV, **cfg):
    jm, tm = meshes[ndev]
    jcat, tcat = cats
    return (DistCompiledEngine(jcat, JaxConfig(vault=False, **cfg), mesh=jm),
            DistCompiledTorchEngine(tcat, EngineConfig(platform="cpu", **cfg),
                                    mesh=tm))


def _packed(res):
    p = getattr(res, "packed", None)
    if p is None:
        return None
    vals = p.tolist() if isinstance(p, torch.Tensor) else np.asarray(
        p).tolist()
    return [int(v) & _MASK64 for v in vals]


def _run_both(jeng, teng, texts, jcat, want=None):
    """Each text through both engines: equal packed vectors, and lines
    equal to each other and to the oracle's (or `want`)."""
    for i, text in enumerate(texts):
        jr = jeng.execute_async(jparse(text))
        tr = teng.execute_async(tparse(text))
        assert _packed(jr) == _packed(tr), text
        line = (want[i] if want is not None
                else execute_query_numpy(jparse(text), jcat))
        assert jr.line() == line, text
        assert tr.line() == line, text


def _learned(jeng):
    return {k: tuple(v) for k, v in jeng._learned_cache().items()}


def _by_join(v):
    """A learned list [k, classes.., caps..] with each join's pair of
    caps as a set: the reference keeps them per (build, probe) slot, the
    port per (left, right) side of the predicate."""
    k = v[0]
    caps = v[1 + k:]
    return tuple(v[:1 + k]) + tuple(tuple(sorted(caps[i:i + 2]))
                                    for i in range(0, len(caps), 2))


def _assert_same_records(jeng, teng):
    assert teng.join_strategies == jeng.join_strategies
    assert teng.comm_model == jeng.comm_model
    _assert_same_learned(jeng, teng)


def _assert_same_learned(jeng, teng):
    jl = _learned(jeng)
    assert teng._learned_classes.keys() == jl.keys()
    for text, v in teng._learned_classes.items():
        assert _by_join(v) == _by_join(jl[text]), text


@pytest.mark.parametrize("ndev,cfg,runs,texts", [
    (8, {}, 2, QUERIES), (8, dict(speculate=False), 1, QUERIES),
    (4, {}, 2, QUERIES),
    (8, dict(exchange="ring", bcast_threshold=0), 1, QUERIES[:5]),
    (8, dict(bcast_threshold=0), 1, QUERIES),
], ids=["mesh8", "no-speculation", "mesh4", "ring", "a2a-no-bcast"])
def test_matches_jax(meshes, catalogs, ndev, cfg, runs, texts):
    """The batch, run twice where the second run is sized from learned
    classes and caps (the JAX ring programs are slow to compile: five
    texts there)."""
    jeng, teng = _engines(meshes, catalogs, ndev, **cfg)
    for _ in range(runs):
        _run_both(jeng, teng, texts, catalogs[0])
    _assert_same_records(jeng, teng)
    assert teng.tiers == dict(dict.fromkeys(texec.TIERS, 0),
                              materialized=runs * len(texts))
    strategies = set(teng.join_strategies)
    if cfg.get("bcast_threshold") == 0:
        assert strategies == {"shuffle"}
    else:  # shards of 128 rows or less: every build side broadcasts
        assert "broadcast" in strategies <= {"shuffle", "broadcast"}
    if not cfg.get("speculate", True):
        assert teng.counts["learned"] == teng.counts["guessed"] == 0
    elif runs == 2:
        assert teng.counts["learned"] > 0 and teng.counts["retried"] == 0


def test_broadcast_join_chosen_for_small_build(meshes, catalogs):
    jeng, teng = _engines(meshes, catalogs, bcast_threshold=1 << 14)
    _run_both(jeng, teng, ["0 3|0.0=1.0|0.1 1.1"], catalogs[0])
    _assert_same_records(jeng, teng)
    assert "broadcast" in teng.join_strategies


def test_shuffle_join_chosen_for_large_build(meshes, catalogs):
    jeng, teng = _engines(meshes, catalogs, bcast_threshold=0)
    _run_both(jeng, teng, ["0 1|0.0=1.0|0.1 1.2"], catalogs[0])
    _assert_same_records(jeng, teng)
    assert teng.join_strategies == ["shuffle"]


@pytest.mark.parametrize("cols,cfg,text,called,not_called", [
    ("uniform", dict(bcast_threshold=0), CHAIN, ("all_to_all", "psum",
                                                 "pmax"),
     ("ppermute", "all_gather")),
    ("uniform", dict(bcast_threshold=0, exchange="ring"), CHAIN,
     ("ppermute",), ("all_to_all", "all_gather")),
    ("uniform", dict(bcast_threshold=1 << 14), "0 3|0.0=1.0|0.1 1.1",
     ("all_gather",), ("all_to_all", "ppermute")),
    ("zipf", dict(bcast_threshold=0), "0 1|0.0=1.0|0.1 1.1",
     ("all_gather", "all_to_all"), ("ppermute",)),
], ids=["shuffle", "ring", "broadcast", "skew"])
def test_collectives_of_each_strategy(meshes, catalogs, cols, cfg, text,
                                      called, not_called):
    """The counterpart of the JAX tests' HLO checks: the collectives the
    engine calls are the ones its strategy writes and no others."""
    cats = catalogs if cols == "uniform" else _catalogs(_zipf_cols())
    _, teng = _engines(meshes, cats, **cfg)
    collectives.reset_calls()
    assert teng.execute(tparse(text)) == execute_query_numpy(jparse(text),
                                                             cats[0])
    assert all(collectives.CALLS[k] > 0 for k in called), collectives.CALLS
    assert all(collectives.CALLS[k] == 0 for k in not_called), (
        collectives.CALLS)


@pytest.mark.parametrize("low_estimates", [False, True])
def test_zipf_skew_retry_stays_exact(meshes, monkeypatch, low_estimates):
    """Zipf keys; with the estimates forced to 1 the guessed per-shard
    classes are passed, the pmax check catches it, and the retry is
    exact.  What is learned equals JAX's."""
    import sigmod2018_tpu.planner.join_order as jorder

    if low_estimates:
        for mod in (jorder, dist_compiled):
            monkeypatch.setattr(mod, "estimate_cardinalities",
                                lambda q, cat, joins: [1] * len(joins))
    rng = np.random.default_rng(41)
    n = 2048
    zipf = lambda: np.minimum(rng.zipf(1.3, size=n), 500).astype(np.uint64)
    cols = [[zipf(), rng.integers(0, 1 << 30, size=n).astype(np.uint64)],
            [zipf(), rng.integers(0, 1 << 30, size=n).astype(np.uint64)],
            [rng.integers(0, 500, size=512).astype(np.uint64),
             rng.integers(0, 1 << 30, size=512).astype(np.uint64)]]
    cats = _catalogs(cols)
    jeng, teng = _engines(meshes, cats, max_intermediate=1 << 24,
                          bcast_threshold=0)
    texts = ["0 1|0.0=1.0|0.1 1.1", "0 1 2|0.0=1.0&1.0=2.0|0.1 2.1"]
    for _ in range(2):
        _run_both(jeng, teng, texts, cats[0])
    _assert_same_records(jeng, teng)
    assert (teng.counts["guessed"], teng.counts["learned"],
            teng.counts["retried"]) == (1, 1, int(low_estimates))
    assert teng.counts["segment_reads"] == int(low_estimates)


def test_hier_mesh_topology():
    """hier_mesh / flat_mesh_dcn_last group the devices host-major, as
    the JAX package's do (one process, fake host groups)."""
    from sigmod2018_tpu.parallel import (flat_mesh_dcn_last as jflat,
                                         hier_mesh as jhier)

    devs = [torch.device("cuda", i) for i in range(N_DEV)]
    hm = tpar.hier_mesh(devs, fake_hosts=2)
    jhm = jhier(fake_hosts=2)
    assert hm.devices.shape == jhm.devices.shape == (2, N_DEV // 2)
    assert hm.axis_names == jhm.axis_names == ("host", "chip")
    fm = tpar.flat_mesh_dcn_last(devs, fake_hosts=2)
    jfm = jflat(fake_hosts=2)
    assert fm.axis_names == jfm.axis_names == (tpar.AXIS,)
    assert [d.index for d in fm.flat] == [d.id for d in
                                          jfm.devices.reshape(-1)]
    assert fm.flat[:N_DEV // 2] == list(hm.devices[0])
    assert tpar.hier_mesh(devs).devices.shape == (1, N_DEV)
    with pytest.raises(ValueError, match="divisible"):
        tpar.hier_mesh(devs, fake_hosts=3)


def test_init_distributed(monkeypatch):
    """The JAX package's env contract.  No S18_COORD_ADDR: the
    single-process no-op of both packages.  With it, S18_NUM_PROCS and
    S18_PROC_ID must be there and in range, and S18_MESH a multiple of
    the ranks; each error names its variable, in init_distributed and
    in EngineConfig.from_env, before any group is joined.  The group
    itself runs in tests/test_torch_multiprocess.py."""
    from sigmod2018_tpu.parallel import init_distributed as jinit

    for k in ("S18_COORD_ADDR", "S18_NUM_PROCS", "S18_PROC_ID", "S18_MESH"):
        monkeypatch.delenv(k, raising=False)
    assert tpar.init_distributed() is False is jinit()
    monkeypatch.setenv("S18_COORD_ADDR", "localhost:1234")
    for procs, rank, name in ((None, "0", "S18_NUM_PROCS"),
                              ("2", None, "S18_PROC_ID"),
                              ("two", "0", "S18_NUM_PROCS"),
                              ("2", "2", "S18_PROC_ID"),
                              ("2", "-1", "S18_PROC_ID"),
                              ("0", "0", "S18_NUM_PROCS")):
        for k, v in (("S18_NUM_PROCS", procs), ("S18_PROC_ID", rank)):
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        with pytest.raises(ValueError, match=name):
            tpar.init_distributed()
        with pytest.raises(ValueError, match=name):
            EngineConfig.from_env()
    monkeypatch.setenv("S18_NUM_PROCS", "2")
    monkeypatch.setenv("S18_PROC_ID", "1")
    monkeypatch.setenv("S18_MESH", "6")
    assert EngineConfig.from_env() == EngineConfig(mesh_devices=6)
    monkeypatch.setenv("S18_MESH", "3")
    with pytest.raises(ValueError, match="S18_MESH=3.*S18_NUM_PROCS=2"):
        EngineConfig.from_env()


@pytest.fixture
def a2a_widths(monkeypatch):
    """The per-destination widths of every all_to_all operand."""
    widths = []
    real = tdist.all_to_all

    def a2a(mesh, xs):
        widths.append(xs[0].shape[1] if xs[0].dim() == 2 else None)
        return real(mesh, xs)

    monkeypatch.setattr(tdist, "all_to_all", a2a)
    return widths


def test_learned_exchange_caps_shrink_buffers(meshes, a2a_widths):
    """After one run the engine learns per-join exchange caps (0, the
    full length, for a side that sent nothing); the next run's send
    buffers have the learned widths, far under a shard's length."""
    cats = _catalogs(_skewed_cols())
    jeng, teng = _engines(meshes, cats, bcast_threshold=0)
    _run_both(jeng, teng, [CHAIN], cats[0])
    learned, xcaps = teng._learned_dist(tparse(CHAIN), 1, 4)
    assert _by_join((1,) + learned + xcaps) == _by_join(_learned(jeng)[CHAIN])
    assert sum(1 for c in xcaps if c > 0) >= 3, xcaps
    L = 4096 // N_DEV
    assert all(c < L for c in xcaps), xcaps
    assert L in a2a_widths  # the first run sent at full length
    del a2a_widths[:]
    _run_both(jeng, teng, [CHAIN], cats[0])
    keys = [w for w in a2a_widths if w not in (None, 1)]
    assert keys and max(keys) <= max(xcaps), (keys, xcaps)
    _assert_same_records(jeng, teng)


def test_undersized_exchange_cap_retries_exactly(meshes):
    """A learned cap the data outgrew truncates the send buffers; the
    packed send maxima show it and the retry is exact."""
    cats = _catalogs(_skewed_cols())
    jeng, teng = _engines(meshes, cats, bcast_threshold=0)
    _run_both(jeng, teng, [CHAIN], cats[0])
    learned, xcaps = teng._learned_dist(tparse(CHAIN), 1, 4)
    jeng._learn_dist(CHAIN, learned, (2,) * len(xcaps))
    teng._learn_dist(CHAIN, learned, (2,) * len(xcaps))
    _run_both(jeng, teng, [CHAIN], cats[0])
    assert teng.counts["retried"] == 1
    # CHAIN's intermediate join is empty, so the retry learns nothing:
    # the reference keeps the maxima it recorded from the line that
    # missed; the port, which learns only lines that hold, drops the
    # values that missed and learns the next run's
    assert CHAIN not in teng._learned_classes
    assert _learned(jeng)[CHAIN][2:] != (2, 2, 2, 2)
    _run_both(jeng, teng, [CHAIN], cats[0])
    assert teng.counts["retried"] == 1
    _assert_same_learned(jeng, teng)


def test_comm_model_pins_bytes(meshes):
    """The modeled bytes of each join equal JAX's and the volume of the
    chosen strategy, and learned caps shrink them on the next run."""
    cats = _catalogs(_skewed_cols())
    jeng, teng = _engines(meshes, cats, bcast_threshold=0)
    _run_both(jeng, teng, [CHAIN], cats[0])
    shuffles = [e for e in teng.comm_model if e["strategy"] == "shuffle"]
    assert shuffles
    per_side = lambda cap, npay: N_DEV * (N_DEV - 1) * cap * 8 * (1 + npay)
    for e in shuffles:
        assert e["bytes_ici"] == (per_side(e["cap_b"], e["npay_b"])
                                  + per_side(e["cap_p"], e["npay_p"]))
    before = sum(e["bytes_ici"] for e in shuffles)
    _run_both(jeng, teng, [CHAIN], cats[0])
    after = [e["bytes_ici"] for e in teng.comm_model[len(shuffles):]]
    assert after and sum(after) < before
    _assert_same_records(jeng, teng)
    jeng2, teng2 = _engines(meshes, cats, bcast_threshold=1 << 20)
    _run_both(jeng2, teng2, [CHAIN], cats[0])
    _assert_same_records(jeng2, teng2)
    bcasts = [e for e in teng2.comm_model if e["strategy"] == "broadcast"]
    assert bcasts
    for e in bcasts:
        assert e["bytes_ici"] == N_DEV * (N_DEV - 1) * (
            e["L_b"] * 8 * (1 + e["npay_b"]) + e["L_b"])


@pytest.mark.parametrize("n,hot_frac,text", [
    (4096, 0.5, "0 1|0.0=1.0|0.1 1.1"),              # fused
    (1024, 0.25, "0 1 2|0.0=1.0&1.1=2.1|0.2 2.2"),   # intermediate
    (4096, 0.5, "0 1|0.0=1.0&1.1>100000|0.2 1.2"),   # after a filter
], ids=["fused", "intermediate", "filter"])
def test_skew_split_exact(meshes, n, hot_frac, text):
    cats = _catalogs(_zipf_cols(n, hot_frac))
    jeng, teng = _engines(meshes, cats, bcast_threshold=0)
    for _ in range(2):
        _run_both(jeng, teng, [text], cats[0])
    _assert_same_records(jeng, teng)
    assert "skew" in teng.join_strategies
    assert [e["hot_cap"] for e in teng.comm_model
            if e["strategy"] == "skew"][0] > 0


def test_skew_split_gathers_hot_rows(meshes, monkeypatch):
    """The skew join all_gathers [hot_cap] hot rows per shard beside the
    cold all_to_all; with S18_SKEW=0 the same join is a plain shuffle
    that gathers nothing."""
    cats = _catalogs(_zipf_cols())
    gathered = []
    real = dist_compiled.all_gather

    def gather(mesh, xs):
        gathered.append(tuple(xs[0].shape))
        return real(mesh, xs)

    monkeypatch.setattr(dist_compiled, "all_gather", gather)
    text = "0 1|0.0=1.0|0.1 1.1"
    _, teng = _engines(meshes, cats, bcast_threshold=0)
    assert teng.execute(tparse(text)) == execute_query_numpy(jparse(text),
                                                             cats[0])
    hot_cap = teng.comm_model[0]["hot_cap"]
    assert (hot_cap,) in gathered
    del gathered[:]
    jeng0, teng0 = _engines(meshes, cats, bcast_threshold=0, skew_factor=0)
    _run_both(jeng0, teng0, [text], cats[0])
    assert teng0.join_strategies == jeng0.join_strategies == ["shuffle"]
    assert not gathered


def test_skew_split_uniform_keys_not_chosen(meshes, catalogs):
    jeng, teng = _engines(meshes, catalogs, bcast_threshold=0)
    _run_both(jeng, teng, ["0 1|0.0=1.0|0.1 1.2"], catalogs[0])
    assert "skew" not in teng.join_strategies
    _assert_same_records(jeng, teng)


def test_explain_comm_lines_match_jax(meshes):
    """Under S18_EXPLAIN the `--   comm join..` lines are JAX's."""
    cats = _catalogs(_zipf_cols(1024, 0.25))
    jeng, teng = _engines(meshes, cats, bcast_threshold=0, explain=True)
    text = "0 1 2|0.0=1.0&1.1=2.1|0.2 2.2"
    got = []
    for eng, parse in ((jeng, jparse), (teng, tparse)):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            eng.execute(parse(text))
        got.append([ln for ln in err.getvalue().splitlines()
                    if ln.startswith("--   comm join")])
    assert got[0] and got[0] == got[1]


def _write(directory, cols):
    directory.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, c in enumerate(cols):
        paths.append(str(directory / f"r{i}"))
        store_relation(Relation(columns=c), paths[-1])
    return paths


def test_blowup_line_never_learned(meshes, tmp_path, monkeypatch):
    """The reference records a speculative line's per-chip maxima before
    it checks max_intermediate (DistSpecResult.line_from), so a blow-up
    text is learned at a class past the guard's.  The port learns only
    lines that hold: a fresh engine on the same prep cache never sizes a
    join past size_class(max_intermediate) before the blow-up net
    answers, and a class taught without the guard is not used."""
    cols = _skewed_cols(n=1024)
    paths = _write(tmp_path / "rels", cols)
    text = "0 1 2|0.0=1.0&1.0=2.0|0.1 2.1"
    jcat = JaxCatalog.from_files(paths)
    want = execute_query_factorized_np(tparse(text), Catalog(
        [Relation(columns=c) for c in cols]))
    jm, tm = meshes[N_DEV]
    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path / "jax"))
    jeng = DistCompiledEngine(jcat, JaxConfig(vault=False,
                                              max_intermediate=2000),
                              mesh=jm)
    assert jeng.execute(jparse(text)) == want
    guard_class = size_class(2000)
    assert jeng._learned_cache()[text][1] > guard_class  # the fault
    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path / "port"))
    teach = DistCompiledTorchEngine(Catalog.from_files(paths),
                                    EngineConfig(platform="cpu"), mesh=tm)
    assert teach.execute(tparse(text)) == want
    assert teach._learned_classes[text][1] > guard_class
    emitted, in_net = [], []
    real_emit = dist_compiled.ops.join_emit
    real_net = DistCompiledTorchEngine._blowup_net

    def emit(*a, out_size, **kw):
        if not in_net:
            emitted.append(out_size)
        return real_emit(*a, out_size=out_size, **kw)

    def net(self, query):
        in_net.append(query)
        try:
            return real_net(self, query)
        finally:
            in_net.pop()

    monkeypatch.setattr(dist_compiled.ops, "join_emit", emit)
    monkeypatch.setattr(DistCompiledTorchEngine, "_blowup_net", net)
    for _ in range(2):  # one engine, then a fresh one on the same cache
        eng = DistCompiledTorchEngine(
            Catalog.from_files(paths),
            EngineConfig(platform="cpu", max_intermediate=2000), mesh=tm)
        for run in (1, 2):
            assert eng.execute(tparse(text)) == want
            assert eng.tiers["factorized_blowup"] == run
            assert eng.counts["retried"] == run
    assert emitted and max(emitted) <= guard_class, emitted
    assert teach._learned_path.endswith(f"-mesh{N_DEV}.json")
    assert eng._learned_classes[text] == teach._learned_classes[text]


def test_learned_caps_follow_the_join_side(meshes, tmp_path):
    """The build side is the narrower one, and a component is as wide as
    its size class: here the guessed class makes the intermediate wider
    than relation 2's shard, the learned class narrower, so the second
    run swaps the last join's sides.  The reference learns its caps per
    (build, probe) slot, and its second run misses and retries (reading
    a total); the port learns them per side of the predicate, and its
    second run holds."""
    rng = np.random.default_rng(5)
    cols = [[rng.integers(0, 2048, n).astype(np.uint64),
             rng.integers(0, 64, n).astype(np.uint64),
             rng.integers(0, 1 << 30, n).astype(np.uint64)]
            for n in (4096, 4096, 16384)]
    cats = _catalogs(cols)
    text = "0 1 2|0.0=1.0&1.1=2.1|0.2 2.2"
    jeng, teng = _engines(meshes, cats, bcast_threshold=0)
    jreads = []
    real = jeng._run_incremental_spmd

    def incremental(*a, **kw):
        jreads.append(a[0].text)
        return real(*a, **kw)

    jeng._run_incremental_spmd = incremental
    built = []
    for _ in range(2):
        res = teng.execute_async(tparse(text))
        built.append(res.build_left)
        jr = jeng.execute_async(jparse(text))
        want = execute_query_numpy(jparse(text), cats[0])
        assert res.line() == jr.line() == want
    assert built[0] != built[1]  # the learned class swapped the sides
    assert teng.counts["retried"] == teng.counts["segment_reads"] == 0
    assert jreads == [text]  # the reference's second run retried


def test_factorized_tier_on_mesh(meshes):
    """The factorized tier serves first, on whole columns, when JAX's
    does; the tier counts add up to the queries."""
    cats = _catalogs(_skewed_cols(n=1024))
    texts = ["0 1 2|0.0=1.0&1.0=2.0|0.1 2.1", CHAIN]
    jeng, teng = _engines(meshes, cats, factorize_min=1 << 12)
    want = [execute_query_factorized_np(tparse(t), cats[1]) for t in texts]
    decided = [jeng._maybe_factorized(jparse(t)) is not None for t in texts]
    assert decided == [True, False]
    _run_both(jeng, teng, texts, cats[0], want=want)
    assert teng.tiers == dict(dict.fromkeys(texec.TIERS, 0),
                              factorized_proactive=1, materialized=1)


def test_k1_serves_large_shards(meshes, monkeypatch):
    """An intermediate join whose shards reach ms_join.EMIT_MS_MIN_ROWS
    padded rows goes through the staircase member (K1 on a card, its
    plain twin here)."""
    monkeypatch.setattr(ms_join, "EMIT_MS_MIN_ROWS", 256)
    calls = []
    real = ms_join.join_probe_count_ms

    def count(*a):
        calls.append(a[0].shape[0])
        return real(*a)

    monkeypatch.setattr(ms_join, "join_probe_count_ms", count)
    cats = _catalogs(_skewed_cols(n=2048))
    jeng, teng = _engines(meshes, cats, bcast_threshold=0)
    _run_both(jeng, teng, [CHAIN], cats[0])
    assert calls and len(calls) % N_DEV == 0


def _stream(paths, texts):
    return io.StringIO("\n".join(list(paths) + ["Done"] + texts + ["F"])
                       + "\n")


def test_run_protocol_mesh4_matches_jax(catalogs, tmp_path, monkeypatch):
    """S18_MESH=4 through the protocol driver, line for line against the
    JAX package's driver on the same files and switch."""
    rng = np.random.default_rng(31)
    cols = [[rng.integers(0, 60, size=n).astype(np.uint64)
             for _ in range(3)] for n in (700, 450, 230, 120)]
    paths = _write(tmp_path / "rels", cols)
    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path / "cache"))
    jout = io.StringIO()
    jax_run_protocol(_stream(paths, QUERIES), jout,
                     JaxConfig(vault=False, mesh_devices=4))
    for k, v in (("S18_MESH", "4"), ("S18_PLATFORM", "cpu")):
        monkeypatch.setenv(k, v)
    out = io.StringIO()
    tiers = run_protocol(_stream(paths, QUERIES), out)
    assert out.getvalue().splitlines() == jout.getvalue().splitlines()
    assert sum(tiers.values()) == len(QUERIES)


@pytest.mark.parametrize("env,engine", [
    ({"S18_MESH": "4"}, "DistCompiledTorchEngine"),
    ({"S18_MESH": "4", "S18_COMPILE_QUERIES": "0"}, "DistTorchEngine"),
    ({"S18_MESH": "4", "S18_TRACE": "json"}, "DistTorchEngine"),
    ({"S18_MESH": "4", "S18_BACKEND": "numpy"}, "OracleEngine"),
    ({"S18_MESH": "1"}, "CompiledTorchEngine"),
])
def test_driver_engine_choice(catalogs, env, engine, monkeypatch):
    from sigmod2018_tpu_torch.io.repl import make_engine

    for k in ("S18_MESH", "S18_COMPILE_QUERIES", "S18_TRACE",
              "S18_BACKEND"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("S18_PLATFORM", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    eng = make_engine(catalogs[1], EngineConfig.from_env())
    assert type(eng).__name__ == engine
    if engine.startswith("Dist"):
        assert eng.mesh.size == 4
        assert eng.device == torch.device("cpu")


def test_mesh_switches(monkeypatch):
    """S18_MESH, S18_EXCHANGE, S18_BCAST and S18_SKEW: the JAX package's
    defaults, and a bad value raises."""
    jc, tc = JaxConfig(), EngineConfig()
    for f in ("mesh_devices", "exchange", "bcast_threshold", "skew_factor"):
        assert getattr(tc, f) == getattr(jc, f), f
    for k, v in (("S18_MESH", "4"), ("S18_EXCHANGE", "ring"),
                 ("S18_BCAST", "0"), ("S18_SKEW", "0")):
        monkeypatch.setenv(k, v)
    assert EngineConfig.from_env() == EngineConfig(
        mesh_devices=4, exchange="ring", bcast_threshold=0, skew_factor=0)
    for k, v in (("S18_EXCHANGE", "mesh"), ("S18_MESH", "0"),
                 ("S18_BCAST", "-1"), ("S18_SKEW", "-2")):
        monkeypatch.setenv(k, v)
        with pytest.raises(ValueError, match=k):
            EngineConfig.from_env()
        monkeypatch.setenv(k, {"S18_EXCHANGE": "a2a"}.get(k, "1"))


def test_no_card_raises(catalogs):
    """A mesh on "cuda" without a card raises; nothing runs on the CPU
    instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="S18_PLATFORM=cuda"):
        DistCompiledTorchEngine(catalogs[1], EngineConfig(mesh_devices=4))


def test_sharded_columns_built_once(catalogs):
    """Batch threads and the prefetch reach the sharded-column cache at
    once: each key is built one time, and every caller gets it."""
    eng = DistCompiledTorchEngine(catalogs[1], EngineConfig(platform="cpu"),
                                  mesh=tpar.make_mesh(N_DEV, "cpu"))
    builds = []
    real = dist_compiled.split_rows

    def split(col, m):
        builds.append(col.shape[0])
        return real(col, m)

    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        dist_compiled.split_rows = split
        threads = [threading.Thread(target=lambda c=c: got.append(
            eng.sharded_column(0, c % 3))) for c in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        dist_compiled.split_rows = real
        sys.setswitchinterval(old)
    assert len(builds) == 3 and len(got) == 24
    assert len({id(g) for g in got}) == 3
    shards, n = got[0]
    assert n == 700 and [s.shape[0] for s in shards] == [128] * N_DEV
