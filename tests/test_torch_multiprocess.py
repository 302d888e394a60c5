"""Multi-process serving of the port on the CPU: W ranks in a
torch.distributed process group over gloo (parallel/multihost.py), each
owning its n/W shards of the mesh (parallel/mesh.py), the collectives
crossing processes (parallel/collectives.py).

- Each collective, with 2 and 4 processes of two shards each, against
  the one-process collectives on the same seeded numpy inputs, shard by
  shard: all_to_all (also of bools and of empty rows), all_gather, psum
  wrapping mod 2^64 and mod 2^32 near the ends of the range, pmax,
  ppermute with shards that receive nothing, the ring all_to_all; the
  calls counted per process as one process counts them; the host-major
  shard split and hier_mesh's rows; a one-process mesh under a group
  computing alone, and a mesh that is not the group's refused.
- `python -m sigmod2018_tpu_torch` as 2 processes on 4 shards and 4
  processes on 8, on a seeded catalog whose key columns are Zipf
  draws, under the all_to_all and the ring, broadcast on and off, a
  skew split, the operator engine: every rank's lines equal the JAX
  package's run_protocol on the 8-device virtual CPU mesh with the same
  S18_MESH and the NumPy oracle, the ranks' collective calls equal a
  one-process mesh's on the same protocol, and the join strategies the
  configuration exists for serve.
- The learned file of 2 processes equals a one-process S18_MESH=4 run's,
  rank 1 writes none, and a second 2-process run sized from rank 0's
  file retries nothing on either rank.
- S18_WORKERS=8 under a group answers in input order from one thread;
  the prefetch issues no collective, in one process and on both ranks
  of a group, for both mesh engines (so it keeps its thread), the warm
  replay does (so it runs before serving under a group).

Every group is real processes on a free port, each test bounded by
RANK_TIMEOUT_S: a rank that fails or hangs kills the others and fails
the test (parallel/launch.py)."""

import io
import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sigmod2018_tpu.config import EngineConfig as JaxConfig
from sigmod2018_tpu.engine.oracle import execute_query_numpy
from sigmod2018_tpu.frontend.parser import parse_query as jparse
from sigmod2018_tpu.io.repl import run_protocol as jax_run_protocol
from sigmod2018_tpu.storage.catalog import Catalog as JaxCatalog
from sigmod2018_tpu.storage.relation import Relation as JaxRelation
from sigmod2018_tpu_torch.config import EngineConfig
from sigmod2018_tpu_torch.io.repl import serve
from sigmod2018_tpu_torch.parallel import collectives, make_mesh
from sigmod2018_tpu_torch.parallel.mesh import Mesh
from sigmod2018_tpu_torch.parallel.dist_compiled import (
    DistCompiledTorchEngine)
from sigmod2018_tpu_torch.parallel.launch import RanksFailed, run_ranks
from sigmod2018_tpu_torch.storage.catalog import Catalog
from sigmod2018_tpu_torch.storage.relation import Relation, store_relation

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 90
_MASK64 = (1 << 64) - 1


def _env(**s18) -> dict:
    """A rank's environment: this one without its S18_* switches, the
    port on the CPU, one intra-op thread per rank."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("S18_")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               S18_PLATFORM="cpu")
    env.update({k: str(v) for k, v in s18.items()})
    return env


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------

# (name, collective, input, ppermute's pairs of global shards)
def _ops(n: int):
    return [("a2a", "all_to_all", "a2a", None),
            ("a2a bool", "all_to_all", "a2a_bool", None),
            ("a2a empty", "all_to_all", "a2a_empty", None),
            ("gather", "all_gather", "gather", None),
            ("gather bool", "all_gather", "gather_bool", None),
            ("psum wrap", "psum", "wrap64", None),
            ("psum int32", "psum", "wrap32", None),
            ("pmax", "pmax", "wrap64", None),
            # shard 0 (and on 8 shards 3..6) receives nothing
            ("ppermute", "ppermute", "perm",
             [(0, n - 1), (n - 1, 1), (1, 2)]),
            ("ring", "ring_all_to_all", "ring", None)]


def _inputs(n: int, seed: int = 5) -> dict:
    """Per-shard inputs of n shards (axis 0: the shard)."""
    rng = np.random.default_rng(seed)
    lo, hi = -(1 << 63), (1 << 63) - 1
    top = rng.integers(hi - (1 << 20), hi, (n, 2))
    bottom = rng.integers(lo, lo + (1 << 20), (n, 2))
    return {
        "a2a": rng.integers(lo, hi, (n, n, 3)),
        "a2a_bool": rng.random((n, n, 4)) < 0.5,
        "a2a_empty": np.zeros((n, n, 0), dtype=np.int64),
        "gather": rng.integers(lo, hi, (n, 5)),
        "gather_bool": rng.random((n, 6)) < 0.5,
        # sums near +-2^63 that wrap, and full-range ones
        "wrap64": np.concatenate([top, bottom,
                                  rng.integers(lo, hi, (n, 2))], axis=1),
        "wrap32": rng.integers((1 << 31) - 64, (1 << 31) - 1, (n, 3),
                               dtype=np.int32) * np.int32(-1) ** np.arange(
            3, dtype=np.int32),
        "perm": rng.integers(lo, hi, (n, 3, 2)),
        "ring": rng.integers(lo, hi, (n, n, 2, 3)),
    }


def _apply(kind: str, mesh, xs, perm):
    fn = getattr(collectives, kind)
    return fn(mesh, xs, perm) if perm is not None else fn(mesh, xs)


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_across_processes(world, tmp_path):
    n = 2 * world
    data = _inputs(n)
    np.savez(tmp_path / "in.npz", n=n, **data)
    ops = _ops(n)
    (tmp_path / "ops.json").write_text(json.dumps(ops))
    rank_code = (
        "import json, sys\n"
        "import numpy as np, torch\n"
        "from sigmod2018_tpu_torch.parallel import collectives as C\n"
        "from sigmod2018_tpu_torch.parallel import multihost\n"
        "from sigmod2018_tpu_torch.parallel.mesh import Mesh, make_mesh\n"
        "src = sys.argv[1]\n"
        "rank, world = multihost.init_distributed()\n"
        "data = np.load(src + '/in.npz')\n"
        "mesh = make_mesh(int(data['n']), 'cpu')\n"
        "hier = multihost.hier_mesh(mesh.flat)\n"
        "flat = multihost.flat_mesh_dcn_last(mesh.flat)\n"
        "out = {}\n"
        "for name, kind, key, perm in json.load(open(src + '/ops.json')):\n"
        "    xs = [torch.from_numpy(data[key][s]) for s in mesh.local]\n"
        "    fn = getattr(C, kind)\n"
        "    got = fn(mesh, xs, perm) if perm is not None else fn(mesh, xs)\n"
        "    out[name] = np.stack([g.numpy() for g in got])\n"
        "calls = dict(C.CALLS)\n"
        "# a mesh of one process under the group: every shard here, no\n"
        "# call of the group\n"
        "solo = Mesh(mesh.devices)\n"
        "whole = [torch.from_numpy(x) for x in data['wrap64']]\n"
        "out['solo psum'] = C.psum(solo, whole)[0].numpy()\n"
        "np.savez(f'{src}/rank{rank}.npz', **out)\n"
        "print(json.dumps(dict(rank=rank, world=world,\n"
        "    local=mesh.local, calls=calls, hier=list(hier.devices.shape),\n"
        "    hier_local=hier.local, flat_local=flat.local)))\n")
    outs = run_ranks([sys.executable, "-c", rank_code, str(tmp_path)],
                     world, _env(), "", RANK_TIMEOUT_S)
    collectives.reset_calls()
    one = make_mesh(n, "cpu")
    want = {name: _apply(kind, one,
                         [torch.from_numpy(x) for x in data[key]], perm)
            for name, kind, key, perm in ops}
    one_process_calls = dict(collectives.CALLS)
    assert one_process_calls["ppermute"] == 1 + (n - 1)
    for rank, (stdout, _) in enumerate(outs):
        rep = json.loads(stdout.splitlines()[-1])
        local = list(range(2 * rank, 2 * rank + 2))
        assert (rep["rank"], rep["world"], rep["local"]) == (rank, world,
                                                             local)
        assert rep["hier"] == [world, 2]
        assert rep["hier_local"] == rep["flat_local"] == local
        assert rep["calls"] == one_process_calls
        got = np.load(tmp_path / f"rank{rank}.npz")
        for name in want:
            for i, s in enumerate(local):
                ref = want[name][s].numpy()
                assert got[name][i].dtype == ref.dtype, name
                assert np.array_equal(got[name][i], ref), (name, s)
        assert np.array_equal(got["solo psum"], want["psum wrap"][0])
    # the wrap is real: the int64 sums passed the range
    exact = data["wrap64"][:, :2].astype(object).sum(axis=0)
    assert all(abs(int(v)) >= 1 << 63 for v in exact)
    assert [int(v) & _MASK64 for v in want["psum wrap"][0][:2]] == [
        int(v) & _MASK64 for v in exact]
    # shards no pair sends to get zeros
    assert not want["ppermute"][0].any()


def test_collectives_hold_the_mesh_to_the_group():
    """The collectives read the split over processes from the mesh, and
    refuse a mesh of several processes that is not this process's group
    (here: no group), and a shard list that is not the mesh's local
    shards, before any call of the group."""
    devs = make_mesh(4, "cpu").devices
    xs = [torch.tensor(s) for s in range(2)]
    with pytest.raises(RuntimeError, match="rank 1 of 2 .*group is None"):
        collectives.psum(Mesh(devs, rank=1, world=2), xs)
    with pytest.raises(ValueError, match="2 tensors for the 4 local"):
        collectives.all_to_all(Mesh(devs), xs)
    with pytest.raises(ValueError, match="do not split host-major"):
        Mesh(devs, world=3)
    assert Mesh(devs, rank=1, world=2).local == [2, 3]


# ---------------------------------------------------------------------------
# The protocol driver as W ranks
# ---------------------------------------------------------------------------

QUERIES = [
    "0 1|0.0=1.0|0.2 1.2",                         # fused join on Zipf keys
    "0 1|0.1=1.1&0.2>1000|0.2 1.0",                # filter + fused join
    "0 1 2|0.1=1.1&1.0=2.0|0.2 1.2 2.2",           # chain: join + fused
    "0 1 2|0.1=1.1&1.1=2.1&0.1=2.1|0.2 2.2",       # cycle edge (selection)
    "0 1|0.1=1.1&0.1>5000|0.1 1.1",                # empty -> NULL
    "0 0|0.1=1.1|0.2 1.0",                         # same relation twice
    "0 1 2 3|0.1=1.1&1.1=2.1&2.0=3.0|3.1 0.1",     # 4-relation chain
    "1|0.0=0.1|0.2",                               # self-join only
    "2|0.1>2000|0.1",                              # filter only
    "3 2|0.0=1.0|0.1 1.1",                         # small build side
]
ROWS = (6000, 5000, 1200, 600)


def _cols():
    """Four relations: Zipf(1.5) keys (key 1 holds ~38% of the rows, a
    skew split's hot key from 4 shards at S18_SKEW=1 and from 8 at the
    default), uniform keys below 4,000, wide values."""
    rng = np.random.default_rng(2018)
    return [[np.minimum(rng.zipf(1.5, n), 5000).astype(np.uint64),
             rng.integers(0, 4000, n).astype(np.uint64),
             rng.integers(0, 1 << 40, n).astype(np.uint64)]
            for n in ROWS]


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    """(relation paths, protocol text, oracle lines, {S18_MESH: JAX
    lines})."""
    if len(jax.devices()) < 8:
        pytest.skip("need 8 JAX devices")
    base = tmp_path_factory.mktemp("mp_rels")
    cols = _cols()
    paths = []
    for i, c in enumerate(cols):
        paths.append(str(base / f"r{i}"))
        store_relation(Relation(columns=c), paths[-1])
    text = "\n".join(paths + ["Done"] + QUERIES + ["F"]) + "\n"
    jcat = JaxCatalog([JaxRelation(columns=c) for c in cols])
    oracle = [execute_query_numpy(jparse(q), jcat) for q in QUERIES]
    jax_lines = {}
    # The JAX driver's warm-up tier would answer these small relations
    # with its host oracle: off, so that its mesh engine serves.
    old = os.environ.get("S18_WARMUP_ORACLE")
    os.environ["S18_WARMUP_ORACLE"] = "0"
    try:
        for n in (4, 8):
            out = io.StringIO()
            jax_run_protocol(io.StringIO(text), out,
                             JaxConfig(vault=False, mesh_devices=n))
            jax_lines[n] = out.getvalue().splitlines()
    finally:
        if old is None:
            del os.environ["S18_WARMUP_ORACLE"]
        else:
            os.environ["S18_WARMUP_ORACLE"] = old
    return paths, text, oracle, jax_lines


def _reports(outs) -> list:
    """Each rank's `process {..}` line."""
    return [json.loads(next(ln for ln in err.splitlines()
                            if ln.startswith("process {"))[len("process "):])
            for _, err in outs]


def _one_process(text: str, cache, **s18) -> tuple:
    """The same protocol through a one-process mesh in this process:
    (lines, collective calls, engine)."""
    cfg = dict(mesh_devices=int(s18["S18_MESH"]), platform="cpu",
               exchange=s18.get("S18_EXCHANGE", "a2a"),
               bcast_threshold=int(s18.get("S18_BCAST", 4096)),
               skew_factor=int(s18.get("S18_SKEW", 2)),
               compile_queries=str(s18.get("S18_COMPILE_QUERIES", 1)) != "0",
               warmup_oracle=0)  # as under a group: the mesh serves all
    old = os.environ.get("S18_PREP_CACHE")
    os.environ["S18_PREP_CACHE"] = str(cache)
    try:
        collectives.reset_calls()
        out = io.StringIO()
        engine = serve(io.StringIO(text), out, EngineConfig(**cfg))
        return out.getvalue().splitlines(), dict(collectives.CALLS), engine
    finally:
        if old is None:
            del os.environ["S18_PREP_CACHE"]
        else:
            os.environ["S18_PREP_CACHE"] = old


# (W, S18_* switches, join strategies that must serve)
CONFIGS = {
    "2 ranks, all_to_all, broadcast, 8 workers": (
        2, dict(S18_MESH=4, S18_WORKERS=8), {"broadcast", "shuffle"}),
    "2 ranks, skew split, no broadcast": (
        2, dict(S18_MESH=4, S18_BCAST=0, S18_SKEW=1), {"skew"}),
    "2 ranks, operator engine": (
        2, dict(S18_MESH=4, S18_BCAST=0, S18_COMPILE_QUERIES=0), set()),
    "4 ranks, ring, no broadcast": (
        4, dict(S18_MESH=8, S18_EXCHANGE="ring", S18_BCAST=0),
        {"shuffle", "skew"}),
    "4 ranks, all_to_all, broadcast": (
        4, dict(S18_MESH=8), {"broadcast"}),
}


@pytest.mark.parametrize("label", list(CONFIGS))
def test_ranks_answer_like_jax(label, protocol, tmp_path):
    world, s18, strategies = CONFIGS[label]
    paths, text, oracle, jax_lines = protocol
    outs = run_ranks([sys.executable, "-m", "sigmod2018_tpu_torch"], world,
                     _env(S18_PREP_CACHE=tmp_path / "ranks", **s18), text,
                     RANK_TIMEOUT_S)
    assert jax_lines[s18["S18_MESH"]] == oracle
    lines, calls, engine = _one_process(text, tmp_path / "one", **s18)
    assert lines == oracle
    reports = _reports(outs)
    for rank, ((stdout, stderr), rep) in enumerate(zip(outs, reports)):
        assert stdout.splitlines() == oracle, (label, rank)
        assert (rep["rank"], rep["world"]) == (rank, world)
        assert rep["transport"].startswith("gloo")
        assert f"process {rank} of {world}: collectives over gloo" in stderr
        assert rep["collectives"] == calls, (label, rank)
        assert sum(rep["tiers"].values()) == len(QUERIES)
        assert rep["tiers"] == dict(engine.tiers)
        assert strategies <= set(rep["join_strategies"]), rep
    if s18.get("S18_EXCHANGE") == "ring":
        assert calls["ppermute"] > 0 and calls["all_to_all"] == 0
    if s18.get("S18_WORKERS", 1) > 1:
        assert all("S18_WORKERS=8 overridden" in err for _, err in outs)


def _learned_files(directory: Path) -> dict:
    return {p.name: json.loads(p.read_text())
            for p in directory.glob("learned-torch-*.json")}


def test_learned_file_of_two_ranks(protocol, tmp_path):
    """Rank 0 writes what one process on the same mesh learns, run after
    run; rank 1 writes nothing and still sizes every query from rank 0's
    values on the next run."""
    _, text, oracle, _ = protocol
    s18 = dict(S18_MESH=4, S18_BCAST=0)
    caches = [tmp_path / "rank0", tmp_path / "rank1"]
    argv = [sys.executable, "-m", "sigmod2018_tpu_torch"]
    for run in (1, 2):
        _one_process(text, tmp_path / "one", **s18)
        one = _learned_files(tmp_path / "one")
        assert len(one) == 1 and next(iter(one)).endswith("-mesh4.json")
        outs = run_ranks(argv, 2, _env(**s18), text, RANK_TIMEOUT_S,
                         per_rank=[dict(S18_PREP_CACHE=str(c))
                                   for c in caches])
        assert all(out.splitlines() == oracle for out, _ in outs)
        assert _learned_files(caches[0]) == one, run
        assert _learned_files(caches[1]) == {}
        counts = [rep["counts"] for rep in _reports(outs)]
        assert counts[0] == counts[1]
        if run == 2:
            assert counts[0]["learned"] > 0
            assert counts[0]["retried"] == counts[0]["incremental"] == 0
            assert counts[0]["segment_reads"] == 0


def test_a_failing_rank_fails_fast(tmp_path):
    """A rank that exits nonzero ends the others at once: the group's
    partner is not left waiting for its timeout."""
    code = ("import os, sys, time\n"
            "from sigmod2018_tpu_torch.parallel import multihost\n"
            "multihost.init_distributed()\n"
            "if os.environ['S18_PROC_ID'] == '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(600)\n")
    with pytest.raises(RanksFailed, match="rank 1: rc 3"):
        run_ranks([sys.executable, "-c", code], 2, _env(), "", 60)


def test_prefetch_issues_no_collective(tmp_path):
    """The prefetch thread may run beside the batch's collectives: it
    issues none, in one process and on either rank of a 2-process group,
    for the compiled and the operator mesh engine.  A warm replay serves
    queries, so it issues some (and io/repl.py runs it before serving
    under a group)."""
    cols = _cols()
    np.savez(tmp_path / "cols.npz", *[c for rel in cols for c in rel])
    rank_code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from sigmod2018_tpu_torch.config import EngineConfig\n"
        "from sigmod2018_tpu_torch.parallel import collectives as C\n"
        "from sigmod2018_tpu_torch.parallel import multihost\n"
        "from sigmod2018_tpu_torch.parallel.dist_compiled import (\n"
        "    DistCompiledTorchEngine)\n"
        "from sigmod2018_tpu_torch.parallel.dist_engine import (\n"
        "    DistTorchEngine)\n"
        "from sigmod2018_tpu_torch.storage.catalog import Catalog\n"
        "from sigmod2018_tpu_torch.storage.relation import Relation\n"
        "multihost.init_distributed()\n"
        "a = np.load(sys.argv[1])\n"
        "c = [a[f'arr_{i}'] for i in range(len(a.files))]\n"
        "cat = Catalog([Relation(columns=c[i:i + 3])\n"
        "               for i in range(0, len(c), 3)])\n"
        "cfg = EngineConfig(platform='cpu', mesh_devices=4,\n"
        "                   warm_replay=False)\n"
        "calls = {}\n"
        "for cls in (DistCompiledTorchEngine, DistTorchEngine):\n"
        "    engine = cls(cat, cfg)\n"
        "    C.reset_calls()\n"
        "    engine.prefetch()\n"
        "    calls[cls.__name__] = dict(C.CALLS)\n"
        "print(json.dumps(calls))\n")
    outs = run_ranks([sys.executable, "-c", rank_code,
                      str(tmp_path / "cols.npz")], 2,
                     _env(S18_PREP_CACHE=tmp_path / "ranks"), "",
                     RANK_TIMEOUT_S)
    for stdout, _ in outs:
        calls = json.loads(stdout.splitlines()[-1])
        assert set(calls) == {"DistCompiledTorchEngine", "DistTorchEngine"}
        assert not any(v for c in calls.values() for v in c.values()), calls
    cat = Catalog([Relation(columns=c) for c in cols])
    eng = DistCompiledTorchEngine(cat, EngineConfig(platform="cpu"),
                                  mesh=make_mesh(4, "cpu"))
    collectives.reset_calls()
    eng.prefetch()
    assert not any(collectives.CALLS.values()), collectives.CALLS
    from sigmod2018_tpu_torch.frontend.parser import parse_query

    eng._learn(QUERIES[2], (1, 64, 0, 0, 0, 0))
    warm = DistCompiledTorchEngine(cat, EngineConfig(platform="cpu",
                                                     warm_replay=True),
                                   mesh=make_mesh(4, "cpu"))
    warm._learned_classes = dict(eng._learned_classes)
    collectives.reset_calls()
    warm.prefetch()
    assert sum(collectives.CALLS.values()) > 0
    assert warm.execute(parse_query(QUERIES[2])) == execute_query_numpy(
        jparse(QUERIES[2]), JaxCatalog([JaxRelation(columns=c)
                                        for c in cols]))
