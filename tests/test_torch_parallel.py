"""The port's mesh programs (sigmod2018_tpu_torch/parallel/dist.py) held
against the JAX package's (sigmod2018_tpu/parallel/dist.py) on the CPU:
the same seeded numpy columns go through the JAX program on the 8-device
virtual mesh of tests/conftest.py and through the port on a CPU mesh of
the same size.  Checksums, counts and overflow flags are u64 and integer
values, so every comparison is exact; the NumPy oracle of
tests/test_parallel.py checks both.

Beside the counterparts of tests/test_parallel.py: destinations on a
3-shard mesh with keys at 2^63 and above (the unsigned remainder), the
fused shuffle join and its cap program, the collectives (fresh outputs,
the ring against the all_to_all, the call counts), the mesh's placement
and the operator engine on a mesh (DistTorchEngine) against
DistJaxEngine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sigmod2018_tpu import parallel as jpar
from sigmod2018_tpu.config import EngineConfig as JaxConfig
from sigmod2018_tpu.engine.oracle import execute_query_numpy
from sigmod2018_tpu.frontend.parser import parse_query as jparse
from sigmod2018_tpu.parallel import dist as jdist
from sigmod2018_tpu.parallel.dist_engine import DistJaxEngine
from sigmod2018_tpu.storage.catalog import Catalog as JaxCatalog
from sigmod2018_tpu.storage.relation import Relation as JaxRelation
from sigmod2018_tpu_torch import parallel as tpar
from sigmod2018_tpu_torch.config import EngineConfig
from sigmod2018_tpu_torch.frontend.parser import parse_query as tparse
from sigmod2018_tpu_torch.parallel import collectives, dist as tdist, mesh
from sigmod2018_tpu_torch.parallel.dist_engine import DistTorchEngine
from sigmod2018_tpu_torch.storage.catalog import Catalog
from sigmod2018_tpu_torch.storage.relation import Relation

N_DEV = 8
_MASK64 = (1 << 64) - 1


@pytest.fixture(scope="module")
def meshes():
    """{ndev: (JAX mesh, port CPU mesh)} for 8, 4 and 3 shards."""
    if len(jax.devices()) < N_DEV:
        pytest.skip(f"need {N_DEV} JAX devices")
    return {n: (jpar.make_mesh(n), tpar.make_mesh(n, "cpu"))
            for n in (N_DEV, 4, 3)}


def _u64(x) -> int:
    return int(x) & _MASK64


def _jput(jm, arr):
    return jax.device_put(jnp.asarray(arr), jpar.row_sharding(jm))


def _both(meshes, ndev, make, *cols, const=None, **kw):
    """Run `make` of both packages on the same host columns: (JAX
    outputs, port outputs) as u64 ints."""
    jm, tm = meshes[ndev]
    jargs = [_jput(jm, c) for c in cols]
    targs = [tpar.row_sharding(tm)(c) for c in cols]
    if const is not None:
        jargs.append(jnp.uint64(const))
        targs.append(const)
    jout = getattr(jdist, make)(jm, **kw)(*jargs)
    tout = getattr(tdist, make)(tm, **kw)(*targs)
    if not isinstance(jout, tuple):
        jout, tout = (jout,), (tout,)
    return [_u64(x) for x in jout], [_u64(x) for x in tout]


def _oracle_join_checksum(r_key, r_val, s_key, s_val, const):
    live = r_val > const
    rk, rv = r_key[live], r_val[live]
    order = np.argsort(rk, kind="stable")
    srk, srv = rk[order], rv[order]
    lo = np.searchsorted(srk, s_key, side="left")
    hi = np.searchsorted(srk, s_key, side="right")
    cnt = (hi - lo).astype(np.uint64)
    pref = np.concatenate([[np.uint64(0)], np.cumsum(srv, dtype=np.uint64)])
    total = int(cnt.sum(dtype=np.uint64))
    sum_b = int(np.sum(pref[hi] - pref[lo], dtype=np.uint64)) & _MASK64
    sum_p = int(np.sum(cnt * s_val.astype(np.uint64),
                       dtype=np.uint64)) & _MASK64
    return [total, sum_b, sum_p]


def _join_inputs(seed, nr, ns, keyspace, high=False):
    rng = np.random.default_rng(seed)
    r_key = rng.integers(0, keyspace, size=nr, dtype=np.uint64)
    r_val = rng.integers(0, 1 << 40, size=nr, dtype=np.uint64)
    s_key = rng.integers(0, keyspace, size=ns, dtype=np.uint64)
    s_val = rng.integers(0, 1 << 40, size=ns, dtype=np.uint64)
    if high:  # keys at 2^63 and above, and live keys 2^64-1
        r_key[::3] += np.uint64(1 << 63)
        s_key[::4] += np.uint64(1 << 63)
        r_key[::17] = s_key[::13] = np.uint64(_MASK64)
    return r_key, r_val, s_key, s_val


def test_dist_checksum_matches_jax(meshes):
    rng = np.random.default_rng(0)
    col = rng.integers(0, 1 << 63, size=1024, dtype=np.uint64)
    col[::5] += np.uint64(1 << 63)
    j, t = _both(meshes, N_DEV, "make_dist_checksum", col)
    assert j == t == [int(np.add.reduce(col, dtype=np.uint64))]


@pytest.mark.parametrize("ndev", [N_DEV, 3])
def test_exchange_counts_match_jax(meshes, ndev):
    """The largest per-(source, destination) count; at 3 shards the
    destination is the unsigned remainder of keys at 2^63 and above."""
    keys = _join_inputs(1, 96 * ndev, 8, 1000, high=True)[0]
    j, t = _both(meshes, ndev, "make_exchange_counts", keys)
    shards = keys.reshape(ndev, -1)
    want = max(int(np.sum(s % np.uint64(ndev) == d))
               for s in shards for d in range(ndev))
    assert j == t == [want]


@pytest.mark.parametrize("ndev", [3, 6, 5, 8])
def test_destination_is_unsigned_remainder(ndev):
    rng = np.random.default_rng(ndev)
    keys = rng.integers(0, 1 << 64, size=4096, dtype=np.uint64,
                        endpoint=False)
    keys[:4] = [0, _MASK64, 1 << 63, (1 << 63) - 1]
    live = torch.ones(keys.size, dtype=torch.bool)
    live[7] = False
    got = tdist._dest_of(torch.from_numpy(keys.view(np.int64)), live, ndev)
    want = (keys % np.uint64(ndev)).astype(np.int64)
    want[7] = ndev
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,nr,ns,keyspace,ndev,high", [
    (2, 512, 1024, 64, N_DEV, False),      # many duplicates
    (3, 1024, 512, 100000, N_DEV, False),  # mostly unique
    (4, 256, 256, 1, N_DEV, False),        # one hot key (extreme skew)
    (5, 288, 576, 64, 3, True),            # 3 shards, keys >= 2^63
])
def test_dist_join_checksum_matches_jax(meshes, seed, nr, ns, keyspace,
                                        ndev, high):
    cols = _join_inputs(seed, nr, ns, keyspace, high)
    const = 1 << 39
    cap = max(nr, ns) // ndev * 4
    cap = max(cap, nr, ns) if keyspace == 1 else cap
    j, t = _both(meshes, ndev, "make_dist_join_checksum", *cols,
                 const=const, cap=cap)
    assert j == t
    assert t == _oracle_join_checksum(*cols, np.uint64(const)) + [0]


def test_pad_key_value_joins_correctly(meshes):
    """2^64-1 is the pad key; a live key of that value still joins."""
    top = np.uint64(_MASK64)
    r_key = np.array([top, 1, 2, top] * 2 * N_DEV, dtype=np.uint64)
    r_val = np.arange(r_key.size, dtype=np.uint64)
    s_key = np.array([top, 3, 1, top] * 2 * N_DEV, dtype=np.uint64)
    s_val = np.arange(s_key.size, dtype=np.uint64)
    cols = (r_key, r_val, s_key, s_val)
    j, t = _both(meshes, N_DEV, "make_dist_join_checksum", *cols, const=0,
                 cap=r_key.size)
    assert j == t
    assert t[:3] == _oracle_join_checksum(*cols, np.uint64(0))


def _zipf_inputs(seed, nr, ns, alpha, hot_side):
    rng = np.random.default_rng(seed)
    zipf = lambda n: np.minimum(rng.zipf(alpha, size=n), 200).astype(
        np.uint64)
    if hot_side == "probe":
        r_key = rng.integers(0, 200, size=nr, dtype=np.uint64)
        r_val = rng.integers(0, 1 << 40, size=nr, dtype=np.uint64)
        s_key = zipf(ns)
    else:
        r_key = zipf(nr)
        r_val = rng.integers(0, 1 << 40, size=nr, dtype=np.uint64)
        s_key = rng.integers(0, 200, size=ns, dtype=np.uint64)
    s_val = rng.integers(0, 1 << 40, size=ns, dtype=np.uint64)
    return r_key, r_val, s_key, s_val


@pytest.mark.parametrize("alpha", [1.1, 2.0])
@pytest.mark.parametrize("seed,nr,ns,hot_side", [(11, 512, 2048, "probe"),
                                                 (17, 2048, 512, "build")])
def test_skew_join_matches_jax(meshes, alpha, seed, nr, ns, hot_side):
    """Zipf keys on the probe side, then on the build side: the
    heavy-hitter split is exact and equals JAX's."""
    cols = _zipf_inputs(seed, nr, ns, alpha, hot_side)
    const = 1 << 38
    j, t = _both(meshes, N_DEV, "make_dist_join_checksum_skew", *cols,
                 const=const, cap=nr + ns, hot_k=16, hot_cap=nr,
                 hot_threshold=4)
    assert j == t
    assert t == _oracle_join_checksum(*cols, np.uint64(const)) + [0]


def test_skew_join_uniform_keys_no_false_positives(meshes):
    cols = _join_inputs(12, 1024, 1024, 100000)
    j, t = _both(meshes, N_DEV, "make_dist_join_checksum_skew", *cols,
                 const=0, cap=2048, hot_cap=1024)
    assert j == t
    assert t == _oracle_join_checksum(*cols, np.uint64(0)) + [0]


def test_skew_join_three_shards_high_keys(meshes):
    cols = _join_inputs(9, 384, 768, 40, high=True)
    j, t = _both(meshes, 3, "make_dist_join_checksum_skew", *cols,
                 const=1 << 30, cap=1152, hot_k=8, hot_cap=384)
    assert j == t
    assert t == _oracle_join_checksum(*cols, np.uint64(1 << 30)) + [0]


def test_dist_join_4_device_mesh(meshes):
    cols = _join_inputs(44, 512, 512, 100)
    j, t = _both(meshes, 4, "make_dist_join_checksum", *cols,
                 const=1 << 39, cap=512)
    assert j == t
    assert t[:3] == _oracle_join_checksum(*cols, np.uint64(1 << 39))


def test_dist_join_overflow_reported(meshes):
    """Undersized send caps raise the overflow flag (every row routes to
    shard 0): the same count of truncating shards as JAX's."""
    rng = np.random.default_rng(55)
    n = 64 * N_DEV
    cols = (np.zeros(n, dtype=np.uint64),
            rng.integers(1, 1 << 40, size=n, dtype=np.uint64),
            np.zeros(n, dtype=np.uint64),
            rng.integers(1, 1 << 40, size=n, dtype=np.uint64))
    j, t = _both(meshes, N_DEV, "make_dist_join_checksum", *cols, const=0,
                 cap=8)
    assert j == t and t[3] > 0


def test_skew_join_hot_cap_overflow_reported(meshes):
    n = 64 * N_DEV
    cols = (np.zeros(n, dtype=np.uint64), np.ones(n, dtype=np.uint64),
            np.zeros(n, dtype=np.uint64), np.ones(n, dtype=np.uint64))
    j, t = _both(meshes, N_DEV, "make_dist_join_checksum_skew", *cols,
                 const=0, cap=n, hot_k=16, hot_cap=4, hot_threshold=4)
    assert j == t and t[3] > 0


@pytest.mark.parametrize("ndev", [N_DEV, 3])
def test_scaling_model_parts_match_jax(meshes, ndev):
    """make_dist_join_parts: the compute half and the exchange half give
    JAX's values (the compute half's flattened send buffers included)."""
    cols = _join_inputs(17, 1 << 9 if ndev == N_DEV else 384,
                        1 << 9 if ndev == N_DEV else 384, 1 << 10,
                        high=ndev == 3)
    jm, tm = meshes[ndev]
    cap = cols[0].size // ndev
    jcomp, jcomm = jdist.make_dist_join_parts(jm, cap)
    tcomp, tcomm = tdist.make_dist_join_parts(tm, cap)
    ja = [_jput(jm, c) for c in cols]
    ta = [tpar.row_sharding(tm)(c) for c in cols]
    assert ([_u64(x) for x in jcomp(*ja, jnp.uint64(1 << 29))]
            == [_u64(x) for x in tcomp(*ta, 1 << 29)])
    assert _u64(jcomm(ja[0], ja[2])) == _u64(tcomm(ta[0], ta[2]))


@pytest.mark.parametrize("ndev", [N_DEV, 3])
def test_fused_shuffle_join_matches_jax(meshes, ndev):
    """make_shuffle_caps and make_fused_shuffle_join with global live
    prefixes (an int and a 0-d tensor) and two view columns per side."""
    rng = np.random.default_rng(23)
    n, V = 96 * ndev, 2
    keys = _join_inputs(23, n, n, 50, high=True)
    bcols = rng.integers(0, 1 << 40, (V, n), dtype=np.uint64)
    pcols = rng.integers(0, 1 << 40, (V, n), dtype=np.uint64)
    jm, tm = meshes[ndev]
    n_b, n_p = n - 3, n - 50
    jcaps = jdist.make_shuffle_caps(jm)(_jput(jm, keys[0]), jnp.int32(n_b),
                                        _jput(jm, keys[2]), jnp.int32(n_p))
    tk = [tpar.row_sharding(tm)(keys[i]) for i in (0, 2)]
    tcaps = tdist.make_shuffle_caps(tm)(tk[0], n_b, tk[1],
                                        torch.tensor(n_p))
    assert [int(x) for x in jcaps] == tcaps.tolist()
    cap = int(max(tcaps.tolist()))
    vs = NamedSharding(jm, P(None, jpar.AXIS))
    jout = jdist.make_fused_shuffle_join(jm, cap, V)(
        _jput(jm, keys[0]), jax.device_put(jnp.asarray(bcols), vs),
        jnp.int32(n_b), _jput(jm, keys[2]),
        jax.device_put(jnp.asarray(pcols), vs), jnp.int32(n_p))
    L = n // ndev

    def shards(a):
        return [torch.from_numpy(a[:, s * L:(s + 1) * L].view(np.int64))
                for s in range(ndev)]

    tout = tdist.make_fused_shuffle_join(tm, cap, V)(
        tk[0], shards(bcols), n_b, tk[1], shards(pcols), torch.tensor(n_p))
    assert [_u64(x) for x in jout] == [_u64(x) for x in tout]


def test_collectives_fresh_outputs_and_counts():
    """Every output is a new tensor (an in-place write after a
    collective leaves the senders' inputs as they were), the ring gives
    the all_to_all's result in ndev - 1 ppermute hops, and CALLS counts
    each kind."""
    n = 5
    m = mesh.make_mesh(n, "cpu")
    xs = [torch.arange(n * 3).reshape(n, 3) + 100 * s for s in range(n)]
    before = [x.clone() for x in xs]
    collectives.reset_calls()
    outs = {"a2a": collectives.all_to_all(m, xs),
            "ring": collectives.ring_all_to_all(m, xs),
            "gather": collectives.all_gather(m, xs),
            "psum": collectives.psum(m, xs), "pmax": collectives.pmax(m, xs),
            "perm": collectives.ppermute(m, xs, [(0, 1), (1, 0)])}
    assert collectives.CALLS == dict(all_to_all=1, all_gather=1, psum=1,
                                     pmax=1, ppermute=1 + (n - 1))
    for d in range(n):
        for s in range(n):
            assert torch.equal(outs["a2a"][d][s], xs[s][d])
        assert torch.equal(outs["ring"][d], outs["a2a"][d])
        assert torch.equal(outs["gather"][d], torch.stack(xs))
        assert torch.equal(outs["psum"][d], sum(xs))
        assert torch.equal(outs["pmax"][d], xs[-1])
    assert torch.equal(outs["perm"][1], xs[0])
    assert torch.equal(outs["perm"][2], torch.zeros_like(xs[2]))
    for out in outs.values():
        for t in out:
            t.add_(7)
    assert all(torch.equal(a, b) for a, b in zip(xs, before))
    # psum wraps around mod 2^64 as u64 bit patterns
    big = [torch.tensor(-1), torch.tensor(2)]
    assert collectives.psum(mesh.make_mesh(2, "cpu"), big)[0].item() == 1


def test_mesh_placement_and_row_shards():
    """make_mesh places shard i on the CPU for "cpu" and on card i mod
    the cards for "cuda"; without a card "cuda" raises (no fallback).
    shard_rows pads to size_class(n, 128 * ndev) (a multiple of ndev)
    and split_rows keeps the rows in order."""
    m = tpar.make_mesh(4, "cpu")
    assert m.size == 4 and m.flat == [torch.device("cpu")] * 4
    assert m.axis_names == (tpar.AXIS,)
    assert tpar.make_mesh(platform="cpu").size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="S18_PLATFORM=cuda"):
            tpar.make_mesh(4, "cuda")
    col = np.arange(1000, dtype=np.uint64)
    parts = mesh.shard_rows(col, m)
    assert [p.shape[0] for p in parts] == [256] * 4
    assert torch.equal(torch.cat(parts)[:1000],
                       torch.from_numpy(col.view(np.int64)))
    assert int(torch.cat(parts)[1000:].abs().sum()) == 0
    assert mesh.padded_rows(1000, 3) % 3 == 0
    assert mesh.padded_rows(1000, 8) == 1024
    with pytest.raises(ValueError):
        mesh.split_rows(col, tpar.make_mesh(3, "cpu"))


# ---------------------------------------------------------------------------
# The operator engine on a mesh
# ---------------------------------------------------------------------------


def _catalogs(seed, sizes, dom):
    rng = np.random.default_rng(seed)
    cols = [[rng.integers(0, dom, size=n).astype(np.uint64)
             for _ in range(3)] for n in sizes]
    return (JaxCatalog([JaxRelation(columns=c) for c in cols]),
            Catalog([Relation(columns=c) for c in cols]))


@pytest.mark.parametrize("seed,sizes,dom,texts,fused_joins", [
    (21, (400, 250, 130), 50, [
        "0 1|0.0=1.0|0.1 1.2",
        "0 1 2|0.0=1.0&1.1=2.1|0.2 2.0",
        "0 1|0.0=1.0&0.1>25|0.0 1.1",
        "0 1 2|0.0=1.0&1.1=2.1&0.1=2.0|0.0",  # ends on a selection
        "0|0.0=0.1|0.2",
    ], 3),
    (33, (640, 320), 60, [
        "0 1|0.0=1.0|0.1 1.2",
        "0 1|0.0=1.0&0.1>30|0.1 1.2 0.2",
        "0 1|0.0=1.0&0.0>100|0.0",        # empty -> NULL
    ], 3),
])
def test_dist_engine_matches_jax(meshes, seed, sizes, dom, texts,
                                 fused_joins):
    """DistTorchEngine == DistJaxEngine == the oracle; every fused final
    join went through the shuffle (one host read of its send maxima, an
    all_to_all per column)."""
    jcat, tcat = _catalogs(seed, sizes, dom)
    jm, tm = meshes[N_DEV]
    jeng = DistJaxEngine(jcat, JaxConfig(), mesh=jm)
    teng = DistTorchEngine(tcat, EngineConfig(platform="cpu"), mesh=tm)
    teng.prefetch()
    # the mesh's prefetch copies columns and builds no join artifact
    assert len(teng._columns) == 3 * len(sizes)
    assert not (teng._sorted_columns or teng._key_tables
                or teng._radix_keys)
    collectives.reset_calls()
    for text in texts:
        want = execute_query_numpy(jparse(text), jcat)
        assert jeng.execute(jparse(text)) == want, text
        assert teng.execute(tparse(text)) == want, text
    fused = sum(1 for k in jeng._dist_programs if k[0] == "fused")
    assert fused and teng.counts["cap_reads"] == fused_joins
    assert collectives.CALLS["all_to_all"] > 0
    assert teng.tiers["materialized"] == len(texts)
    assert not teng._prefix_tables  # the fused joins took no prep table


def test_dist_engine_three_shards(meshes):
    """A mesh whose size is no power of two: the fused join's sides are
    padded to split evenly, and the unsigned routing holds."""
    _, tcat = _catalogs(5, (500, 300), 40)
    jcat = _catalogs(5, (500, 300), 40)[0]
    teng = DistTorchEngine(tcat, EngineConfig(platform="cpu"),
                           mesh=meshes[3][1])
    for text in ("0 1|0.0=1.0|0.1 1.2", "0 1|0.1=1.1&0.0>10|0.2 1.0"):
        assert teng.execute(tparse(text)) == execute_query_numpy(
            jparse(text), jcat)
