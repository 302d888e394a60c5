"""The port's `Catalog.from_files` (stats cache, then native loader, then
NumPy) against the JAX package's on the same files: all six stats fields
equal; a cache hit equals a miss; a touched file misses;
S18_PREP_CACHE=0 writes nothing; the JAX package's stats file in the
same directory is never read; natively loaded columns feed the engine's
device copies and the host executors' dense columns."""

import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from sigmod2018_tpu.storage import catalog as jcatalog
from sigmod2018_tpu_torch.config import EngineConfig
from sigmod2018_tpu_torch.engine.executor import TorchEngine
from sigmod2018_tpu_torch.storage import catalog as tcatalog, native
from sigmod2018_tpu_torch.storage.catalog import Catalog
from sigmod2018_tpu_torch.storage.relation import Relation, store_relation


def _rows(cat):
    return [[dataclasses.astuple(s) for s in rel] for rel in cat.stats]


@pytest.fixture
def paths(tmp_path):
    """3 relations x 3 columns: ties, a Zipf column, keys past 2^63."""
    rng = np.random.default_rng(29)
    out = []
    for i in range(3):
        cols = [np.repeat(rng.integers(0, 60, 50), 8).astype(np.uint64),
                np.minimum(rng.zipf(1.4, 400), 1 << 40).astype(np.uint64),
                rng.integers(0, 1 << 63, 400, dtype=np.uint64) * 2
                + np.uint64(i)]
        out.append(str(tmp_path / f"r{i}"))
        store_relation(Relation(columns=cols), out[-1])
    return out


@pytest.fixture
def spy_native(monkeypatch):
    calls = []
    real = native.load_relations_native
    monkeypatch.setattr(native, "load_relations_native",
                        lambda p: calls.append(list(p)) or real(p))
    return calls


@pytest.mark.parametrize("way", ["native", "numpy", "cache hit"])
def test_from_files_equals_jax(paths, tmp_path, monkeypatch, way):
    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path / "jax"))
    want = _rows(jcatalog.Catalog.from_files(paths))
    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path / "torch"))
    if way == "cache hit":
        Catalog.from_files(paths)
    got = Catalog.from_files(paths, native=way != "numpy")
    assert _rows(got) == want
    assert got.source_paths == paths


def test_cache_hit_equals_miss(paths, tmp_path, monkeypatch, spy_native):
    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path / "c"))
    miss = Catalog.from_files(paths)
    assert len(spy_native) == 1
    assert os.listdir(tmp_path / "c") == [
        os.path.basename(tcatalog.stats_cache_path(paths))]
    hit = Catalog.from_files(paths)
    assert len(spy_native) == 1  # the stats came from the cache
    assert _rows(hit) == _rows(miss)
    assert isinstance(hit.column(0, 0), np.memmap)  # mapped, not stat'ed
    for rid in range(3):
        for cid in range(3):
            assert np.array_equal(hit.column(rid, cid), miss.column(rid, cid))


def test_touched_file_misses(paths, tmp_path, monkeypatch, spy_native):
    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path / "c"))
    first = Catalog.from_files(paths)
    st = os.stat(paths[1])
    os.utime(paths[1], ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    again = Catalog.from_files(paths)
    assert len(spy_native) == 2
    assert _rows(again) == _rows(first)
    assert len(os.listdir(tmp_path / "c")) == 2  # one file per identity


@pytest.mark.parametrize("native_on", [True, False])
def test_prep_cache_off_writes_nothing(paths, tmp_path, monkeypatch,
                                       native_on):
    monkeypatch.setenv("S18_PREP_CACHE", "0")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    before = sorted(os.listdir(tmp_path))
    cat = Catalog.from_files(paths, native=native_on)
    assert tcatalog.stats_cache_path(paths) is None
    assert sorted(os.listdir(tmp_path)) == before
    assert _rows(cat) == _rows(Catalog([c for c in cat.relations]))


def test_jax_stats_file_is_not_read(paths, tmp_path, monkeypatch,
                                    spy_native):
    """Both packages key their stats by the same digest; a JAX
    stats-<digest>.npz in the shared directory (here one with wrong
    values) must not be taken for the port's."""
    cache = tmp_path / "shared"
    monkeypatch.setenv("S18_PREP_CACHE", str(cache))
    jcatalog.Catalog.from_files(paths)
    jax_file = cache / f"stats-{tcatalog.identity_digest(paths)}.npz"
    assert jax_file.exists()
    with np.load(jax_file) as z:
        poisoned = {k: z[k] + np.uint64(1) if k != "ncols" else z[k]
                    for k in z.files}
    np.savez(jax_file, **poisoned)
    cat = Catalog.from_files(paths)
    assert len(spy_native) == 1
    assert _rows(cat) == _rows(Catalog([r for r in cat.relations]))
    assert sorted(os.listdir(cache)) == sorted(
        [jax_file.name, f"stats-torch-{tcatalog.identity_digest(paths)}.npz"])


def test_corrupt_cache_file_is_a_miss(paths, tmp_path, monkeypatch,
                                      spy_native):
    monkeypatch.setenv("S18_PREP_CACHE", str(tmp_path / "c"))
    want = _rows(Catalog.from_files(paths))
    Path(tcatalog.stats_cache_path(paths)).write_bytes(b"not an npz")
    assert _rows(Catalog.from_files(paths)) == want
    assert len(spy_native) == 2


def test_native_columns_feed_the_engine(paths, tmp_path, monkeypatch):
    """Zero-copy views of the mapping go through device_column's copy and
    dense_column as memmaps do."""
    monkeypatch.setenv("S18_PREP_CACHE", "0")
    nat = Catalog.from_files(paths)
    ref = Catalog.from_files(paths, native=False)
    assert not isinstance(nat.column(0, 0), np.memmap)
    assert not nat.column(0, 0).flags.writeable
    eng = TorchEngine(nat, EngineConfig(platform="cpu"))
    for rid in range(3):
        for cid in range(3):
            dev, n = eng.device_column(rid, cid)
            assert n == 400
            assert np.array_equal(dev[:n].numpy().view(np.uint64),
                                  ref.column(rid, cid))
            assert torch.all(dev[n:] == 0)
            assert np.array_equal(nat.dense_column(rid, cid),
                                  ref.dense_column(rid, cid))
