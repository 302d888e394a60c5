"""The port's native loader (sigmod2018_tpu_torch/storage/native): its
stats equal the JAX package's `compute_column_stats` in all six fields,
mode included; empty relations; a corrupt header is refused; S18_NATIVE=0
takes the NumPy path; concurrent builds leave one library; a missing or
failing compiler raises instead of falling back."""

import dataclasses
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sigmod2018_tpu.storage.catalog import \
    compute_column_stats as jax_column_stats
from sigmod2018_tpu_torch.config import EngineConfig
from sigmod2018_tpu_torch.io.repl import run_protocol
from sigmod2018_tpu_torch.storage import native
from sigmod2018_tpu_torch.storage.catalog import Catalog, compute_column_stats
from sigmod2018_tpu_torch.storage.relation import Relation, store_relation

ROOT = Path(__file__).resolve().parent.parent
TOP = (1 << 64) - 1


def _store(path, cols) -> str:
    store_relation(Relation([np.asarray(c, dtype=np.uint64) for c in cols]),
                   path)
    return str(path)


def _columns(case: str):
    rng = np.random.default_rng(11)
    if case == "ties":
        # 3 and 7 and 9 all appear 3 times: the smallest (3) is the mode
        return [[9, 7, 3, 7, 3, 9, 3, 7, 9, 1], [5, 5, 2, 2, 8, 8, 0, 1, 1, 0]]
    if case == "random ties":
        # every value of a small domain the same number of times
        base = np.repeat(np.arange(40, dtype=np.uint64) * 977, 25)
        return [rng.permutation(base), rng.integers(0, 50, 1000)]
    if case == "high keys":
        # modes and bounds past 2^63, live 2^64-1 keys
        hi = np.array([TOP, TOP - 1, 1 << 63, (1 << 63) + 5], dtype=np.uint64)
        return [rng.choice(hi, 777), np.full(777, TOP, dtype=np.uint64)]
    if case == "one row":
        return [[42], [0], [TOP]]
    if case == "digits":
        # keys that differ in one 11-bit digit only, in several digits,
        # and over the whole word: every pass of the radix sort, skipped
        # or not
        k = rng.integers(0, 2048, 3000, dtype=np.uint64)
        return [k << np.uint64(44), (k << np.uint64(55)) | np.uint64(7),
                (k << np.uint64(22)) ^ (k << np.uint64(3)),
                rng.integers(0, TOP, 3000, dtype=np.uint64, endpoint=True)]
    if case == "zipf":
        return [np.minimum(rng.zipf(1.3, 5000), 1 << 40),
                rng.integers(0, 1 << 62, 5000)]
    raise ValueError(case)


CASES = ["ties", "random ties", "high keys", "one row", "digits", "zipf"]


@pytest.mark.parametrize("case", CASES)
def test_native_stats_equal_jax(tmp_path, case):
    cols = _columns(case)
    (rel, stats), = native.load_relations_native(
        [_store(tmp_path / "r", cols)])
    assert rel.num_columns == len(cols)
    for c, col in enumerate(cols):
        col = np.asarray(col, dtype=np.uint64)
        assert np.array_equal(rel.columns[c], col)
        want = dataclasses.astuple(jax_column_stats(col))
        assert dataclasses.astuple(stats[c]) == want
        assert dataclasses.astuple(compute_column_stats(col)) == want


@pytest.mark.parametrize("tuples,cols", [(0, 3), (5, 0)])
def test_native_empty_relation(tmp_path, tuples, cols):
    path = tmp_path / "r"
    path.write_bytes(np.array([tuples, cols], dtype="<u8").tobytes())
    (rel, stats), = native.load_relations_native([str(path)])
    assert (rel.num_tuples, rel.num_columns) == (0, cols)
    want = [compute_column_stats(np.empty(0, dtype=np.uint64))] * cols
    assert stats == want
    assert Catalog.from_files([str(path)]).stats == [want]


def test_native_columns_are_read_only_views(tmp_path):
    (rel, _), = native.load_relations_native(
        [_store(tmp_path / "r", _columns("zipf"))])
    col = rel.columns[1]
    assert not col.flags.writeable and not col.flags.owndata
    with pytest.raises(ValueError):
        col[0] = 1


@pytest.mark.parametrize("tuples", [1 << 61, (1 << 64) - 1, 7])
def test_overflowing_header_is_refused(tmp_path, tuples):
    """tuples * cols * 8 past 2^64 must not wrap into a passing bounds
    check; a plainly short file is refused the same way (-5)."""
    path = tmp_path / "bad"
    path.write_bytes(np.array([tuples, 8, 1, 2, 3], dtype="<u8").tobytes())
    with pytest.raises(ValueError, match=r"native load failed \(-5\)"):
        native.load_relations_native([str(path)])


def _two_relation_stream(tmp_path) -> str:
    rng = np.random.default_rng(3)
    paths = [_store(tmp_path / f"r{i}", [rng.integers(0, 300, 2000)
                                         for _ in range(3)])
             for i in range(2)]
    return "\n".join(paths + ["Done", "0 1|0.0=1.0|0.1 1.2", "F"]) + "\n"


@pytest.mark.parametrize("setting,native_calls", [("0", 0), ("1", 1)])
def test_s18_native_selects_the_path(tmp_path, monkeypatch, setting,
                                     native_calls):
    monkeypatch.setenv("S18_NATIVE", setting)
    monkeypatch.setenv("S18_PLATFORM", "cpu")
    monkeypatch.setenv("S18_PREP_CACHE", "0")
    calls = []
    real = native.load_relations_native
    monkeypatch.setattr(native, "load_relations_native",
                        lambda paths: calls.append(paths) or real(paths))
    config = EngineConfig.from_env()
    assert config.native == (setting != "0")
    out = io.StringIO()
    run_protocol(io.StringIO(_two_relation_stream(tmp_path)), out, config)
    assert len(calls) == native_calls
    numpy_out = io.StringIO()
    run_protocol(io.StringIO(_two_relation_stream(tmp_path)), numpy_out,
                 EngineConfig(platform="cpu", native=False))
    assert out.getvalue() == numpy_out.getvalue() != ""


_RACER = """
import sys, time
from pathlib import Path
from sigmod2018_tpu_torch.storage import native
native.BUILD_DIR = Path(sys.argv[1])
print("ready", flush=True)
go = Path(sys.argv[2])
while not go.exists():
    time.sleep(0.005)
native.load()
print(native.library_path().name, flush=True)
"""


def test_concurrent_builds_leave_one_library(tmp_path):
    build_dir, go = tmp_path / "native", tmp_path / "go"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", _RACER, str(build_dir),
                               str(go)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    try:
        for p in procs:
            assert p.stdout.readline().strip() == "ready"
        go.touch()  # both build from here on
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    names = {o[0].strip() for o in outs}
    assert names == {native.library_path().name}
    assert [f.name for f in build_dir.iterdir()] == list(names)  # no temps
    import ctypes

    ctypes.CDLL(str(build_dir / names.pop())).s18_stats  # loadable


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        native.load()
    path = _store(tmp_path / "r", [[1, 2, 3]])
    monkeypatch.setenv("S18_PREP_CACHE", "0")
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        Catalog.from_files([path])  # no quiet NumPy fallback
    assert Catalog.from_files([path], native=False).stats[0][0].u == 3
    assert not any((tmp_path / "native").iterdir())  # no temp left


def test_failing_compile_raises_with_its_output(tmp_path, monkeypatch):
    bad = tmp_path / "loader.cpp"
    bad.write_text("int s18_load( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed .*error"):
        native.load()
    assert not any((tmp_path / "native").iterdir())


def test_library_is_named_by_its_source(tmp_path, monkeypatch):
    src = tmp_path / "loader.cpp"
    src.write_bytes(native.SOURCE.read_bytes())
    monkeypatch.setattr(native, "SOURCE", src)
    first = native.library_path()
    src.write_bytes(src.read_bytes() + b"\n// changed\n")
    assert native.library_path() != first
    assert first.parent == native.BUILD_DIR == ROOT / "build" / "native"
