"""The routing thresholds S18_EMIT_MS_MIN and S18_RADIX_MIN, held against
the JAX package:

- parsed at import in fresh processes: for each tested value the port's
  module constants equal the JAX package's, and a value `int()` refuses
  fails the import of both, the port's error naming the variable;
- routing, by setting the port's module globals: intermediate joins take
  the staircase counting member (`join_probe_count_ms`) past
  EMIT_MS_MIN_ROWS and never under 2^62, fused joins flip to the
  staircase member with RADIX_MIN_ROWS, and the lines equal the JAX
  `JaxEngine`'s at its defaults and the NumPy oracle's;
- S18_EMIT_MS_FORCE has no counterpart: at the threshold the port's
  auto takes the staircase's plain twin on the CPU with no switch set,
  and setting the switch changes neither the member nor the lines.

The catalog is tests/test_ms_engine.py::test_emitting_ms_path_through_
engine's (3 relations x 3 columns x 3000 rows, keys below 300, seed 21).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sigmod2018_tpu.config import EngineConfig as JaxConfig
from sigmod2018_tpu.engine.executor import JaxEngine
from sigmod2018_tpu.engine.oracle import execute_query_numpy
from sigmod2018_tpu.frontend.parser import parse_query as jax_parse
from sigmod2018_tpu.storage.catalog import Catalog as JaxCatalog
from sigmod2018_tpu.storage.relation import Relation as JaxRelation
from sigmod2018_tpu_torch.config import EngineConfig
from sigmod2018_tpu_torch.engine.compiled import CompiledTorchEngine
from sigmod2018_tpu_torch.engine.executor import TorchEngine
from sigmod2018_tpu_torch.frontend.parser import parse_query
from sigmod2018_tpu_torch.ops import ms_join, radix_join, sort_join
from sigmod2018_tpu_torch.storage.catalog import Catalog
from sigmod2018_tpu_torch.storage.relation import Relation
from sigmod2018_tpu_torch.tools import bench_probe

ROOT = Path(__file__).resolve().parent.parent
HUGE = 1 << 62  # no padded size reaches it: the staircase never serves

# tests/test_ms_engine.py's QUERIES and the multi-join texts of its
# test_emitting_ms_path_through_engine
MULTI_JOIN = ["0 1 2|0.0=1.0&1.1=2.1|0.2 2.0",
              "0 1 2|0.0=1.0&1.1=2.1&0.1>100|0.2 2.0"]
TEXTS = ["0 1|0.0=1.0|0.1 1.2",
         "0 1|0.0=1.0&0.1>250|1.1",
         "2 0|0.2=1.2&0.0<100|0.0 1.0",
         "1 1|0.1=1.2&0.2<300|1.1 0.2"] + MULTI_JOIN

# Each fresh process reads both modules' constants of its package and
# prints them as JSON; a refused value prints the import's ValueError.
READ_CONSTANTS = """
import importlib, json, sys
pkg = sys.argv[1]
try:
    ms = importlib.import_module(pkg + ".ops.ms_join")
    rj = importlib.import_module(pkg + ".ops.radix_join")
except ValueError as exc:
    print(json.dumps({"error": str(exc)}))
else:
    print(json.dumps({"EMIT_MS_MIN_ROWS": ms.EMIT_MS_MIN_ROWS,
                      "RADIX_MIN_ROWS": rj.RADIX_MIN_ROWS}))
"""

# unset (None), and values int() takes, down to those where every size
# takes the staircase
VALUES = [None, "0", "-1", "1024", "4194304"]
REFUSED = ["abc", "1.5", ""]
SWITCHES = ("S18_EMIT_MS_MIN", "S18_RADIX_MIN")


def _read_constants(env_values: dict) -> dict:
    """{package: its printed JSON} of READ_CONSTANTS under the switches
    `env_values` (None: unset), both packages' processes run together."""
    env = {k: v for k, v in os.environ.items() if k not in SWITCHES}
    env.update({k: v for k, v in env_values.items() if v is not None},
               PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", READ_CONSTANTS, pkg], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("sigmod2018_tpu", "sigmod2018_tpu_torch")}
    out = {}
    for pkg, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=120)
        assert proc.returncode == 0, stderr
        out[pkg] = json.loads(stdout.splitlines()[-1])
    return out


@pytest.mark.parametrize("i", range(len(VALUES)),
                         ids=[str(v) for v in VALUES])
def test_constants_equal_the_jax_packages(i):
    """S18_EMIT_MS_MIN takes VALUES[i] and S18_RADIX_MIN the next value,
    so over the cases each switch takes every value and a switch read
    under the other's name shows."""
    env_values = {"S18_EMIT_MS_MIN": VALUES[i],
                  "S18_RADIX_MIN": VALUES[(i + 1) % len(VALUES)]}
    got = _read_constants(env_values)
    assert got["sigmod2018_tpu_torch"] == got["sigmod2018_tpu"]
    for name, value in (("EMIT_MS_MIN_ROWS", env_values["S18_EMIT_MS_MIN"]),
                        ("RADIX_MIN_ROWS", env_values["S18_RADIX_MIN"])):
        want = 1 << 18 if value is None else int(value)
        assert got["sigmod2018_tpu_torch"][name] == want


@pytest.mark.parametrize("value", REFUSED)
def test_refused_values_fail_both_imports(value):
    for switch in SWITCHES:
        got = _read_constants({switch: value})
        assert "error" in got["sigmod2018_tpu"], (switch, got)
        assert got["sigmod2018_tpu_torch"]["error"] == (
            f"{switch}={value!r}: expected an integer")


@pytest.fixture(scope="module")
def catalogs():
    rng = np.random.default_rng(21)
    cols = [[rng.integers(0, 300, 3000).astype(np.uint64) for _ in range(3)]
            for _ in range(3)]
    return (Catalog([Relation(columns=c) for c in cols]),
            JaxCatalog([JaxRelation(columns=c) for c in cols]))


@pytest.fixture(scope="module")
def expected(catalogs):
    """The NumPy oracle's lines, which the JAX JaxEngine at its defaults
    must give too."""
    jcat = catalogs[1]
    want = [execute_query_numpy(jax_parse(t), jcat) for t in TEXTS]
    eng = JaxEngine(jcat, dataclasses.replace(JaxConfig(),
                                              compile_queries=False))
    eng.prefetch()
    assert [eng.execute(jax_parse(t)) for t in TEXTS] == want
    return want


def _lines(engine_cls, cat, **cfg) -> list:
    eng = engine_cls(cat, EngineConfig(platform="cpu", **cfg))
    eng.prefetch()
    return [eng.execute(parse_query(t)) for t in TEXTS]


def _spy(monkeypatch, module, name) -> list:
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("engine_cls", [CompiledTorchEngine, TorchEngine])
@pytest.mark.parametrize("emit_min", [256, HUGE])
def test_emit_threshold_routes_intermediate_joins(catalogs, expected,
                                                  monkeypatch, engine_cls,
                                                  emit_min):
    """Key tables off: they would serve the intermediate joins instead of
    the sorted counting members."""
    monkeypatch.setattr(ms_join, "EMIT_MS_MIN_ROWS", emit_min)
    calls = _spy(monkeypatch, ms_join, "join_probe_count_ms")
    assert _lines(engine_cls, catalogs[0], key_table_max=0) == expected
    assert bool(calls) == (emit_min == 256), len(calls)


@pytest.mark.parametrize("radix_min", [0, HUGE])
def test_radix_threshold_flips_the_fused_member(catalogs, expected,
                                                monkeypatch, radix_min):
    monkeypatch.setattr(radix_join, "RADIX_MIN_ROWS", radix_min)
    for P in (1024, 1 << 21):
        assert radix_join.ms_member_selected(P, P, "auto") == (radix_min
                                                               == 0)
    calls = _spy(monkeypatch, radix_join, "ms_fused")
    for key_table_max in (1 << 22, 0):
        assert _lines(CompiledTorchEngine, catalogs[0],
                      key_table_max=key_table_max) == expected
    assert bool(calls) == (radix_min == 0)
    # forced radix builds its prep artifacts only for columns this large
    eng = TorchEngine(catalogs[0], EngineConfig(platform="cpu",
                                                join_algo="radix",
                                                key_table_max=0))
    eng.prefetch()
    assert (eng.device_radix_keys(0, 0) is not None) == (radix_min == 0)


@pytest.mark.parametrize("force", [None, "1", "0"])
def test_emit_ms_force_changes_nothing(catalogs, expected, monkeypatch,
                                       force):
    """The JAX package needs S18_EMIT_MS_FORCE=1 off the TPU to run its
    at-scale counts in the kernel (interpret mode); the port's auto takes
    the staircase at the threshold on any device, its plain twin on the
    CPU, whatever the switch says."""
    if force is None:
        monkeypatch.delenv("S18_EMIT_MS_FORCE", raising=False)
    else:
        monkeypatch.setenv("S18_EMIT_MS_FORCE", force)
    monkeypatch.setattr(ms_join, "EMIT_MS_MIN_ROWS", 256)
    plain = _spy(monkeypatch, ms_join, "staircase_counts_plain")
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 100, 256).astype(np.uint64).view(np.int64)
    k = torch.from_numpy(keys)
    sk, _ = sort_join.join_build(k, 256)
    got = ms_join.join_probe_count_auto(sk, 256, k, 256)
    assert len(plain) == 1
    want = sort_join.join_probe_count(sk, 256, k, 256)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert _lines(CompiledTorchEngine, catalogs[0],
                  key_table_max=0) == expected
    assert len(plain) > 1


def test_bench_probe_prints_the_thresholds_in_force(monkeypatch, capsys):
    monkeypatch.setattr(ms_join, "EMIT_MS_MIN_ROWS", 0)
    monkeypatch.setattr(radix_join, "RADIX_MIN_ROWS", 1 << 20)
    bench_probe.run(10, 10, "cpu", reps=1)
    out = capsys.readouterr().out
    assert "(EMIT_MS_MIN_ROWS = 0)" in out
    assert "(RADIX_MIN_ROWS = 2^20)" in out
