"""The torch port stands alone: it imports with `jax` blocked, no module
of it imports jax, its relation generator writes the reference
generator's bytes, and (on a machine with a card) its CUDA kernels agree
with their plain PyTorch versions."""

import ast
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sigmod2018_tpu_torch.tools.workload import write_relations, zipf_draws

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "sigmod2018_tpu_torch"

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys

class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax is blocked in this process")

sys.meta_path.insert(0, _NoJax())
import sigmod2018_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
print(len(names))
"""


def test_imports_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 50  # every module was imported


@pytest.mark.parametrize("module", ["frontend.sql", "engine.oracle",
                                    "engine.factorized", "engine.trace",
                                    "utils.floors", "storage.native",
                                    "storage.catalog", "io.repl"])
def test_blowup_path_modules_import_with_jax_blocked(module):
    """The modules of the blow-up path and of the serving process's prep
    and instruments, each on its own in a fresh process: the oracle and
    the NumPy twin need no torch device either, and importing the native
    loader builds nothing."""
    _import_alone(module)


@pytest.mark.parametrize("module", ["parallel", "parallel.mesh",
                                    "parallel.collectives", "parallel.dist",
                                    "parallel.dist_engine",
                                    "parallel.dist_compiled",
                                    "parallel.multihost",
                                    "parallel.launch"])
def test_mesh_modules_import_with_jax_blocked(module):
    """The mesh path's modules, each on its own in a fresh process, with
    neither jax nor the JAX package importable."""
    _import_alone(module)


@pytest.mark.parametrize("module", ["tools.fuzz", "tools.soak", "tools.smoke",
                                    "tools.microbench", "tools.roofline",
                                    "tools.bench_probe", "tools.query2sql",
                                    "tools.collective_cost",
                                    "utils.timing"])
def test_tool_modules_import_with_jax_blocked(module):
    """The tools and their shared timer, each on its own in a fresh
    process: importing one builds nothing and touches no device."""
    _import_alone(module)


@pytest.mark.parametrize("module", ["config", "engine", "engine.oracle",
                                    "engine.factorized", "io.repl",
                                    "storage.catalog", "frontend.parser"])
def test_host_modules_import_with_torch_blocked(module):
    """The driver's path up to the catalog load and its warm-up tier's
    host answers, each on its own in a fresh process with neither jax
    nor torch importable: `python -m sigmod2018_tpu_torch` imports torch
    only in the thread that starts the card."""
    _import_alone(module, torch_too=True)


def _import_alone(module: str, torch_too: bool = False) -> None:
    code = _BLOCKED_IMPORT.split("import sigmod2018_tpu_torch")[0]
    barred = ("sigmod2018_tpu",)
    if torch_too:
        code = code.replace('name.startswith(("jax.", "jaxlib"))',
                            'name.startswith(("jax.", "jaxlib")) or '
                            'name.split(".")[0] == "torch"')
        barred += ("torch",)
    code += (
        f"import importlib\n"
        f"m = importlib.import_module('sigmod2018_tpu_torch.{module}')\n"
        f"assert not any(n == 'jax' or n.startswith('jax.') "
        f"or n.split('.')[0] in {barred!r} for n in sys.modules)\n"
        f"print(m.__name__)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == f"sigmod2018_tpu_torch.{module}"


def test_no_module_imports_jax():
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(n.split(".")[0] in ("jax", "jaxlib", "sigmod2018_tpu")
                           for n in names), (path, names)


# (seed, draws made before, size) -> sha1 of the draws clipped to 2^20 as
# uint64, taken with NumPy 2.0.2's Generator.zipf(1.3, size)
ZIPF_DIGESTS = {
    (13, 5, 1_000_000): "de752d86edf52f49f7894c17b0f6718ca80cfc54",
    (4, 5, 12_345): "49481c55ec35f9c17311074e53eedb4c9bc6e8c4",
    (1, 5, 7): "3b6bf7fba8ea03ce5aaf1199d57d12c78b16028d",
}


@pytest.mark.parametrize("seed,before,size", list(ZIPF_DIGESTS))
def test_zipf_draws_are_the_legacy_sampler(seed, before, size):
    """The generator's own zipf sampler gives the values of NumPy up to
    2.0 whatever NumPy runs it (Generator.zipf changed in 2.1, and the
    committed .result files were made before), and leaves the stream
    where that call leaves it."""
    rng = np.random.default_rng(seed)
    rng.integers(0, 1000, before)
    got = zipf_draws(rng, 1.3, size)
    clipped = np.minimum(got, 1 << 20).astype(np.uint64)
    assert hashlib.sha1(clipped.tobytes()).hexdigest() == \
        ZIPF_DIGESTS[seed, before, size]
    assert got.dtype == np.int64 and got.min() >= 1
    if np.lib.NumpyVersion(np.__version__) < "2.1.0":
        ref = np.random.default_rng(seed)
        ref.integers(0, 1000, before)
        assert np.array_equal(got, ref.zipf(1.3, size=size))
        assert rng.bit_generator.state == ref.bit_generator.state


@pytest.mark.parametrize("profile,seed", [("uniform", 7), ("bigdom", 11),
                                          ("zipfbig", 13), ("zipf", 4),
                                          ("scaled", 3)])
def test_generator_matches_reference_tool(tmp_path, profile, seed):
    """The workloads' parameters at 5,000 rows: tools/gen_workload.py and
    the port write identical relation files.  The zipf profiles hold
    under NumPy up to 2.0, whose sampler the port's generator copies."""
    if (profile.startswith("zipf")
            and np.lib.NumpyVersion(np.__version__) >= "2.1.0"):
        pytest.skip("the reference tool draws Generator.zipf, which "
                    "changed in NumPy 2.1")
    args = ["--profile", profile, "--rows", "5000", "--relations", "4",
            "--keyspace", "1048576", "--seed", str(seed)]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "tools/gen_workload.py", str(tmp_path / "ref"),
         *args, "--queries", "1", "--batch", "1", "--cap", "30000000"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    paths = write_relations(tmp_path / "port", profile, 5000, 4, 1048576,
                            seed)
    assert [p.name for p in paths] == ["r0", "r1", "r2", "r3"]
    for p in paths:
        assert p.read_bytes() == (tmp_path / "ref" / p.name).read_bytes(), p


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The hand-written kernel against its plain twin on the card, at
    shapes that cover a staged window, a hot key past the window, live
    2^64-1 keys, device-side counts and empty sides."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run python3 chip_smoke.py there)")
    from sigmod2018_tpu_torch.ops import ms_join
    from sigmod2018_tpu_torch.ops.sort_join import join_build

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    P = 1 << 16
    for dom, hot in ((1 << 12, 0), (1 << 62, 0), (1 << 12, 20000)):
        keys = [torch.randint(0, dom, (P,), device=dev, generator=gen)
                for _ in range(2)]
        if hot:
            keys[0][:hot] = -1
            keys[1][:hot] = -1
        for nb, npr in ((P - 5, P - 7), (0, P), (P, 0)):
            kb, _ = join_build(keys[0], nb)
            kp, _ = join_build(keys[1], npr)
            before = ms_join.LAUNCHES
            got = ms_join.staircase_counts(kb, nb, kp, npr)
            got_t = ms_join.staircase_counts(
                kb, torch.tensor(nb, device=dev), kp, npr)
            want = ms_join.staircase_counts_plain(kb, nb, kp, npr)
            # the bounds pass and the merge pass; the merge pass alone
            # when host counts leave no live row
            assert ms_join.LAUNCHES == before + (2 if nb and npr else 1) + 2
            for g in (got, got_t):
                assert torch.equal(g[0], want[0])
                m = want[0] > 0
                assert torch.equal(g[1][m], want[1][m])


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """K4 and K5 against their plain twins on the card: a radix prep of
    full-range keys, a window at the shared-memory limit's order
    (9,216 slots), empty windows, and count launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run python3 chip_smoke.py there)")
    from sigmod2018_tpu_torch.ops import radix_join as trj

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    n, bits, P = 60000, 6, 1 << 16
    pool = torch.randint(-(1 << 63), (1 << 63) - 1, (300,), device=dev,
                         generator=gen)
    pool[0] = -1  # live keys 2^64-1
    k = pool[torch.randint(0, 300, (P,), device=dev, generator=gen)]
    vals = torch.randint(-(1 << 63), (1 << 63) - 1, (1, P), device=dev,
                         generator=gen)
    ks, vs, st, ct, _ = trj._prep_side(k, vals, n, bits)
    SP = 3072
    before = dict(trj.LAUNCHES)
    got = trj.slot_fill(st, ct, [ks, vs[0]], SP)
    assert torch.equal(got, trj.slot_fill_plain(st, ct, [ks, vs[0]], SP))
    win = torch.stack([torch.zeros_like(ct), ct], 1)
    win[1] = 0  # an empty window
    for kb, wb, kp, wp in [(got[0], win, got[0], win),
                           (torch.full((1, 9216), 5, device=dev),
                            torch.tensor([[0, 9216]], dtype=torch.int32,
                                         device=dev),
                            torch.full((1, 9216), 5, device=dev),
                            torch.tensor([[16, 9200]], dtype=torch.int32,
                                         device=dev))]:
        mc, pc = trj.probe_counts(kb, wb, kp, wp)
        wmc, wpc = trj.probe_counts_plain(kb, wb, kp, wp)
        assert torch.equal(mc, wmc) and torch.equal(pc, wpc)
    assert trj.LAUNCHES["slot_fill"] == before["slot_fill"] + 1
    assert trj.LAUNCHES["probe_counts"] == before["probe_counts"] + 2
