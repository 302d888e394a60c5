"""The port's storage helpers, row gathers and exports, held against the
JAX package:

- `store_relation_csv`, `dump_sql` and `make_identity_relation` write
  the JAX package's bytes, on tests/test_relation.py's cases (empty, one
  row, several columns, u64 max values, two table names);
- `gather_rows` and `checksum_many` give the JAX functions' values on
  seeded inputs (n_valid 0, 1 and P, u64 wrap-around, V = 1 and 3);
- every name in a JAX subpackage's `__all__` is in the port's
  counterpart's `__all__`, or in RENAMED.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigmod2018_tpu.ops import select as jselect
from sigmod2018_tpu.storage import relation as jrelation
from sigmod2018_tpu_torch.ops import select as tselect
from sigmod2018_tpu_torch.storage import relation as trelation

U64_MAX = 2**64 - 1


def _relation(module, case: str):
    """The relation of `case` built by `module`'s own helpers."""
    if case.startswith("identity"):  # identity-<rows>x<columns>
        rows, cols = map(int, case.split("-")[1].split("x"))
        return module.make_identity_relation(rows, cols)
    columns = {
        "empty": [np.empty(0, np.uint64), np.empty(0, np.uint64)],
        "one-row": [np.array([7], np.uint64), np.array([9], np.uint64),
                    np.array([11], np.uint64)],
        "u64-max": [np.array([1, 2, 3], np.uint64),
                    np.array([U64_MAX, 0, 42], np.uint64)],
    }[case]
    return module.Relation(columns=columns)


CASES = ["empty", "one-row", "identity-3x2", "identity-2x3", "identity-0x1",
         "u64-max"]


@pytest.mark.parametrize("case", CASES)
def test_store_relation_csv_bytes(tmp_path, case):
    jrelation.store_relation_csv(_relation(jrelation, case), tmp_path / "j")
    trelation.store_relation_csv(_relation(trelation, case), tmp_path / "t")
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    if case == "identity-3x2":  # tests/test_relation.py::test_csv_output
        assert (tmp_path / "t").read_text() == "0,0\n1,1\n2,2\n"


@pytest.mark.parametrize("table", ["r9", "lineitem"])
@pytest.mark.parametrize("case", CASES)
def test_dump_sql_bytes(tmp_path, case, table):
    jrelation.dump_sql(_relation(jrelation, case), tmp_path / "j", table)
    trelation.dump_sql(_relation(trelation, case), tmp_path / "t", table)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


@pytest.mark.parametrize("shape", [(5, 2), (0, 3), (1, 1)])
def test_make_identity_relation(tmp_path, shape):
    j = jrelation.make_identity_relation(*shape, name="r0")
    t = trelation.make_identity_relation(*shape, name="r0")
    assert (t.name, t.num_tuples, t.num_columns) == \
        (j.name, j.num_tuples, j.num_columns)
    for a, b in zip(t.columns, j.columns):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    t.columns[0][:1] = 99  # each column is its own copy
    assert all(c[:1].tolist() != [99] for c in t.columns[1:])
    jrelation.store_relation(j, tmp_path / "j")
    trelation.store_relation(trelation.make_identity_relation(*shape),
                             tmp_path / "t")
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("P,N", [(8, 16), (1, 1), (64, 1000)])
def test_gather_rows_matches_jax(P, N):
    rng = np.random.default_rng(P)
    row = rng.integers(0, U64_MAX, N, dtype=np.uint64, endpoint=True)
    pos = rng.integers(0, N, P).astype(np.int32)
    want = np.asarray(jselect.gather_rows(jnp.asarray(row), jnp.asarray(pos)))
    got = tselect.gather_rows(torch.from_numpy(row.view(np.int64)),
                              torch.from_numpy(pos))
    assert np.array_equal(_u64(got), want)


@pytest.mark.parametrize("V", [1, 3])
@pytest.mark.parametrize("n_valid", ["0", "1", "P"])
@pytest.mark.parametrize("high", [False, True], ids=["small", "wrap"])
def test_checksum_many_matches_jax(V, n_valid, high):
    """`high`: values near 2^64, so the sums wrap around."""
    P, N = 32, 50
    n = {"0": 0, "1": 1, "P": P}[n_valid]
    rng = np.random.default_rng(V * 100 + n)
    lo = U64_MAX - (1 << 20) if high else 0
    cols = rng.integers(lo, U64_MAX if high else 1000, (V, N),
                        dtype=np.uint64, endpoint=True)
    rowids = rng.integers(0, N, (V, P)).astype(np.int32)
    want = np.asarray(jselect.checksum_many(
        jnp.asarray(cols), jnp.asarray(rowids), jnp.int32(n)))
    if high and n > 1:
        assert (cols.astype(object)[0, rowids[0, :n]].sum()
                >= 1 << 64), "the case must wrap"
    for count in (n, torch.tensor(n, dtype=torch.int32)):
        got = tselect.checksum_many(torch.from_numpy(cols.view(np.int64)),
                                    torch.from_numpy(rowids), count)
        assert got.shape == (V,)
        assert np.array_equal(_u64(got), want)


# JAX name -> the port's name for it, per subpackage.  Every other name
# of a JAX `__all__` must be in the port's under the same name.
RENAMED = {
    "engine": {"JaxEngine": "TorchEngine"},
}
SUBPACKAGES = ["engine", "frontend", "io", "ops", "parallel", "planner",
               "storage", "utils"]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_exports_match_the_jax_package(sub):
    jax_all = importlib.import_module(f"sigmod2018_tpu.{sub}").__all__
    port = importlib.import_module(f"sigmod2018_tpu_torch.{sub}")
    renamed = RENAMED.get(sub, {})
    missing = [name for name in jax_all
               if renamed.get(name, name) not in port.__all__]
    assert not missing, f"sigmod2018_tpu_torch.{sub} lacks {missing}"
    for name in port.__all__:
        assert getattr(port, name) is not None
