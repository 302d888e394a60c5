"""The torch port's equi-depth member (sigmod2018_tpu_torch/ops/qd_join.py)
held against the JAX package's (sigmod2018_tpu/ops/qd_join.py).

The cases of tests/test_qd_join.py go through the JAX member as its own
tests run it (Pallas interpret mode, padded to 4096 rows, SPb 16, H 8)
and through the port on the CPU, where the slot-fill and dual-count
kernels run their plain PyTorch twins.  Sums and counts are bit-exact,
and the port takes the same branch (kernel or merge) as the JAX member's
on-device condition."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sigmod2018_tpu.ops import qd_join as jqd
from sigmod2018_tpu_torch.ops import qd_join as tqd
from sigmod2018_tpu_torch.ops import radix_join as trj

MASK64 = (1 << 64) - 1
MAX64 = np.iinfo(np.uint64).max


def _t(a):
    return torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.uint64).view(np.int64))


def _pad(a, n=4096):
    out = np.zeros(n, dtype=np.uint64)
    out[:a.size] = a
    return out


def _padv(vs, n=4096):
    return (np.stack([_pad(v, n) for v in vs]) if vs
            else np.zeros((0, n), np.uint64))


def _result(r):
    count, sums_b, sums_p = (np.asarray(x.numpy() if isinstance(
        x, torch.Tensor) else x).astype(np.int64).view(np.uint64) for x in r)
    return (int(count) & MASK64, [int(s) for s in sums_b],
            [int(s) for s in sums_p])


def _oracle(bk, bv, pk, pv):
    order = np.argsort(bk, kind="stable")
    sk = bk[order]
    lo = np.searchsorted(sk, pk, "left")
    hi = np.searchsorted(sk, pk, "right")
    cnt = (hi - lo).astype(np.uint64)
    sums_b = []
    for v in bv:
        pref = np.concatenate([[np.uint64(0)],
                               np.cumsum(v[order], dtype=np.uint64)])
        sums_b.append(int(np.sum(pref[hi] - pref[lo], dtype=np.uint64))
                      & MASK64)
    sums_p = [int(np.sum(cnt * v, dtype=np.uint64)) & MASK64 for v in pv]
    return int(cnt.sum(dtype=np.uint64)), sums_b, sums_p


def _uniform(seed, nb, npr, keyspace):
    rng = np.random.default_rng(seed)
    bk = rng.integers(0, keyspace, nb, dtype=np.uint64)
    bv = [rng.integers(0, 1 << 40, nb, dtype=np.uint64) for _ in range(2)]
    pk = rng.integers(0, keyspace, npr, dtype=np.uint64)
    pv = [rng.integers(0, 1 << 40, npr, dtype=np.uint64)]
    return bk, bv, pk, pv


def _straddling():
    rng = np.random.default_rng(7)
    bk = np.repeat(rng.permutation(600).astype(np.uint64), 7)[:4000]
    bv = [rng.integers(0, 1 << 40, bk.size, dtype=np.uint64)]
    pk = rng.permutation(np.repeat(np.arange(600, dtype=np.uint64), 6))
    pv = [rng.integers(0, 1 << 40, pk.size, dtype=np.uint64)]
    return bk, bv, pk, pv


def _multiplicity():
    rng = np.random.default_rng(8)
    bk = np.concatenate([np.full(900, 7, np.uint64),
                         rng.integers(100, 400, 2000, dtype=np.uint64)])
    bv = [rng.integers(0, 1 << 40, bk.size, dtype=np.uint64)]
    pk = rng.integers(0, 400, 1500, dtype=np.uint64)
    pv = [rng.integers(0, 1 << 40, pk.size, dtype=np.uint64)]
    return bk, bv, pk, pv


def _probe_skew():
    rng = np.random.default_rng(9)
    bk = np.arange(3000, dtype=np.uint64)
    bv = [rng.integers(0, 1 << 40, 3000, dtype=np.uint64)]
    pk = np.full(3900, 5, np.uint64)
    pv = [rng.integers(0, 1 << 40, 3900, dtype=np.uint64)]
    return bk, bv, pk, pv


def _extreme():
    bk = np.array([0, MAX64, MAX64, 5], dtype=np.uint64)
    bv = [np.array([1, 2, 3, 4], dtype=np.uint64)]
    pk = np.array([MAX64, 5, 0, 7], dtype=np.uint64)
    pv = [np.array([10, 20, 30, 40], dtype=np.uint64)]
    return bk, bv, pk, pv


def _empty_build():
    pk = np.array([1, 2], dtype=np.uint64)
    return np.empty(0, np.uint64), [], pk, [np.array([7, 8], np.uint64)]


# case -> (inputs, the branch the JAX member's condition picks)
CASES = {
    "uniform": (lambda: _uniform(0, 3000, 3500, 400), "merge"),
    "tiny-build": (lambda: _uniform(2, 100, 3800, 40), "kernel"),
    "tiny-probe": (lambda: _uniform(3, 3800, 100, 5000), "kernel"),
    "huge-domain": (lambda: _uniform(4, 2000, 2000, 1 << 36), "kernel"),
    "straddling": (_straddling, "kernel"),
    "multiplicity-overflow": (_multiplicity, "merge"),
    "probe-skew": (_probe_skew, "merge"),
    "extreme-keys": (_extreme, "merge"),
    "empty-build": (_empty_build, "kernel"),
}


def _plan():
    return dict(zip(("SPb", "H", "SPp"),
                    jqd.qd_static_plan(4096, 4096, SPb=16, H=8)))


@pytest.fixture(scope="module")
def jax_results():
    """Every case through the JAX member once, in interpret mode."""
    out = {}
    for name, (make, _) in CASES.items():
        bk, bv, pk, pv = make()
        with pltpu.force_tpu_interpret_mode():
            r = jqd.qd_fused_static(
                jnp.asarray(_pad(bk)), jnp.asarray(_padv(bv)), bk.size,
                jnp.asarray(_pad(pk)), jnp.asarray(_padv(pv)), pk.size,
                limbs=2, **_plan())
        out[name] = _result(r)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_qd_matches_jax(jax_results, name):
    make, branch = CASES[name]
    bk, bv, pk, pv = make()
    before = dict(tqd.BRANCHES)
    got = _result(tqd.qd_fused_static(
        _t(_pad(bk)), _t(_padv(bv)), bk.size, _t(_pad(pk)), _t(_padv(pv)),
        torch.tensor(pk.size, dtype=torch.int32), **_plan()))
    assert got == jax_results[name] == _oracle(bk, bv, pk, pv)
    assert tqd.BRANCHES[branch] == before[branch] + 1


def test_qd_plan_matches_jax():
    for P in [1 << s for s in range(6, 25)]:
        for Pp in (P, 4 * P, max(P // 16, 1)):
            assert tqd.qd_static_plan(P, Pp) == jqd.qd_static_plan(P, Pp)
        assert tqd.qd_static_plan(P, P, SPb=16, H=8) == \
            jqd.qd_static_plan(P, P, SPb=16, H=8)
    # the TPU member's VMEM guard is not the port's limit
    assert tqd.qd_static_plan(1 << 25, 1 << 25)[:2] == (256, 64)
    with pytest.raises(ValueError, match="probe kernel"):
        tqd.qd_static_plan(1 << 16, 1 << 16, SPb=1 << 15, H=1 << 15)


@pytest.mark.parametrize("seed", [0, 1])
def test_qd_sort_side_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, P, SPb = 3000, 4096, 16
    keys = _pad(rng.integers(0, MAX64, 500, dtype=np.uint64,
                             endpoint=True)[rng.integers(0, 500, n)], P)
    vals = _padv([rng.integers(0, MAX64, n, dtype=np.uint64)], P)
    jk, jv = jqd._sort_side(jnp.asarray(keys), jnp.asarray(vals),
                            jnp.int32(n))
    tk, tv = tqd._sort_side(_t(keys), _t(vals), n)
    np.testing.assert_array_equal(tk.numpy().view(np.uint64), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy().view(np.uint64), np.asarray(jv))
    assert int(tqd._max_run_length(tk, n)) == \
        int(jqd._max_run_length(jk, jnp.int32(n)))
    qb = np.asarray(jk)[::SPb]
    np.testing.assert_array_equal(
        tqd._pstarts(tk, _t(qb), n).numpy(),
        np.asarray(jqd._pstarts(jk, jnp.asarray(qb), jnp.int32(n))))


def test_fused_join_auto_routes_qd(monkeypatch):
    calls = []
    real = tqd.qd_fused_static
    monkeypatch.setattr(tqd, "qd_fused_static",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    bk, bv, pk, pv = _uniform(4, 2000, 2000, 1 << 36)
    got = trj.fused_join_auto(_t(_pad(bk)), _t(_padv(bv)), bk.size,
                              _t(_pad(pk)), _t(_padv(pv)), pk.size,
                              algo="qd")
    assert calls == [dict(zip(("SPb", "H", "SPp"),
                              tqd.qd_static_plan(4096, 4096)))]
    assert _result(got) == _oracle(bk, bv, pk, pv)
