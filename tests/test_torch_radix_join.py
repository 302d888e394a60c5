"""The torch port's radix member (sigmod2018_tpu_torch/ops/radix_join.py)
held against the JAX package's (sigmod2018_tpu/ops/radix_join.py).

The same seeded numpy inputs go through the JAX functions, run as
tests/test_radix_join.py runs them (Pallas interpret mode, padded to
4096 rows), and through the port on the CPU, where its kernel wrappers
run their plain PyTorch twins.  Everything is integer and bit-exact.
Each JAX interpret-mode call of the radix member takes tens of seconds,
so each runs once, in a module-scoped fixture."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sigmod2018_tpu.ops import radix_join as jrj
from sigmod2018_tpu_torch.ops import radix_join as trj

MASK64 = (1 << 64) - 1
MAX64 = np.iinfo(np.uint64).max
PAD_TO = 4096


def _t(a):
    """u64 numpy -> the port's int64 bit-pattern tensor."""
    return torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.uint64).view(np.int64))


def _u(x):
    """Port tensor or JAX array -> uint64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint64) if x.dtype == torch.int64 \
            else x.numpy()
    return np.asarray(x)


def _pad(a, n=PAD_TO):
    out = np.zeros(n, dtype=np.uint64)
    out[:a.size] = a
    return out


def _padv(vs, n=PAD_TO):
    return (np.stack([_pad(v, n) for v in vs]) if vs
            else np.zeros((0, n), np.uint64))


def _result(r):
    count, sums_b, sums_p = r
    return (int(_u(count).astype(np.uint64)) & MASK64,
            [int(s) & MASK64 for s in _u(sums_b)],
            [int(s) & MASK64 for s in _u(sums_p)])


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


def _port_args(bk, bv, pk, pv):
    return (_t(_pad(bk)), _t(_padv(bv)), bk.size, _t(_pad(pk)),
            _t(_padv(pv)), pk.size)


def _jax_args(bk, bv, pk, pv):
    return (jnp.asarray(_pad(bk)), jnp.asarray(_padv(bv)), bk.size,
            jnp.asarray(_pad(pk)), jnp.asarray(_padv(pv)), pk.size)


# ---- plans -----------------------------------------------------------------


def test_plans_match_jax():
    for P in [1 << s for s in range(8, 27)] + [3000, 12345]:
        assert trj.plan_bits(P) == jrj.plan_bits(P)
        for Pp in (P, P * 4, max(P // 8, 1)):
            assert trj.static_radix_plan(P, Pp) == \
                jrj.static_radix_plan(P, Pp)
        assert trj.choose_bits(P, P) == jrj.choose_bits(P, P)
        for algo in ("auto", "radix", "qd", "ms", "sort"):
            assert trj.radix_member_selected(P, P, algo) == \
                jrj.radix_member_selected(P, P, algo)


# ---- the sort side ----------------------------------------------------------


def _full_range_keys(rng, n):
    """Keys over the whole u64 range with duplicates and live 2^64-1."""
    pool = rng.integers(0, MAX64, 300, dtype=np.uint64, endpoint=True)
    pool[:3] = [MAX64, 0, 1 << 63]
    return rng.choice(pool, n)


@pytest.mark.parametrize("bits", [1, 6, 12])
def test_rotate_matches_jax(bits):
    k = _full_range_keys(np.random.default_rng(bits), 2000)
    np.testing.assert_array_equal(_u(trj._rotate(_t(k), bits)),
                                  np.asarray(jrj._rotate(jnp.asarray(k),
                                                         bits)))


@pytest.mark.parametrize("n,bits", [(3000, 6), (4096, 4), (0, 6), (1, 8)])
def test_prep_side_matches_jax(n, bits):
    rng = np.random.default_rng(n + bits)
    k = _pad(_full_range_keys(rng, n))
    vals = _padv([rng.integers(0, MAX64, n, dtype=np.uint64,
                               endpoint=True) for _ in range(2)])
    want = jrj._prep_side(jnp.asarray(k), jnp.asarray(vals), jnp.int32(n),
                          bits)
    got = trj._prep_side(_t(k), _t(vals), n, bits)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u(g), np.asarray(w))
    # the prep-time half, with the count as a 0-d tensor
    pre = trj.radix_prep_keys(_t(k), torch.tensor(n, dtype=torch.int32),
                              bits)
    jpre = jrj.radix_prep_keys(jnp.asarray(k), jnp.int32(n), bits)
    for g, w in zip(pre, jpre):
        np.testing.assert_array_equal(_u(g), np.asarray(w))


# ---- K4 and K5 against the Pallas kernels ------------------------------------


def _limbs(a):
    a = np.asarray(a, dtype=np.uint64)
    return ((a >> np.uint64(32)).astype(np.uint32),
            (a & np.uint64(0xFFFFFFFF)).astype(np.uint32))


@pytest.fixture(scope="module")
def slotfill_case():
    """A real radix prep of 3000 full-range keys and two value columns
    (bits 6: 64 buckets), slot-filled by the JAX kernel."""
    rng = np.random.default_rng(41)
    n, bits, SP = 3000, 6, 2048
    k = _pad(_full_range_keys(rng, n))
    vals = _padv([rng.integers(0, MAX64, n, dtype=np.uint64, endpoint=True)
                  for _ in range(2)])
    ks, vs, st, ct, _ = jrj._prep_side(jnp.asarray(k), jnp.asarray(vals),
                                       jnp.int32(n), bits)
    arrays = [np.asarray(ks)] + [np.asarray(v) for v in vs]
    srcs = []
    for a in arrays:
        hi, lo = _limbs(a)
        srcs += [jrj._pad_align(jnp.asarray(hi), SP),
                 jrj._pad_align(jnp.asarray(lo), SP)]
    with pltpu.force_tpu_interpret_mode():
        mats = jrj._slotfill(st, tuple(srcs), 1 << bits, SP)
    want = [(np.asarray(mats[2 * i]).astype(np.uint64) << np.uint64(32))
            | np.asarray(mats[2 * i + 1]).astype(np.uint64)
            for i in range(len(arrays))]
    return arrays, np.array(st), np.array(ct), SP, want


def test_slot_fill_matches_jax_kernel(slotfill_case):
    arrays, st, ct, SP, want = slotfill_case
    got = _u(trj.slot_fill(torch.from_numpy(st), torch.from_numpy(ct),
                           [_t(a) for a in arrays], SP))
    assert got.shape == (len(arrays), st.size, SP)
    off = st % jrj.ALIGN  # the TPU window sits at the DMA head offset
    for b in range(st.size):
        c = int(ct[b])
        for i in range(len(arrays)):
            np.testing.assert_array_equal(got[i, b, :c],
                                          want[i][b, off[b]:off[b] + c])
    # outside the windows the port's slots are 0
    live = np.arange(SP)[None, :] < ct[:, None]
    assert not got[:, ~live].any()


def test_slot_fill_reads_past_source_as_zero():
    src = _t(np.arange(1, 11, dtype=np.uint64))
    out = trj.slot_fill(torch.tensor([8, 0], dtype=torch.int32),
                        torch.tensor([5, 3], dtype=torch.int32), [src], 4)
    np.testing.assert_array_equal(out[0].numpy(), [[9, 10, 0, 0],
                                                   [1, 2, 3, 0]])


def _probe_case(seed, B=128, Sb=64, Sp=96):
    """Bucket-major key matrices whose keys share low limbs across high
    limbs (so a one-limb compare would over-count), random windows."""
    rng = np.random.default_rng(seed)
    kb = ((rng.integers(0, 3, (B, Sb)).astype(np.uint64) << np.uint64(40))
          | rng.integers(0, 6, (B, Sb)).astype(np.uint64))
    kp = ((rng.integers(0, 3, (B, Sp)).astype(np.uint64) << np.uint64(40))
          | rng.integers(0, 6, (B, Sp)).astype(np.uint64))
    kb[0, :] = MAX64
    kp[0, :5] = MAX64
    wb = np.stack([rng.integers(0, 20, B), rng.integers(10, Sb + 1, B)], 1)
    wp = np.stack([rng.integers(0, 30, B), rng.integers(15, Sp + 1, B)], 1)
    wb[1] = [7, 7]  # an empty build window
    wp[2] = [0, 0]  # an empty probe window
    return kb, wb.astype(np.int32), kp, wp.astype(np.int32)


@pytest.fixture(scope="module", params=[0, 1])
def probe_case(request):
    kb, wb, kp, wp = _probe_case(request.param)
    bh, bl = _limbs(kb)
    ph, pl = _limbs(kp)
    with pltpu.force_tpu_interpret_mode():
        mc, pc = jrj._probe_counts(
            jnp.asarray(bh.T), jnp.asarray(bl.T), jnp.asarray(wb.T),
            jnp.asarray(wp.T), jnp.asarray(ph.T), jnp.asarray(pl.T),
            16, 16, 2)
    return (kb, wb, kp, wp), (np.asarray(mc).T, np.asarray(pc).T)


def test_probe_counts_matches_jax_kernel(probe_case):
    (kb, wb, kp, wp), (mc, pc) = probe_case
    got = trj.probe_counts(_t(kb), torch.from_numpy(wb), _t(kp),
                           torch.from_numpy(wp))
    np.testing.assert_array_equal(got[0].numpy(), mc)
    np.testing.assert_array_equal(got[1].numpy(), pc)
    assert got[0].dtype == got[1].dtype == torch.int32


def test_wrappers_reject_bad_input():
    k = torch.zeros((4, 8), dtype=torch.int64)
    w = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        trj.probe_counts(k.to(torch.int32), w, k, w)
    with pytest.raises(ValueError):
        trj.probe_counts(k, w[:3], k, w)
    with pytest.raises(ValueError):
        trj.probe_counts(torch.zeros((4, trj.PROBE_MAX_BUILD_SLOTS + 1),
                                     dtype=torch.int64), w, k, w)
    st = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        trj.slot_fill(st, st, [k[0], k[0, :4]], 8)
    with pytest.raises(ValueError):
        trj.slot_fill(st, st.to(torch.int64), [k[0]], 8)
    with pytest.raises(ValueError):
        trj.slot_fill(st, st, [k[:, 0]], 8)  # not contiguous


# ---- radix_fused_static: both branches, with JAX limbs 1 and 2 -------------


def _uniform_case():
    """tests/test_radix_join.py::test_static_radix_branch_matches_oracle."""
    rng = np.random.default_rng(11)
    bk = rng.integers(0, 400, 3000, dtype=np.uint64)
    bv = [rng.integers(0, 1 << 40, 3000, dtype=np.uint64)]
    pk = rng.integers(0, 400, 3500, dtype=np.uint64)
    pv = [rng.integers(0, 1 << 40, 3500, dtype=np.uint64)]
    return bk, bv, pk, pv


def _hot_case():
    """tests/test_radix_join.py::test_static_overflow_takes_merge_branch."""
    rng = np.random.default_rng(12)
    bk = np.full(3000, 7, dtype=np.uint64)
    bv = [rng.integers(0, 1 << 40, 3000, dtype=np.uint64)]
    pk = np.concatenate([np.full(100, 7, np.uint64),
                         rng.integers(0, 50, 400, np.uint64)])
    pv = [rng.integers(0, 1 << 40, 500, dtype=np.uint64)]
    return bk, bv, pk, pv


def _jax_static(case, limbs, **kw):
    bits, SPb, SPp = jrj.static_radix_plan(PAD_TO, PAD_TO)
    with pltpu.force_tpu_interpret_mode():
        return jrj.radix_fused_static(*_jax_args(*case), bits=bits, SPb=SPb,
                                      SPp=SPp, limbs=limbs, **kw)


@pytest.fixture(scope="module")
def jax_static():
    """JAX radix_fused_static: the uniform case through the Pallas branch
    at limbs 1 and 2, the hot-key case through the merge branch."""
    return {("kernel", limbs): _result(_jax_static(_uniform_case(), limbs))
            for limbs in (1, 2)} | {
        ("merge", 2): _result(_jax_static(_hot_case(), 2))}


def _port_static(case, **kw):
    bits, SPb, SPp = trj.static_radix_plan(PAD_TO, PAD_TO)
    return trj.radix_fused_static(*_port_args(*case), bits=bits, SPb=SPb,
                                  SPp=SPp, **kw)


@pytest.mark.parametrize("branch,case", [("kernel", _uniform_case),
                                         ("merge", _hot_case)])
def test_static_branches_match_jax(jax_static, branch, case):
    before = dict(trj.BRANCHES)
    got = _result(_port_static(case()))
    assert trj.BRANCHES[branch] == before[branch] + 1
    for (b, _), want in jax_static.items():
        if b == branch:
            assert got == want
    assert got == _oracle(*case())


def _jax_artifacts(keys, n, bits, vals):
    """JAX radix_prep_keys outputs -> the port's (artifact tuple,
    pre-sorted value stack)."""
    ks, perm, st, ct, mo = jrj.radix_prep_keys(jnp.asarray(keys),
                                               jnp.int32(n), bits)
    pre = (_t(np.asarray(ks)), torch.from_numpy(np.asarray(st)),
           torch.from_numpy(np.asarray(ct)), torch.tensor(int(mo),
                                                          dtype=torch.int32))
    return pre, _t(vals[:, np.asarray(perm)])


def test_static_prep_artifacts_bit_exact(jax_static):
    """After tests/test_radix_join.py::
    test_static_radix_prep_artifacts_match_unprepped: the port's sums are
    the same consuming JAX's artifacts, its own, or none."""
    bk, bv, pk, pv = _uniform_case()
    bits, SPb, SPp = trj.static_radix_plan(PAD_TO, PAD_TO)
    kb, vb, nb, kp, vp, npr = _port_args(bk, bv, pk, pv)
    jpre_b, jvb = _jax_artifacts(_pad(bk), nb, bits, _padv(bv))
    jpre_p, jvp = _jax_artifacts(_pad(pk), npr, bits, _padv(pv))

    def own(keys, vals, n):
        ks, perm, st, ct, mo = trj.radix_prep_keys(keys, n, bits)
        return (ks, st, ct, mo), vals.index_select(1, perm)

    opre_b, ovb = own(kb, vb, nb)
    opre_p, ovp = own(kp, vp, npr)
    kw = dict(bits=bits, SPb=SPb, SPp=SPp)
    want = jax_static[("kernel", 2)]
    runs = [
        trj.radix_fused_static(kb, vb, nb, kp, vp, npr, **kw),
        trj.radix_fused_static(kb, jvb, nb, kp, jvp, npr, prep_b=jpre_b,
                               prep_p=jpre_p, **kw),
        trj.radix_fused_static(kb, jvb, nb, kp, vp, npr, prep_b=jpre_b,
                               **kw),
        trj.radix_fused_static(kb, ovb, nb, kp, ovp, npr, prep_b=opre_b,
                               prep_p=opre_p, **kw),
        trj.fused_join_auto(kb, vb, nb, kp, vp, npr, algo="radix",
                            radix_pre_b=opre_b, radix_vals_b=ovb),
    ]
    for r in runs:
        assert _result(r) == want


# ---- radix_join_checksum -----------------------------------------------------


@pytest.mark.parametrize("seed,nb,npr,keyspace,bits", [
    (0, 500, 800, 50, 4),
    (1, 100, 1000, 10000, 4),
    (2, 3, 5, 2, 4),
    (3, 700, 700, 1, 4),       # single key, all pairs
    (7, 4000, 4000, 900, 6),   # wider fan-out
])
def test_checksum_matches_jax(seed, nb, npr, keyspace, bits):
    """The cases of tests/test_radix_join.py::test_radix_matches_oracle
    and ::test_radix_wider_fanout.  Off the TPU the JAX function answers
    with its sort member; the contract is the same."""
    rng = np.random.default_rng(seed)
    bk = rng.integers(0, keyspace, nb, dtype=np.uint64)
    bv = [rng.integers(0, 1 << 40, nb, dtype=np.uint64) for _ in range(2)]
    pk = rng.integers(0, keyspace, npr, dtype=np.uint64)
    pv = [rng.integers(0, 1 << 40, npr, dtype=np.uint64)]
    got = _result(trj.radix_join_checksum(*_port_args(bk, bv, pk, pv),
                                          bits=bits))
    want = _result(jrj.radix_join_checksum(*_jax_args(bk, bv, pk, pv),
                                           bits=bits))
    assert got == want == _oracle(bk, bv, pk, pv)


def test_checksum_extreme_keys_and_empty_sides():
    bk = np.array([0, MAX64, MAX64, 5], dtype=np.uint64)
    bv = [np.array([1, 2, 3, 4], dtype=np.uint64)]
    pk = np.array([MAX64, 5, 0, 7], dtype=np.uint64)
    pv = [np.array([10, 20, 30, 40], dtype=np.uint64)]
    assert _result(trj.radix_join_checksum(*_port_args(bk, bv, pk, pv),
                                           bits=4)) == \
        _oracle(bk, bv, pk, pv)
    empty = np.empty(0, dtype=np.uint64)
    got = _result(trj.radix_join_checksum(
        *_port_args(empty, [], pk[1:3], [pv[0][1:3]]), bits=4))
    assert got[0] == 0 and got[2] == [0]


def test_checksum_bucket_overflow_raises():
    n = trj.MAX_SLOTS + 1024
    keys = np.zeros(n, dtype=np.uint64)  # one key, multiplicity > cap
    vals = np.zeros((0, n), np.uint64)
    with pytest.raises(ValueError, match="bucket overflow"):
        jrj.radix_join_checksum(jnp.asarray(keys), jnp.asarray(vals), n,
                                jnp.asarray(keys), jnp.asarray(vals), n,
                                bits=4, interpret=True, force_pallas=True)
    with pytest.raises(ValueError, match="bucket overflow"):
        trj.radix_join_checksum(_t(keys), _t(vals), n, _t(keys), _t(vals),
                                n, bits=4)
