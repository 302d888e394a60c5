"""The torch port's device operators (sigmod2018_tpu_torch/ops/) held
against the JAX package's on the same seeded numpy inputs.  All results
are integers and must be bit-equal (lo only where cnt > 0)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sigmod2018_tpu import ops as jops
from sigmod2018_tpu.ops import lsd
from sigmod2018_tpu_torch import ops as tops
from sigmod2018_tpu_torch.ops import u64
from sigmod2018_tpu_torch.utils.padding import pad_to, size_class

MAX64 = np.iinfo(np.uint64).max


def _t(a):
    return torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.uint64).view(np.int64))


def _u(t):
    """Port tensor (int64 bits) -> uint64 numpy."""
    return t.numpy().view(np.uint64)


def _keys(rng, n, dom):
    """Keys with duplicates, values past 2^63 and live 2^64-1 keys."""
    pool = np.concatenate([rng.integers(0, MAX64, dom, dtype=np.uint64),
                           np.array([0, 1, 1 << 63, MAX64], np.uint64)])
    return rng.choice(pool, n)


# ---- u64 primitives -------------------------------------------------------


def test_sort_u64_matches_stable_sort():
    rng = np.random.default_rng(0)
    k = _keys(rng, 1000, 50)
    iota = np.arange(1000, dtype=np.int32)
    jk, jperm = lsd.sort_u64_with(jnp.asarray(k), (jnp.asarray(iota),))
    tk, tperm = u64.sort_u64(_t(k))
    np.testing.assert_array_equal(_u(tk), np.asarray(jk))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))


@pytest.mark.parametrize("side", ["left", "right"])
def test_ranks_u64_matches(side):
    rng = np.random.default_rng(1)
    hay = np.sort(_keys(rng, 700, 60))
    q = _keys(rng, 300, 60)
    want = lsd.ranks_u64(jnp.asarray(hay), jnp.asarray(q), side=side)
    got = u64.ranks_u64(_t(hay), _t(q), side=side)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_as_i64_and_flip_scalar():
    for v in (0, 5, (1 << 63) - 1, 1 << 63, MAX64, -1):
        bits = np.array([v & int(MAX64)], np.uint64).view(np.int64)[0]
        assert u64.as_i64(v) == bits
        assert u64.flip_scalar(v) == int(u64.flip(torch.tensor([bits]))[0])


# ---- select ---------------------------------------------------------------


@pytest.mark.parametrize("op", ["<", ">", "="])
def test_compare_mask_and_positions(op):
    rng = np.random.default_rng(2)
    n, P = 900, 1024
    vals = pad_to(_keys(rng, n, 40), P)
    for const in (int(vals[3]), 1 << 63, int(MAX64), 7):
        jm = jops.compare_mask(jnp.asarray(vals), jnp.int32(n), op,
                               jnp.uint64(const))
        tm = tops.compare_mask(_t(vals), n, op, const)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        jpos, jcnt = jops.mask_positions(jm, out_size=P)
        tpos, tcnt = tops.mask_positions(tm, out_size=P)
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        assert int(tcnt) == int(jcnt)


def test_equal_mask_gathers_checksum():
    rng = np.random.default_rng(3)
    P, n = 512, 450
    a = rng.integers(0, 4, P).astype(np.uint64)
    b = rng.integers(0, 4, P).astype(np.uint64)
    jm = jops.equal_mask(jnp.asarray(a), jnp.asarray(b), jnp.int32(n))
    tm = tops.equal_mask(_t(a), _t(b), torch.tensor(n, dtype=torch.int32))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    rows = rng.integers(0, P, P).astype(np.int32)
    col = rng.integers(MAX64 - 1000, MAX64, P, dtype=np.uint64)  # wraps
    np.testing.assert_array_equal(
        _u(tops.gather_u64(_t(col), torch.from_numpy(rows))),
        np.asarray(jops.gather_u64(jnp.asarray(col), jnp.asarray(rows))))
    table = rng.integers(0, P, (3, P)).astype(np.int32)
    np.testing.assert_array_equal(
        tops.take_cols(torch.from_numpy(table), torch.from_numpy(rows)).numpy(),
        np.asarray(jops.take_cols(jnp.asarray(table), jnp.asarray(rows))))
    want = jops.checksum(jnp.asarray(col), jnp.asarray(rows), jnp.int32(n))
    got = tops.checksum(_t(col), torch.from_numpy(rows), n)
    assert int(got) & int(MAX64) == int(want)


def test_cartesian_indices():
    j1, j2 = jops.cartesian_indices(jnp.int64(5), jnp.int64(3), out_size=32)
    t1, t2 = tops.cartesian_indices(5, 3, 32, "cpu")
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))


# ---- sort_join ------------------------------------------------------------


def _join_inputs(seed, nb, npr, dom, big=False):
    rng = np.random.default_rng(seed)
    kb = _keys(rng, nb, dom) if big else rng.integers(0, dom, nb)
    kp = _keys(rng, npr, dom) if big else rng.integers(0, dom, npr)
    Pb, Pp = size_class(nb), size_class(npr)
    return (pad_to(np.asarray(kb, np.uint64), Pb),
            pad_to(np.asarray(kp, np.uint64), Pp))


@pytest.mark.parametrize("seed,big", [(0, False), (1, True), (2, True)])
def test_join_build_probe_emit(seed, big):
    nb, npr = 300, 700
    kb, kp = _join_inputs(seed, nb, npr, 30, big)
    jsk, jperm = jops.join_build(jnp.asarray(kb), jnp.int32(nb))
    tsk, tperm = tops.join_build(_t(kb), nb)
    np.testing.assert_array_equal(_u(tsk), np.asarray(jsk))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    jlo, jcnt, jccum, jtot = jops.join_probe_count(
        jsk, jnp.int32(nb), jnp.asarray(kp), jnp.int32(npr))
    tlo, tcnt, tccum, ttot = tops.join_probe_count(tsk, nb, _t(kp), npr)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    m = np.asarray(jcnt) > 0
    np.testing.assert_array_equal(tlo.numpy()[m], np.asarray(jlo)[m])
    np.testing.assert_array_equal(tccum.numpy(), np.asarray(jccum))
    assert int(ttot) == int(jtot)
    out = size_class(max(int(jtot), 1))
    jb, jp = jops.join_emit(jperm, jlo, jccum, jtot, out_size=out)
    tb, tp = tops.join_emit(tperm, tlo, tccum, int(ttot), out_size=out)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_join_emit_truncated_output():
    """out_size below the total: the emitted prefix is the same."""
    kb, kp = _join_inputs(4, 200, 300, 10)
    jsk, jperm = jops.join_build(jnp.asarray(kb), jnp.int32(200))
    jlo, _, jccum, jtot = jops.join_probe_count(
        jsk, jnp.int32(200), jnp.asarray(kp), jnp.int32(300))
    tsk, tperm = tops.join_build(_t(kb), 200)
    tlo, _, tccum, ttot = tops.join_probe_count(tsk, 200, _t(kp), 300)
    assert int(ttot) > 1024
    jb, jp = jops.join_emit(jperm, jlo, jccum, jtot, out_size=1024)
    tb, tp = tops.join_emit(tperm, tlo, tccum, int(ttot), out_size=1024)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("out_size", [128, 1024, 8192])
def test_join_emit_device_total(out_size):
    """A 0-d tensor total (the compiled engine's, never read to the host)
    emits what the int form and the JAX op emit, the total above
    out_size included (the first out_size pairs are kept)."""
    kb, kp = _join_inputs(4, 200, 300, 10)
    jsk, jperm = jops.join_build(jnp.asarray(kb), jnp.int32(200))
    jlo, _, jccum, jtot = jops.join_probe_count(
        jsk, jnp.int32(200), jnp.asarray(kp), jnp.int32(300))
    tsk, tperm = tops.join_build(_t(kb), 200)
    tlo, _, tccum, ttot = tops.join_probe_count(tsk, 200, _t(kp), 300)
    assert ttot.dim() == 0 and 1024 < int(ttot) < 8192
    jb, jp = jops.join_emit(jperm, jlo, jccum, jtot, out_size=out_size)
    for total in (ttot, int(ttot)):
        tb, tp = tops.join_emit(tperm, tlo, tccum, total, out_size=out_size)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def _emit_case(name):
    """(perm, lo, cnt, out_size) of one range-expansion shape, made with
    numpy from a seed; lo is in range only where cnt > 0 (elsewhere it is
    whatever the probe left there)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    Pb = 1024
    if name == "mostly dead with pads":
        # the TPC-H Q7/Q10 cuts: ~4% of the live probe rows match, and
        # the pad rows past the 3,000 live ones add none
        Pp, live = 4096, 3000
        cnt = np.where(rng.random(Pp) < 0.04, rng.integers(1, 9, Pp), 0)
        cnt[live:] = 0
    elif name == "one row owns most slots":
        Pp = 512
        cnt = rng.integers(0, 3, Pp)
        cnt[rng.integers(Pp)] = 900
    elif name == "truncated, device total":
        Pp = 256
        cnt = rng.integers(0, 12, Pp)
    elif name == "one probe row":
        Pp = 1
        cnt = np.array([7])
    else:  # total 0
        Pp = 300
        cnt = np.zeros(Pp, np.int64)
    lo = np.where(cnt > 0, rng.integers(0, Pb - cnt + 1),
                  rng.integers(0, Pb, Pp))
    total = int(cnt.sum())
    out_size = 256 if name == "truncated, device total" else \
        size_class(max(total, 1))
    return (rng.permutation(Pb).astype(np.int32), lo.astype(np.int32),
            cnt, out_size)


@pytest.mark.parametrize("total_form", ["host int", "0-d device"])
@pytest.mark.parametrize("name", ["mostly dead with pads",
                                  "one row owns most slots",
                                  "truncated, device total", "one probe row",
                                  "total 0"])
def test_join_emit_expansion_shapes(name, total_form):
    """The range expansion against the JAX op, bit for bit, on the shapes
    where its form matters: rows without matches in the majority, one row
    owning most slots, out_size below the total, a single probe row, no
    match at all."""
    perm, lo, cnt, out_size = _emit_case(name)
    ccum = np.cumsum(cnt)
    total = int(ccum[-1])
    if name == "truncated, device total":
        assert total > out_size
    jb, jp = jops.join_emit(jnp.asarray(perm), jnp.asarray(lo),
                            jnp.asarray(ccum, jnp.int32),
                            jnp.asarray(total, jnp.int64), out_size=out_size)
    ttotal = torch.tensor(total) if total_form == "0-d device" else total
    tb, tp = tops.join_emit(torch.from_numpy(perm), torch.from_numpy(lo),
                            torch.from_numpy(ccum.astype(np.int64)), ttotal,
                            out_size=out_size)
    assert tb.dtype == tp.dtype == torch.int32
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def _key_table(keys):
    u = int(max(keys))
    cumcnt = np.zeros(u + 3, dtype=np.int32)
    cumcnt[1:u + 2] = np.cumsum(np.bincount(keys.astype(np.int64),
                                            minlength=u + 1))
    cumcnt[u + 2] = cumcnt[u + 1]
    return cumcnt


def test_join_probe_count_table():
    nb, npr = 600, 900
    kb, kp = _join_inputs(5, nb, npr, 70)
    kp[:4] = [69, 70, MAX64, 1 << 63]  # domain edge and out of domain
    tbl = _key_table(kb[:nb])
    want = jops.join_probe_count_table(jnp.asarray(tbl), jnp.asarray(kp),
                                       jnp.int32(npr))
    got = tops.join_probe_count_table(torch.from_numpy(tbl), _t(kp), npr)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    m = np.asarray(want[1]) > 0
    np.testing.assert_array_equal(got[0].numpy()[m], np.asarray(want[0])[m])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3])


# ---- agg_join -------------------------------------------------------------


def _fused_inputs(seed, nb, npr, dom):
    rng = np.random.default_rng(seed)
    kb, kp = _join_inputs(seed, nb, npr, dom)
    vb = rng.integers(0, MAX64, (2, kb.shape[0]), dtype=np.uint64)
    vp = rng.integers(0, MAX64, (1, kp.shape[0]), dtype=np.uint64)
    return kb, kp, vb, vp


def _assert_fused(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u(g), np.asarray(w, np.uint64))


def test_fused_and_presorted():
    nb, npr = 700, 1100
    kb, kp, vb, vp = _fused_inputs(6, nb, npr, 40)
    want = jops.join_checksum_fused(jnp.asarray(kb), jnp.asarray(vb),
                                    jnp.int32(nb), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.int32(npr))
    _assert_fused(tops.join_checksum_fused(_t(kb), _t(vb), nb, _t(kp),
                                           _t(vp), npr), want)
    tsk, tperm = tops.join_build(_t(kb), nb)
    _assert_fused(tops.join_checksum_fused_presorted(
        tsk, tperm, _t(vb), nb, _t(kp), _t(vp), npr), want)


def test_fused_table_and_prefix_tables():
    nb, npr = 600, 1000
    kb, kp, vb, vp = _fused_inputs(7, nb, npr, 90)
    kp[npr - 1] = 1 << 63  # past the domain
    tbl = _key_table(kb[:nb])
    jsk, jperm = jops.join_build(jnp.asarray(kb), jnp.int32(nb))
    want = jops.join_checksum_fused_table(
        jnp.asarray(tbl), jperm, jnp.asarray(vb), jnp.int32(nb),
        jnp.asarray(kp), jnp.asarray(vp), jnp.int32(npr))
    _, tperm = tops.join_build(_t(kb), nb)
    ttbl = torch.from_numpy(tbl)
    _assert_fused(tops.join_checksum_fused_table(
        ttbl, tperm, _t(vb), nb, _t(kp), _t(vp), npr), want)
    jpref = jnp.stack([jops.prefix_by_perm(jnp.asarray(v), jperm,
                                           jnp.int32(nb)) for v in vb])
    tpref = torch.stack([tops.prefix_by_perm(_t(v), tperm, nb) for v in vb])
    np.testing.assert_array_equal(_u(tpref), np.asarray(jpref))
    _assert_fused(tops.join_checksum_fused_table_pref(
        ttbl, tpref, _t(kp), _t(vp), npr), want)
