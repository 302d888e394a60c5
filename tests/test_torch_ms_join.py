"""The torch port's staircase member (sigmod2018_tpu_torch/ops/ms_join.py)
held against the JAX package's (sigmod2018_tpu/ops/ms_join.py).

The same seeded numpy inputs go through the JAX Pallas kernel (run as
tests/test_ms_join.py runs it: interpret mode, small W/H, P <= 2048), the
JAX searchsorted reference `_ranges_by_search`, and the port's
`staircase_counts`, which on CPU tensors runs its plain PyTorch twin.
Everything is integer: cnt, count and sums must be bit-equal, and lo is
compared only where cnt > 0 (it is unspecified elsewhere)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sigmod2018_tpu.ops import ms_join as jms
from sigmod2018_tpu.ops import sort_join as jsj
from sigmod2018_tpu_torch.ops import ms_join as tms
from sigmod2018_tpu_torch.ops import sort_join as tsj

MAX64 = np.iinfo(np.uint64).max


def _t(a):
    """u64 numpy -> the port's int64 bit-pattern tensor."""
    return torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.uint64).view(np.int64))


def _sorted_padded(live, P, dtype=np.uint64):
    out = np.full(P, np.iinfo(dtype).max, dtype)
    out[:len(live)] = np.sort(np.asarray(live, dtype))
    return out


def _assert_counts(got, want, n_p):
    gc, gl = (np.asarray(x).astype(np.int64) for x in got)
    wc, wl = (np.asarray(x).astype(np.int64) for x in want)
    np.testing.assert_array_equal(gc, wc)
    assert not gc[n_p:].any()
    m = wc > 0
    np.testing.assert_array_equal(gl[m], wl[m])


def _check(kb_live, kp_live, P=1024, dtype=np.uint64, W=64, H=32,
           slack=1.0):
    kb = _sorted_padded(kb_live, P, dtype)
    kp = _sorted_padded(kp_live, P, dtype)
    nb, npp = len(kb_live), len(kp_live)
    W_, H_, T = jms.stair_plan(P, P, W, H, slack)
    kernel = jms.staircase_counts(jnp.asarray(kb), nb, jnp.asarray(kp), npp,
                                  W=W_, H=H_, T_cap=T, interpret=True)
    search = jms._ranges_by_search(jnp.asarray(kb), jnp.int32(nb),
                                   jnp.asarray(kp), jnp.int32(npp))
    # The port has one key width: u32 keys widen to u64.  Their pads
    # become 2^32-1, which must not matter (liveness is by position).
    port = tms.staircase_counts(_t(kb), nb, _t(kp), npp)
    _assert_counts(port, kernel, npp)
    _assert_counts(port, search, npp)
    # live counts as 0-d tensors (what the engine passes after a filter)
    port_t = tms.staircase_counts(_t(kb), torch.tensor(nb, dtype=torch.int32),
                                  _t(kp), torch.tensor(npp))
    _assert_counts(port_t, kernel, npp)


@pytest.mark.parametrize("seed", [0, 1])
def test_counts_uniform(seed):
    rng = np.random.default_rng(seed)
    _check(rng.integers(0, 500, 700), rng.integers(0, 500, 900))


def test_counts_u32_dtype():
    rng = np.random.default_rng(9)
    _check(rng.integers(0, 300, 640), rng.integers(0, 300, 640),
           dtype=np.uint32)


def test_counts_skewed_hot_key():
    rng = np.random.default_rng(4)
    kb = np.concatenate([np.full(250, 7), rng.integers(8, 1000, 150)])
    kp = np.concatenate([np.full(300, 7), rng.integers(0, 1000, 100)])
    _check(kb, kp, P=512, slack=16.0)


def test_counts_all_equal_keys():
    # the JAX kernel overflows its step cap here and takes its
    # searchsorted branch; the port has no cap
    _check(np.full(800, 42), np.full(900, 42), slack=0.0)


def test_counts_max_key_is_live():
    kb = np.array([1, 5, MAX64, MAX64], dtype=np.uint64)
    kp = np.array([0, 5, MAX64], dtype=np.uint64)
    _check(kb, kp, P=256, W=16, H=16)


def test_counts_disjoint_ranges():
    _check(np.arange(0, 300), np.arange(5000, 5300), P=512)
    _check(np.arange(5000, 5300), np.arange(0, 300), P=512)


def test_counts_empty_sides():
    _check(np.array([], dtype=np.uint64), np.arange(10), P=128, W=16, H=16)
    _check(np.arange(10), np.array([], dtype=np.uint64), P=128, W=16, H=16)


def test_counts_full_u64_range():
    # keys past 2^63 are negative as int64: the flip keeps their order
    rng = np.random.default_rng(13)
    pool = rng.integers(0, MAX64, 200, dtype=np.uint64, endpoint=True)
    _check(rng.choice(pool, 600), rng.choice(pool, 700))


def test_counts_split_build_matches_jax_split(monkeypatch):
    """Past MS_BCAST_MAX_ROWS the JAX side splits the sorted build into
    slices and combines cnt and lo; the port serves it in one call."""
    monkeypatch.setattr(jms, "MS_BCAST_MAX_ROWS", 512)
    rng = np.random.default_rng(11)
    Pb, Pp = 2048, 1024
    nb, npp = 1900, 1000
    kb = _sorted_padded(rng.integers(0, 37, nb), Pb)  # fat runs straddle
    kp = _sorted_padded(rng.integers(0, 37, npp), Pp)  # slice borders
    want = jms._counts_auto(jnp.asarray(kb), jnp.int32(nb), jnp.asarray(kp),
                            jnp.int32(npp), 1024, 512, True)
    _assert_counts(tms.staircase_counts(_t(kb), nb, _t(kp), npp), want, npp)


def test_wrapper_rejects_bad_input():
    k = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError):
        tms.staircase_counts(k.to(torch.int32), 1, k, 1)
    with pytest.raises(ValueError):
        tms.staircase_counts(k, 9, k, 1)
    with pytest.raises(ValueError):
        tms.staircase_counts(k[::2], 1, k, 1)


@pytest.mark.parametrize("seed,presorted", [(0, False), (1, True)])
def test_ms_fused_matches_jax(seed, presorted):
    rng = np.random.default_rng(seed)
    P = 512
    nb, npp = 420, 380
    kb = np.zeros(P, np.uint64)
    kb[:nb] = rng.integers(0, 60, nb)
    kp = np.zeros(P, np.uint64)
    kp[:npp] = rng.integers(0, 60, npp)
    # values near 2^63 and 2^64: the weighted sums must wrap
    vb = rng.integers(MAX64 - (1 << 62), MAX64, (2, P), dtype=np.uint64)
    vp = rng.integers((1 << 63) - 5, 1 << 63, (1, P), dtype=np.uint64)
    kw = {}
    tkw = {}
    if presorted:
        kw = dict(presorted_b=jsj.join_build(jnp.asarray(kb), nb),
                  presorted_p=jsj.join_build(jnp.asarray(kp), npp))
        tkw = dict(presorted_b=tsj.join_build(_t(kb), nb),
                   presorted_p=tsj.join_build(_t(kp), npp))
    want = jms.ms_fused(jnp.asarray(kb), jnp.asarray(vb), nb, jnp.asarray(kp),
                        jnp.asarray(vp), npp, W=64, H=32, interpret=True,
                        **kw)
    got = tms.ms_fused(_t(kb), _t(vb), nb, _t(kp), _t(vp), npp, **tkw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint64),
                                      np.asarray(w, dtype=np.uint64))


def test_ms_fused_no_build_views():
    rng = np.random.default_rng(3)
    P = 256
    kb = rng.integers(0, 20, P).astype(np.uint64)
    kp = rng.integers(0, 20, P).astype(np.uint64)
    vp = rng.integers(0, 1 << 40, (2, P)).astype(np.uint64)
    count, sb, sp = tms.ms_fused(_t(kb), _t(np.zeros((0, P), np.uint64)), P,
                                 _t(kp), _t(vp), P)
    eq = kb[:, None] == kp[None, :]
    assert int(count) == int(eq.sum())
    assert sb.shape == (0,)
    want = (eq.sum(0)[None, :].astype(np.uint64) * vp).sum(1)
    np.testing.assert_array_equal(sp.numpy().view(np.uint64), want)


@pytest.mark.parametrize("seed,shift", [(0, 0), (1, 40)])
def test_join_probe_count_ms_matches_jax(seed, shift):
    """The emitting contract: (lo, cnt, ccum, total) per raw probe row
    equals both JAX members', and join_emit expands it to the same
    pairs.  shift=40 puts the keys past 2^32 (two limbs on the TPU)."""
    rng = np.random.default_rng(seed)
    Pb, Pp = 1024, 2048
    nb, npp = 700, 1900
    kb = np.zeros(Pb, np.uint64)
    kb[:nb] = rng.integers(0, 400, nb).astype(np.uint64) << np.uint64(shift)
    kp = np.zeros(Pp, np.uint64)
    kp[:npp] = rng.integers(0, 400, npp).astype(np.uint64) << np.uint64(shift)
    sk, perm = jsj.join_build(jnp.asarray(kb), jnp.int32(nb))
    j_ss = jsj.join_probe_count(sk, jnp.int32(nb), jnp.asarray(kp),
                                jnp.int32(npp))
    j_ms = jms.join_probe_count_ms(sk, jnp.int32(nb), jnp.asarray(kp),
                                   jnp.int32(npp), W=64, H=32,
                                   interpret=True)
    tsk, tperm = tsj.join_build(_t(kb), nb)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(perm))
    got = tms.join_probe_count_ms(tsk, nb, _t(kp), npp)
    for want in (j_ss, j_ms):
        _assert_counts((got[1], got[0]), (want[1], want[0]), npp)
        np.testing.assert_array_equal(got[2].numpy(),
                                      np.asarray(want[2]).astype(np.int64))
        assert int(got[3]) == int(want[3])
    total = int(got[3])
    jb, jp = jsj.join_emit(perm, j_ms[0], j_ms[2], j_ms[3], out_size=32768)
    tb, tp = tsj.join_emit(tperm, got[0], got[2], total, out_size=32768)
    assert total <= 32768
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_join_probe_count_auto_dispatch(monkeypatch):
    """Dispatch is by padded size only: at the threshold the staircase
    member runs (on CPU through the plain twin)."""
    calls = []
    real = tms.staircase_counts
    monkeypatch.setattr(tms, "staircase_counts",
                        lambda *a: calls.append(1) or real(*a))
    k = _t(np.arange(256, dtype=np.uint64))
    sk, _ = tsj.join_build(k, 256)
    tms.join_probe_count_auto(sk, 256, k, 256)
    assert not calls
    monkeypatch.setattr(tms, "EMIT_MS_MIN_ROWS", 256)
    got = tms.join_probe_count_auto(sk, 256, k, 256)
    assert calls and int(got[3]) == 256


def _rolled_case(seed, Pb, Pp, nb, npp, dom, shift):
    rng = np.random.default_rng(seed)
    kb = _sorted_padded(rng.integers(0, dom, nb).astype(np.uint64)
                        << np.uint64(shift), Pb)
    kp = _sorted_padded(rng.integers(0, dom, npp).astype(np.uint64)
                        << np.uint64(shift), Pp)
    return kb, nb, kp, npp


# The inputs of tests/test_ms_join.py::test_rolled_kernel_matches_oracle
# (both limb widths) and ::test_rolled_kernel_multi_sublane_tiles.
_ROLLED = {
    "matches_oracle-u64": (_rolled_case(5, 2048, 4096, 1800, 3900, 700, 40),
                           128),
    "matches_oracle-u32": (_rolled_case(5, 2048, 4096, 1800, 3900, 700, 0),
                           128),
    "multi_sublane_tiles": (_rolled_case(6, 4096, 4096, 4000, 4000, 900, 0),
                            512),
}


@pytest.mark.parametrize("case", sorted(_ROLLED))
def test_staircase_matches_rolled_kernel(case):
    """K2 (`_stair_kernel_rolled`, the TPU's kernel for builds past
    2^23 rows) computes K1's contract; the port serves those builds with
    K1's kernel in one launch.  Both agree at the JAX tests' shapes."""
    (kb, nb, kp, npp), WH = _ROLLED[case]
    W, H, T = jms.stair_plan_rolled(kb.shape[0], kp.shape[0], W=WH, H=WH)
    want = jms.staircase_counts(jnp.asarray(kb), nb, jnp.asarray(kp), npp,
                                W=W, H=H, T_cap=T, interpret=True,
                                rolled=True)
    _assert_counts(tms.staircase_counts(_t(kb), nb, _t(kp), npp), want, npp)


def test_staircase_matches_natural_layout_kernel(monkeypatch):
    """K3 (`_stair_kernel_nat`, selected by S18_MS_NATKERN=1) computes
    K1's contract too; interpret mode runs it on the CPU."""
    import jax

    calls = []
    real = jms._stair_kernel_nat
    monkeypatch.setattr(jms, "_stair_kernel_nat",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("S18_MS_NATKERN", "1")
    (kb, nb, kp, npp), WH = _ROLLED["matches_oracle-u64"]
    W, H, T = jms.stair_plan_rolled(kb.shape[0], kp.shape[0], W=WH, H=WH)
    jax.clear_caches()  # the kernel body is chosen while tracing
    try:
        want = jms.staircase_counts(jnp.asarray(kb), nb, jnp.asarray(kp),
                                    npp, W=W, H=H, T_cap=T, interpret=True,
                                    rolled=True)
    finally:
        jax.clear_caches()
    assert calls, "the natural-layout kernel was not traced"
    _assert_counts(tms.staircase_counts(_t(kb), nb, _t(kp), npp), want, npp)
