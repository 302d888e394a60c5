"""The port's CUDA kernels K1 (csrc/stair_counts.cu) and K5
(csrc/probe_counts.cu) against their plain PyTorch twins, on the card.

This file imports no JAX, so it runs on a machine with an NVIDIA GPU and
no JAX:

    python -m pytest --noconftest -o addopts= -m cuda tests/test_torch_kernels_cuda.py

Every test is marked `cuda` and skips without a card; whether a card is
present is decided inside each test.  Outputs must equal the twins'
exactly: K1's cnt everywhere and lo where cnt > 0, K5's mc and pc over
the whole matrices."""

import pytest
import torch

from sigmod2018_tpu_torch.ops import ms_join, radix_join
from sigmod2018_tpu_torch.ops.sort_join import join_build

pytestmark = pytest.mark.cuda


def _device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# ---- K1: staircase counts ----------------------------------------------------


def _sorted_side(gen, dev, P, n, dom, hot=0, maxkeys=0):
    keys = torch.randint(0, dom, (P,), generator=gen, device=dev)
    if hot:
        keys[torch.randint(0, P, (hot,), generator=gen, device=dev)] = 12345
    if maxkeys:
        keys[torch.randint(0, P, (maxkeys,), generator=gen, device=dev)] = -1
    return join_build(keys, n)[0]


def _k1_launches(n_b, n_p) -> int:
    """The bounds pass and the merge pass; the merge pass alone when host
    counts leave no live row."""
    on_device = isinstance(n_b, torch.Tensor) or isinstance(n_p, torch.Tensor)
    return 2 if on_device or (n_b > 0 and n_p > 0) else 1


def _assert_k1(kb, n_b, kp, n_p):
    before = ms_join.LAUNCHES
    cnt, lo = ms_join.staircase_counts(kb, n_b, kp, n_p)
    want_cnt, want_lo = ms_join.staircase_counts_plain(kb, n_b, kp, n_p)
    assert ms_join.LAUNCHES == before + _k1_launches(n_b, n_p)
    assert torch.equal(cnt, want_cnt)
    hit = want_cnt > 0
    assert torch.equal(lo[hit], want_lo[hit])


# (Pb, n_b, Pp, n_p, key domain, hot rows, live 2^64-1 keys)
K1_CASES = {
    "uniform": (1 << 15, 30000, 1 << 15, 31000, 1 << 14, 0, 0),
    "full-range": (1 << 15, 32000, 1 << 15, 32000, 1 << 62, 0, 0),
    "hot key on 1/4 of rows": (1 << 16, 65000, 1 << 16, 65000, 1 << 12,
                               1 << 14, 0),
    "live 2^64-1 keys": (1 << 14, 16000, 1 << 14, 16383, 1 << 10, 0, 300),
    "dense build, many tiles": (1 << 18, 250000, 1 << 12, 4000, 1 << 10, 0,
                                0),
    "ragged sizes": (5000, 4999, 3001, 2999, 700, 0, 0),
    "n_b = 0": (1 << 12, 0, 1 << 12, 4000, 1 << 8, 0, 0),
    "n_p = 0": (1 << 12, 4000, 1 << 12, 0, 1 << 8, 0, 0),
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_stair_counts_matches_plain(case):
    dev = _device()
    Pb, n_b, Pp, n_p, dom, hot, maxkeys = K1_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(len(case))
    kb = _sorted_side(gen, dev, Pb, n_b, dom, hot, maxkeys)
    kp = _sorted_side(gen, dev, Pp, n_p, dom, hot, maxkeys)
    _assert_k1(kb, n_b, kp, n_p)


def test_stair_counts_device_counts():
    """Live counts as 0-d device tensors: no host sync, the same answer."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(1)
    kb = _sorted_side(gen, dev, 1 << 14, 16000, 1 << 12)
    kp = _sorted_side(gen, dev, 1 << 14, 15000, 1 << 12)
    for n_b, n_p in ((torch.tensor(16000, device=dev), 15000),
                     (16000, torch.tensor(15000, device=dev,
                                          dtype=torch.int32)),
                     (torch.tensor(0, device=dev),
                      torch.tensor(15000, device=dev))):
        _assert_k1(kb, n_b, kp, n_p)


def test_stair_counts_unaligned_views():
    """Arrays that start 8 bytes past a 16-byte boundary take the
    kernel's scalar loads and stores."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(2)
    kb = _sorted_side(gen, dev, 4097, 4096, 1 << 10)[1:]
    kp = _sorted_side(gen, dev, 3001, 3000, 1 << 10)[1:]
    _assert_k1(kb, 4095, kp, 2999)


# ---- K5: per-bucket dual counts -----------------------------------------------


def _windows(gen, dev, B, S, lo_max, empty_every=0):
    lo = torch.randint(0, lo_max + 1, (B,), generator=gen, device=dev)
    hi = torch.randint(0, S + 1, (B,), generator=gen, device=dev)
    hi = torch.maximum(lo, hi)
    if empty_every:
        hi[::empty_every] = lo[::empty_every]
    return torch.stack([lo, hi], 1).to(torch.int32).contiguous()


def _assert_k5(kb, wb, kp, wp):
    before = radix_join.LAUNCHES["probe_counts"]
    mc, pc = radix_join.probe_counts(kb, wb, kp, wp)
    want_mc, want_pc = radix_join.probe_counts_plain(kb, wb, kp, wp)
    assert radix_join.LAUNCHES["probe_counts"] == before + 1
    assert torch.equal(mc, want_mc)
    assert torch.equal(pc, want_pc)


# (B, Sb, Sp, key domain, sorted rows, build window lo max, probe lo max)
K5_CASES = {
    "sorted, one chunk": (256, 640, 512, 1 << 9, True, 40, 30),
    "unsorted, one chunk": (256, 640, 512, 1 << 9, False, 40, 30),
    "sorted, many chunks": (8, 4000, 5000, 1 << 8, True, 100, 900),
    "unsorted, many chunks": (8, 4000, 5000, 1 << 8, False, 100, 900),
    "odd widths": (33, 777, 1029, 50, False, 5, 5),
}


@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_probe_counts_matches_plain(case):
    dev = _device()
    B, Sb, Sp, dom, ordered, lo_b, lo_p = K5_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(len(case))
    kb = torch.randint(0, dom, (B, Sb), generator=gen, device=dev)
    kp = torch.randint(0, dom, (B, Sp), generator=gen, device=dev)
    kb[0, ::3] = -1  # live 2^64-1 keys
    kp[0, ::5] = -1
    if ordered:  # ascending as unsigned, the callers' windows
        sign = torch.iinfo(torch.int64).min
        kb = torch.sort(kb ^ sign, 1).values ^ sign
        kp = torch.sort(kp ^ sign, 1).values ^ sign
    _assert_k5(kb.contiguous(), _windows(gen, dev, B, Sb, lo_b, 7),
               kp.contiguous(), _windows(gen, dev, B, Sp, lo_p, 5))


def test_probe_counts_empty_windows():
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(5)
    kb = torch.randint(0, 9, (16, 300), generator=gen, device=dev)
    kp = torch.randint(0, 9, (16, 200), generator=gen, device=dev)
    none = torch.zeros((16, 2), dtype=torch.int32, device=dev)
    full_b = torch.tensor([[0, 300]] * 16, dtype=torch.int32, device=dev)
    full_p = torch.tensor([[0, 200]] * 16, dtype=torch.int32, device=dev)
    for wb, wp in ((none, full_p), (full_b, none), (none, none)):
        _assert_k5(kb, wb, kp, wp)


def test_probe_counts_at_shared_memory_limit():
    """A build row of PROBE_MAX_BUILD_SLOTS slots leaves room for a probe
    tile of 9,686 slots: a 12,000-slot probe window takes two tiles."""
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(6)
    Sb, Sp = radix_join.PROBE_MAX_BUILD_SLOTS, 12000
    kb = torch.randint(0, 300, (3, Sb), generator=gen, device=dev)
    kp = torch.randint(0, 300, (3, Sp), generator=gen, device=dev)
    wb = torch.tensor([[0, Sb], [7, Sb - 3], [0, 0]], dtype=torch.int32,
                      device=dev)
    wp = torch.tensor([[0, Sp], [11, Sp - 1], [0, Sp]], dtype=torch.int32,
                      device=dev)
    _assert_k5(kb, wb, kp, wp)
