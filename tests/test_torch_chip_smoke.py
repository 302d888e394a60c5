"""chip_smoke.py's arithmetic, checked on the CPU: the bytes bounds of the
kernel table against counts made by hand at the shapes of its cases, and
the case builders against what their cases claim to exercise."""

import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()

# (kernel, shape, bytes counted by hand)
BOUNDS = {
    # live build and probe keys 2,000,000 x 8 B each; cnt + lo 2^21 x 8 B
    "K1 2^21 x 2^21": ("K1", dict(n_b=2_000_000, n_p=2_000_000,
                                  Pp=1 << 21),
                       16_000_000 + 16_000_000 + 16_777_216),
    # 16,000,000 live build keys: 128 MB
    "K1 build 2^24": ("K1", dict(n_b=16_000_000, n_p=2_000_000, Pp=1 << 21),
                      128_000_000 + 16_000_000 + 16_777_216),
    # an empty build: no key needs reading, the outputs are still written
    "K1 n_b = 0": ("K1", dict(n_b=0, n_p=2_000_000, Pp=1 << 21),
                   16_777_216),
    # 4 arrays x 2,000,000 live rows x 8 B read, starts + cnts 4,096 x 8 B,
    # the [4, 4096, 2048] u64 matrix written
    "K4 radix 2^21": ("K4", dict(K=4, B=4096, SP=2048, live=2_000_000),
                      64_000_000 + 32_768 + 268_435_456),
    # 4,000,000 live keys x 8 B, windows 4,096 x 16 B, mc + pc 4,096 x
    # 4,096 x 4 B
    "K5 radix 2^21": ("K5", dict(B=4096, Sb=2048, Sp=2048,
                                 live_b=2_000_000, live_p=2_000_000),
                      32_000_000 + 65_536 + 67_108_864),
    # qd: 8,192 buckets of H 64 + SPb 256 build slots; bucket 0's window
    # starts past its halo: 8,192 x 64 + 2,000,000 - 64 live build slots
    "K5 qd 2^21": ("K5", dict(B=8192, Sb=320, Sp=2048,
                              live_b=8192 * 64 + 2_000_000 - 64,
                              live_p=2_000_000),
                   8 * 2_524_224 + 16_000_000 + 131_072 + 77_594_624),
}


@pytest.mark.parametrize("case", sorted(BOUNDS))
def test_bound_counts_bytes_by_hand(case):
    kernel, shape, nbytes = BOUNDS[case]
    ms, got = cs.bound(kernel, **shape)
    assert got == nbytes
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)


def test_bound_of_the_main_case_is_the_tabled_one():
    assert cs.bound("K1", n_b=2_000_000, n_p=2_000_000,
                    Pp=1 << 21)[0] == pytest.approx(0.01456, abs=1e-5)
    with pytest.raises(ValueError):
        cs.bound("K9", n=1)


def test_window_lengths_clamp_to_the_row():
    w = torch.tensor([[0, 5], [3, 2], [-4, 100], [7, 9]], dtype=torch.int32)
    assert cs._window_lengths(w, 8).tolist() == [5, 0, 8, 1]


def test_zipf_keys_fill_a_few_buckets_near_the_cap():
    """At radix 2^21 (bits 12) most buckets hold ~490 live rows, the hot
    keys' buckets nearly the 2,048 slots, none more."""
    gen = torch.Generator().manual_seed(2019)
    keys = cs._zipf_keys(torch.device("cpu"), gen, 1 << 21)[:2_000_000]
    occ = torch.bincount(keys & 4095, minlength=4096)
    assert 1500 < int(occ.max()) <= 2048
    assert 400 < int(occ.median()) < 560


def test_shuffle_windows_keeps_each_window():
    gen = torch.Generator().manual_seed(0)
    mat = torch.arange(24, dtype=torch.int64).reshape(3, 8)
    ct = torch.tensor([8, 3, 0], dtype=torch.int32)
    out = cs._shuffle_windows(mat, ct, gen)
    for b in range(3):
        c = int(ct[b])
        assert sorted(out[b, :c].tolist()) == mat[b, :c].tolist()
        assert out[b, c:].tolist() == mat[b, c:].tolist()
    assert out[0].tolist() != mat[0].tolist()
