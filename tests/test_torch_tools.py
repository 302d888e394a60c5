"""The port's tools (sigmod2018_tpu_torch/tools/) on the CPU: the soak's
verdict on its chunks, the smoke gate passing and naming a planted wrong
member, its deadline, the measuring tools at 2^10 with every line and
their parity checks, their byte counts against counts made by hand, the
shared timer, and query2sql against the JAX package's translation of
every workload query.  On the CPU every timed line says that it is the
host clock's."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sigmod2018_tpu.frontend.parser import parse_query as jparse
from sigmod2018_tpu.frontend.sql import query_to_sql as jax_sql
from sigmod2018_tpu_torch.ops import radix_join
from sigmod2018_tpu_torch.tools import (bench_probe, microbench, query2sql,
                                        roofline, smoke, soak)
from sigmod2018_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parent.parent
HOST_CLOCK = "host clock (time.perf_counter) on the CPU, not a device time"


# ---- soak -----------------------------------------------------------------


class _Proc:
    def __init__(self, stdout, returncode=0):
        self.stdout, self.stderr, self.returncode = stdout, "", returncode


@pytest.mark.parametrize("tail,rc,code", [
    ("5 queries x 3 engines: 0 failures", 0, 0),
    ("5 queries x 3 engines: 1 failures", 1, 1),
    ("5 queries x 3 engines: 10 failures", 1, 1),  # holds "0 failures"
    ("", 1, 1),                                    # the chunk printed nothing
    # a clean tail, then a nonzero exit (a fault at teardown)
    ("5 queries x 3 engines: 0 failures", 1, 1),
])
def test_soak_exit_code_follows_each_chunk_s_tail(monkeypatch, capsys, tail,
                                                  rc, code):
    calls = []

    def fake_run(args, **kw):
        calls.append((args, kw["env"]))
        ok = "5 queries x 3 engines: 0 failures"
        if len(calls) == 2:
            return _Proc(f"FAIL ..\n{tail}\n", rc)
        return _Proc(ok)

    monkeypatch.setattr(soak.subprocess, "run", fake_run)
    assert soak.main(["15", "7", "5", "--platform", "cpu",
                      "--join", "radix"]) == code
    # chunks of 5 and 5, a mesh chunk of a third of 5, then the rest
    assert [args[3:5] for args, _ in calls] == [["5", "7"], ["5", "8"],
                                                ["1", "9"], ["4", "10"]]
    for i, (args, env) in enumerate(calls):
        assert ("mesh" in args) == (i == 2)
        if "mesh" in args:
            assert args[args.index("--shards") + 1] == "8"
        assert args[-4:] == ["--platform", "cpu", "--join", "radix"]
        assert env["S18_PREP_CACHE"] == "0"
    out = capsys.readouterr().out
    assert ("OK" if code == 0 else "1 FAILING CHUNKS") in out


def test_soak_two_real_chunks_on_the_cpu(capsys):
    assert soak.main(["6", "99", "3", "--platform", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["chunk 0 (seed 99): 3 queries x 3 engines: 0 failures",
                   "chunk 1 (seed 100): 3 queries x 3 engines: 0 failures",
                   "soak: 6 queries in 2 chunks, OK"]


# ---- smoke ----------------------------------------------------------------


def test_smoke_passes_on_the_cpu(capsys):
    assert smoke.main(["--platform", "cpu", "--log2-rows", "12"]) == 0
    out = capsys.readouterr().out
    for case in [f"member:{m}" for m in smoke.MEMBERS] + [
            "radix:merge-branch", "emitting:jpc_ms",
            "engine:compiled-3rel-x3", "engine:factorized-blowup-x3"]:
        assert f"PASS {case} (" in out, case
    assert out.count("PASS member:") == 3 * len(smoke.MEMBERS)
    assert "SMOKE PASSED" in out


def test_smoke_names_a_wrong_member(monkeypatch, capsys):
    real = radix_join.ms_fused

    def off_by_one(*args, **kw):
        count, sb, sp = real(*args, **kw)
        return count + 1, sb, sp

    monkeypatch.setattr(radix_join, "ms_fused", off_by_one)
    assert smoke.main(["--platform", "cpu", "--log2-rows", "12"]) == 1
    out = capsys.readouterr().out
    assert "FAIL member:ms" in out and "SMOKE FAILED: ['member:ms']" in out
    assert "PASS member:radix" in out


def test_smoke_merge_case_takes_the_merge_branch():
    """The hot key puts a bucket past SPb - ALIGN at both sizes the gate
    runs (2^12 here, 2^18 on the card)."""
    for log2 in (12, 18):
        P = 1 << log2
        bits, SPb, _ = radix_join.static_radix_plan(P, P)
        assert smoke.MERGE_HOT_ROWS > SPb - radix_join.ALIGN
    before = radix_join.BRANCHES["merge"]
    smoke.merge_case(smoke.fixture(12), torch.device("cpu"))
    assert radix_join.BRANCHES["merge"] == before + 3


def test_smoke_deadline_exits_3_with_a_traceback():
    code = ("import time\n"
            "from sigmod2018_tpu_torch.tools import smoke\n"
            "smoke.arm_deadline(0.5)\n"
            "time.sleep(30)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 3
    assert "DEADLINE EXCEEDED" in proc.stdout
    assert "time.sleep(30)" in proc.stderr or "line 4" in proc.stderr


def test_numpy_fused_counts_by_hand():
    import numpy as np

    kb = np.array([1, 2, 2, 9, 0], np.uint64)    # last row is a pad
    kp = np.array([2, 2, 1, 5], np.uint64)
    vb = np.array([[10, 20, 30, 40, 50]], np.uint64)
    vp = np.array([[1, 2, 3, 4]], np.uint64)
    # matches: build 1 x probe 2 (key 1), build {2, 2} x probe {0, 1}
    assert smoke.numpy_fused(kb, vb, 4, kp, vp, 4) == (
        5, [10 + 2 * 20 + 2 * 30], [2 * 1 + 2 * 2 + 1 * 3])


# ---- the measuring tools --------------------------------------------------


def test_microbench_lines_and_bytes(capsys):
    got = microbench.run(10, "cpu", reps=1)
    out = capsys.readouterr().out.splitlines()
    assert set(got) == set(microbench.BYTES)
    for name in microbench.BYTES:
        (line,) = [ln for ln in out if ln.startswith(f"microbench {name} ")]
        assert line.endswith(f"({HOST_CLOCK})")
    # by hand at 2^10: a random u64 gather reads 1,024 8-byte indices and
    # rows and writes 1,024 rows; the sort with two payloads reads keys
    # and two payloads and writes sorted keys, the permutation and two
    # gathered payloads
    assert got["gather u64 random"]["bytes"] == 3 * 8 * 1024 == 24_576
    assert got["gather u32 1K-block"]["bytes"] == (8 + 4 + 4) * 1024
    assert got["sort u64 +2 payloads"]["bytes"] == (3 + 4) * 8 * 1024
    assert got["copy u64"]["gbps"] == pytest.approx(
        16 * 1024 / got["copy u64"]["ms"] / 1e6)


def test_roofline_lines_bytes_and_member_parity(capsys):
    got = roofline.run(10, "cpu", reps=1)
    out = capsys.readouterr().out
    assert set(got["members"]) == set(smoke.MEMBERS) | {"ms full-range keys"}
    for name in got["members"]:
        assert f"roofline member {name} " in out
    for name in got["stages"]:
        assert f"roofline {name} " in out
    # by hand at 2^10 (radix plan bits 6: B 64, SPb 2,048): the prep sort
    # reads key + value and writes both (4 x 8 KB) and starts + cnts
    # (64 x 8 B); K4 reads 2 x 1,024 live u64 and starts + cnts, writes
    # the [2, 64, 2048] u64 matrix; K1 reads 2 x 1,024 keys, writes cnt
    # and lo (1,024 x 8 B); the sort writes an int32 perm
    st = got["stages"]
    assert st["radix _prep_side (one side)"]["bytes"] == 32_768 + 512
    assert st["K4 slot_fill (build key + value)"]["bytes"] == \
        16_384 + 512 + 2 * 64 * 2048 * 8
    assert st["K1 staircase_counts"]["bytes"] == 16_384 + 8_192
    assert st["ms sort (join_build, one side)"]["bytes"] == 20 * 1024
    assert st["ms unsort (counts)"]["bytes"] == 12 * 1024
    # keys and values of both sides read once: 4 x 8 KB over 3.35 TB/s
    assert got["floor_ms"] == pytest.approx(32_768 / 3.35e12 * 1e3)
    assert "every member answered count=" in out
    assert out.count(HOST_CLOCK) >= len(st) + len(got["members"])


def test_roofline_without_kernel_stages_leaves_out_k1_k4_k5(capsys):
    got = roofline.run(10, "cpu", reps=1, kernel_stages=False)
    out = capsys.readouterr().out
    assert set(got["stages"]) == {"radix _prep_side (one side)",
                                  "ms sort (join_build, one side)",
                                  "ms unsort (counts)"}
    for kernel in ("K1", "K4", "K5"):
        assert f"roofline {kernel} " not in out
    assert set(got["members"]) == set(smoke.MEMBERS) | {"ms full-range keys"}


@pytest.mark.parametrize("log2", [10, 21, 22, 23, 24])
def test_roofline_keys_keep_the_table_members(log2):
    """At 2^23 keys below 2^22 made a key table of 2^22 + 2 entries,
    past the engine's gate, so the table members had nothing to run
    on (found on the card)."""
    from sigmod2018_tpu_torch.config import EngineConfig

    D = roofline.key_domain(1 << log2)
    assert D <= 1 << log2
    assert (D - 1) + 3 <= EngineConfig().key_table_max == 1 << 22


def test_roofline_catches_a_member_that_disagrees(monkeypatch):
    real = radix_join.ms_fused

    def off_by_one(*args, **kw):
        count, sb, sp = real(*args, **kw)
        return count + 1, sb, sp

    monkeypatch.setattr(radix_join, "ms_fused", off_by_one)
    with pytest.raises(AssertionError, match="member ms"):
        roofline.run(10, "cpu", reps=1)


def test_bench_probe_lines_and_parity(capsys):
    got = bench_probe.run(10, 11, "cpu", reps=1)
    out = capsys.readouterr().out
    assert [r["log2"] for r in got["rows"]] == [10, 11]
    for logn in (10, 11):
        assert f"bench_probe 2^{logn} " in out
    assert out.count("parity held") == 2
    assert "bench_probe crossovers over 2^10..2^11" in out
    assert "EMIT_MS_MIN_ROWS = 2^18" in out and "RADIX_MIN_ROWS = 2^18" in out


@pytest.mark.parametrize("ratios,want", [
    ([0.5, 0.8, 1.2, 1.5], 2), ([1.2, 0.9, 1.1], 2), ([0.5, 0.7], None),
    ([1.1, 1.2], 0), ([1.2, 1.0], None)])
def test_crossover_is_the_start_of_the_last_winning_run(ratios, want):
    rows = [{"log2": i, "r": r} for i, r in enumerate(ratios)]
    assert bench_probe.crossover(rows, "r") == want


@pytest.mark.parametrize("tool", [microbench, roofline, bench_probe, soak,
                                  smoke])
def test_tools_run_on_the_card_by_default(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default platform runs")
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main([])


# ---- the timer ------------------------------------------------------------


def test_timer_on_the_cpu_is_the_host_clock():
    calls = []
    flush = timing.flush_buffer(torch.device("cpu"))
    assert flush.numel() == 1
    ms = timing.median_ms(lambda: calls.append(1), flush, reps=5)
    assert ms >= 0 and len(calls) == 3 + 5
    assert timing.clock_note(torch.device("cpu")) == HOST_CLOCK
    assert timing.FLUSH_BYTES > 50 << 20  # past the H100's L2
    t = timing.time_call(lambda: calls.append(1), flush, reps=5)
    assert not t.host_bound and t.tag() == "" and t.host_ms == t.ms


@pytest.mark.parametrize("host_ms", [0.0, 0.05, 0.1, 0.5, 1.19, 8.6])
def test_spin_outlasts_twice_the_host_issue(host_ms):
    """At the H100's top clock the wait before a timed call lasts at
    least twice one call's host issue time, and never less than ~0.2
    ms, so the card has every launch queued before it reaches them."""
    cycles = timing.spin_cycles(host_ms)
    assert cycles >= timing.SPIN_CYCLES
    assert cycles / timing.SPIN_CYCLES_PER_MS >= 2 * host_ms
    assert timing.SPIN_CYCLES / timing.SPIN_CYCLES_PER_MS > 0.2


@pytest.mark.parametrize("ms,host_ms,on_card,bound", [
    (0.5, 0.1, True, False), (0.5, 0.5, True, True), (0.2, 0.6, True, True),
    (0.2, 0.6, False, False)])
def test_timing_names_host_bound_calls(ms, host_ms, on_card, bound):
    t = timing.Timing(ms, host_ms, on_card)
    assert t.host_bound == bound
    assert ("host-bound" in t.tag()) == bound
    assert (f"host issue {host_ms:.4f} ms" in t.tag()) == on_card


# ---- query2sql --------------------------------------------------------------


def test_query2sql_matches_the_jax_translation():
    n = 0
    for work in sorted((ROOT / "workloads").glob("*/*.work")):
        lines = work.read_text().splitlines()
        want = [jax_sql(jparse(ln.strip())) for ln in lines
                if ln.strip() and ln.strip() not in ("F", "Done", "Exit")]
        assert query2sql.translate(lines) == want, work
        n += len(want)
    assert n == 46  # 8 + 8 + 6 + 12 + 12 queries


def test_query2sql_command_line():
    proc = subprocess.run(
        [sys.executable, "-m", "sigmod2018_tpu_torch.tools.query2sql"],
        input="0 1|0.0=1.0&1.1>3|1.2\nF\n", cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0
    assert proc.stdout.splitlines() == [
        jax_sql(jparse("0 1|0.0=1.0&1.1>3|1.2"))]

