"""chip_smoke.py's arithmetic, checked on the CPU: the bytes bounds of the
kernel table against counts made by hand at the shapes of its cases, the
case builders against what their cases claim to exercise, the workload
parameters against tools/regen_workloads.sh, the tier check, the
checks of the compiled engine's runs, the sort-form message against
the port's, phase 7b's fresh processes and tools/cold_start.py's studies
on workloads/zipf, and phase 10's driver (two ranks of the protocol
driver, the collective costs) run on the CPU at a small size."""

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


def test_workload_parameters_are_the_regen_script_s():
    """WORKLOADS holds tools/regen_workloads.sh's generator arguments,
    full size, and every workload's .work and .result are committed."""
    script = (ROOT / "tools" / "regen_workloads.sh").read_text()
    for name, p in cs.WORKLOADS.items():
        line = next(ln for ln in script.splitlines()
                    if f"workloads/{name} " in ln)
        args = dict(zip(line.split()[3::2], line.split()[4::2]))
        assert args["--profile"] == p["profile"]
        for key in ("rows", "relations", "keyspace", "seed"):
            assert int(args[f"--{key}"]) == p[key], (name, key)
        assert int(args.get("--scale", 10)) == p.get("scale", 10)
        work = (ROOT / "workloads" / name / f"{name}.work").read_text()
        want = (ROOT / "workloads" / name / f"{name}.result").read_text()
        assert (sum(ln != "F" for ln in work.splitlines())
                == len(want.splitlines()) == int(args["--queries"]))
    assert set(cs.FORCED_WORKLOADS) | set(cs.REQUIRED_TIERS) | set(
        cs.K1_WORKLOADS) <= set(cs.WORKLOADS)


@pytest.mark.parametrize("tiers,queries,name,ok", [
    (dict(materialized=2, factorized_proactive=4, factorized_blowup=0,
          text_order=0), 6, "zipfbig", True),
    (dict(materialized=5, factorized_proactive=0, factorized_blowup=1,
          text_order=0), 6, "zipfbig", True),
    (dict(materialized=6, factorized_proactive=0, factorized_blowup=0,
          text_order=0), 6, "zipfbig", False),   # no factorized tier
    (dict(materialized=2, factorized_proactive=3, factorized_blowup=0,
          text_order=0), 6, "zipfbig", False),   # a query uncounted
    (dict(materialized=11, factorized_proactive=0, factorized_blowup=1,
          text_order=0), 12, "scaled", False),   # proactive must serve
    (dict(materialized=8, factorized_proactive=0, factorized_blowup=0,
          text_order=0), 8, "bigdom", True),
])
def test_check_tiers(tiers, queries, name, ok):
    if ok:
        cs._check_tiers(name, "auto", tiers, queries)
    else:
        with pytest.raises(AssertionError):
            cs._check_tiers(name, "auto", tiers, queries)


def test_paths_put_the_main_path_first():
    """The compiled engine under auto runs first (its first run must
    start from the emptied prep cache and teach the second), on every
    workload, twice; the operator engine runs every workload once."""
    label, compiled, algo, runs, names = cs.PATHS[0]
    assert (label, compiled, algo, runs) == (cs.MAIN_PATH, True, "auto", 2)
    assert set(names) == set(cs.WORKLOADS)
    by_label = {p[0]: p for p in cs.PATHS}
    assert by_label["operator auto"][1:4] == (False, "auto", 1)
    assert set(by_label["operator auto"][4]) == set(cs.WORKLOADS)
    for algo in ("radix", "qd"):
        assert by_label[f"compiled {algo}"][1:] == (True, algo, 1,
                                                    cs.FORCED_WORKLOADS)
    assert cs.PREP_CACHE.parent == cs.SMOKE_DIR


def test_host_syncs_add_the_members_branch_reads():
    counts = {"engine": {"segment_reads": 3, "retried": 1},
              "radix branches": {"kernel": 4, "merge": 1},
              "qd branches": {"kernel": 2, "merge": 0}}
    assert cs.host_syncs(counts) == 3 + 5 + 2


@pytest.mark.parametrize("counts,ok", [
    (dict(segment_reads=0, no_class=3, learned=5, guessed=0, retried=0,
          incremental=0), True),
    (dict(segment_reads=1, no_class=3, learned=4, guessed=0, retried=1,
          incremental=0), False),
    (dict(segment_reads=1, no_class=3, learned=4, guessed=0, retried=0,
          incremental=1), False),
])
def test_check_taught(counts, ok):
    if ok:
        cs._check_taught("bigdom", counts)
    else:
        with pytest.raises(AssertionError):
            cs._check_taught("bigdom", counts)


def test_message_sort_form_equals_the_port_s_message():
    """The yardstick chip_smoke times beside the port's gather form
    computes the same message."""
    from sigmod2018_tpu_torch.engine.factorized import message
    from sigmod2018_tpu_torch.ops.sort_join import join_build
    from sigmod2018_tpu_torch.ops.u64 import ranks_u64

    gen = torch.Generator().manual_seed(5)
    P, n = 1 << 10, 900
    skeys = torch.randint(0, 50, (P,), generator=gen)
    rkeys = torch.randint(0, 60, (P,), generator=gen)
    sorted_keys, perm = join_build(skeys, n)
    lo = ranks_u64(sorted_keys, rkeys, "left").to(torch.int32)
    hi = ranks_u64(sorted_keys, rkeys, "right").to(torch.int32)
    se = (torch.arange(P) < n) & (torch.rand(P, generator=gen) < 0.7)
    sw = torch.randint(-(1 << 62), 1 << 62, (P,), generator=gen) * se
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(P, dtype=perm.dtype)
    got_w, got_e = message(sw, se, perm, lo, hi)
    alt_w, alt_e = cs.message_sort_form(sw, se, inv, lo, hi)
    assert torch.equal(got_w, alt_w) and torch.equal(got_e, alt_e)
    # by hand: receiver row 0's sum over the live senders with its key
    same = se & (skeys == rkeys[0])
    assert int(got_w[0]) == int(sw[same].sum()) and \
        bool(got_e[0]) == bool(same.any())


def test_one_memory_rate_for_bounds_and_trace():
    from sigmod2018_tpu_torch.utils import floors

    # the kernel table's bounds are floors.py's, over the trace's rate
    assert cs.bound is floors.kernel_bound
    assert floors.HBM_BYTES_PER_S == 3.35e12


def test_recording_passes_a_query_s_steps_through():
    """Phase 7c's spy on the totals the engine reads: it hands every
    (join, total) on and every (P, count) back, returns the packed
    vector, and closes the steps when the engine stops early."""
    closed = []

    def steps(totals):
        try:
            for name, t in totals:
                P, count = yield name, torch.tensor(t)
                assert (P, count) == (8, t)
            return "packed"
        finally:
            closed.append(True)

    seen = []
    gen = cs._recording(steps([("0.1=1.0", 5), ("1.2=2.0", 7)]), seen)
    assert next(gen)[0] == "0.1=1.0"
    assert gen.send((8, 5))[0] == "1.2=2.0"
    with pytest.raises(StopIteration) as done:
        gen.send((8, 7))
    assert done.value.value == "packed"
    assert seen == [("0.1=1.0", 5), ("1.2=2.0", 7)] and closed == [True]
    seen.clear()
    gen = cs._recording(steps([("0.1=1.0", 0), ("1.2=2.0", 7)]), seen)
    next(gen)
    gen.close()  # TorchEngine._sized on a zero total
    assert seen == [("0.1=1.0", 0)] and closed == [True, True]


def test_harness_runs_end_with_blocking_prep():
    assert list(cs.HARNESS_RUNS) == list(cs.WORKLOADS)
    for name, runs in cs.HARNESS_RUNS.items():
        if name in ("big", "bigdom"):
            assert [label for label, _ in runs] == [
                "cold", "warm", "warm, blocking prep"]
            assert [env for _, env in runs] == [
                {}, {}, {"S18_ASYNC_PREP": "0"}]
        else:
            assert runs == (("warm", {}),
                            ("warm, no tier", {"S18_WARMUP_ORACLE": "0"}))
    assert set(cs.NO_TIER_WORKLOADS) == {"big", "bigdom", "zipfbig"}
    assert "import torch" in cs.FRESH_PROCESS


def test_import_time_top_parses_importtime():
    top = cs.import_time_top(3)
    assert len(top) == 3 and top[0][0] == "torch"
    assert top[0][1] >= top[1][1] >= top[2][1] > 0


def test_thread_import_times_torch_in_a_thread():
    assert 0 < cs.thread_import_seconds() < 120


def test_harness_run_on_the_cpu(tmp_path, monkeypatch):
    """Phase 7b's fresh process on workloads/zipf, on the CPU: exact
    lines, the tier counts and the start timeline parsed; with the tier
    off it answers nothing."""
    from sigmod2018_tpu_torch.tools.workload import write_relations

    monkeypatch.setattr(cs, "SMOKE_DIR", tmp_path)
    monkeypatch.setenv("S18_PLATFORM", "cpu")
    write_relations(tmp_path / "zipf", **cs.WORKLOADS["zipf"])
    for extra in ({}, {"S18_WARMUP_ORACLE": "0"}):
        rec = cs.harness_run("zipf", cs.ROOT, tmp_path / "cache", extra)
        assert rec["queries"] == 12 and rec["ms"] >= 0
        assert rec["engine"].startswith("engine CompiledTorchEngine: ")
        assert sum(rec["tiers"].values()) == 12
        assert set(rec["start"]) >= {"done_read", "torch_imported",
                                     "first_line", "last_line"}
        assert cs._start_text(rec["start"]).startswith("start card_started ")
    assert rec["tiers"]["warmup_host"] == 0
    assert cs._start_text(None) == "no start line"


def test_cold_start_turns():
    from sigmod2018_tpu_torch.tools import cold_start

    assert cold_start.turns(4) == [0, 1, 1, 0, 0, 1, 1, 0]
    assert cold_start.serving_s({"engine_built": 2.0, "last_line": 3.5}) \
        == 1.5
    assert cold_start.serving_s({"engine_built": None, "last_line": 3.5}) \
        is None


@pytest.mark.parametrize("label", ["arena", "switch"])
def test_cold_start_study_on_the_cpu(tmp_path, monkeypatch, capsys, label):
    """Each study's two drivers on workloads/zipf, one warm run each:
    exact lines (harness_run checks them), one median line per arm."""
    import sys

    from sigmod2018_tpu_torch.tools import cold_start
    from sigmod2018_tpu_torch.tools.workload import write_relations

    monkeypatch.setattr(cs, "SMOKE_DIR", tmp_path)
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    monkeypatch.setenv("S18_PLATFORM", "cpu")
    write_relations(tmp_path / "zipf", **cs.WORKLOADS["zipf"])
    _, env, arms = cold_start.STUDIES[label]
    recs = cold_start.study(label, ("zipf",), env,
                            [(arm, cs.ROOT, driver) for arm, driver in arms],
                            1, "cpu")
    names = [arm for arm, _ in arms]
    assert [(r["arm"], r["kind"]) for r in recs] == [
        (names[0], "cold"), (names[1], "cold"), (names[0], "warm"),
        (names[1], "warm")]
    assert all(r["queries"] == 12 for r in recs)
    if env:  # the arena study: the tier off
        assert [r["tiers"]["warmup_host"] for r in recs] == [0] * 4
    out = capsys.readouterr().out
    assert out.count(f"cold start median [{label} zipf ") == 2


def test_cold_start_arms_run_the_driver_after_their_prelude():
    from sigmod2018_tpu_torch.io import repl
    from sigmod2018_tpu_torch.tools import cold_start

    flag, code = cold_start.patched("sys.setswitchinterval(1e-4)")
    assert flag == "-c" and code.endswith("\nrepl.main()")
    assert code.index("sys.setswitchinterval") < code.index("repl.main()")
    # the arena study's variant replaces a function the driver has
    assert callable(repl.one_malloc_arena)
    assert "repl.one_malloc_arena = lambda: False" in \
        cold_start.STUDIES["arena"][2][1][1][1]


def test_one_timer_for_chip_smoke_and_the_tools():
    from sigmod2018_tpu_torch.utils import timing

    assert cs.median_ms is timing.median_ms
    assert cs.card_line is timing.card_line
    assert timing.SPIN_CYCLES == 400_000 and timing.FLUSH_BYTES == 64 << 20


def test_phase_9_fuzzes_every_member_and_the_mesh():
    assert cs.FUZZ_SEED == 99
    assert [(label, join, shards, n) for label, join, shards, n
            in cs.FUZZ_RUNS] == [("auto", "auto", 0, 200),
                                 ("ms", "ms", 0, 200),
                                 ("radix", "radix", 0, 200),
                                 ("qd", "qd", 0, 200),
                                 ("mesh 4", "auto", 4, 60)]
    assert cs.FUZZ_KERNELS == {"ms": ("K1",), "radix": ("K4", "K5"),
                               "qd": ("K4", "K5")}


def test_phase_10_runs_two_ranks_on_the_cpu(tmp_path, monkeypatch):
    """Phase 10's driver on the CPU at a small size: two ranks of the
    protocol driver on 4 shards, twice from one emptied prep cache, on
    relations of workloads/zipf's profile at 1,000 rows with its
    queries; every rank's lines equal the NumPy twins', the second run
    is sized from what rank 0 learned, and the records carry both
    ranks' reports."""
    from sigmod2018_tpu_torch.engine.factorized import (
        execute_query_factorized_np)
    from sigmod2018_tpu_torch.engine.oracle import execute_query_numpy
    from sigmod2018_tpu_torch.frontend.parser import parse_query
    from sigmod2018_tpu_torch.storage.catalog import Catalog
    from sigmod2018_tpu_torch.tools.workload import write_relations

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # per rank
    rels = write_relations(tmp_path / "rels", profile="zipf", rows=1000,
                           relations=6, keyspace=5000, seed=4)
    work = (ROOT / "workloads" / "zipf" / "zipf.work").read_text(
        ).splitlines()
    catalog = Catalog.from_files([str(r) for r in rels])
    # the factorized twin answers the forest queries without
    # materializing their blow-ups
    want = [execute_query_factorized_np(parse_query(q), catalog)
            or execute_query_numpy(parse_query(q), catalog)
            for q in work if q != "F"]
    paths = [("2 ranks mesh4 a2a", "mesh4 a2a compiled", {}, 2, ("tiny",))]
    records = cs.multiprocess_runs(
        "cpu", {"tiny": ([str(r) for r in rels], work, want)}, paths=paths,
        prep_cache=tmp_path / "prep", timeout=90, k1_workloads=(),
        strategies=("broadcast",))
    assert [(r["name"], r["run"]) for r in records] == [("tiny", 1),
                                                        ("tiny", 2)]
    for rec in records:
        assert [rep["rank"] for rep in rec["ranks"]] == [0, 1]
        assert all(rep["world"] == 2 and rep["lines_equal"] == len(want)
                   for rep in rec["ranks"])
    assert records[1]["ranks"][0]["counts"]["learned"] > 0
    assert [p.name for p in (tmp_path / "prep").glob("learned-*")] != []


def test_phase_10_fails_on_a_wrong_line(tmp_path):
    """A rank whose line differs from the .result fails the phase."""
    from sigmod2018_tpu_torch.tools.workload import write_relations

    rels = write_relations(tmp_path / "rels", profile="uniform", rows=300,
                           relations=2, keyspace=50, seed=1)
    paths = [("2 ranks", "mesh4 a2a compiled", {}, 1, ("tiny",))]
    with pytest.raises(AssertionError, match="rank 0: 0/1 lines"):
        cs.multiprocess_runs(
            "cpu", {"tiny": ([str(r) for r in rels],
                             ["0 1|0.0=1.0|0.1", "F"], ["1 2"])},
            paths=paths, prep_cache=tmp_path / "prep", timeout=90,
            k1_workloads=(), strategies=())


def test_phase_10_paths():
    """The a2a runs come first (their first run teaches the second, from
    the emptied prep cache), every workload twice, on phase 8's
    switches; the zipf runs are phase 8's strategy runs."""
    label, mesh_label, extra, runs, names = cs.MP_PATHS[0]
    assert (extra, runs, set(names)) == ({}, 2, set(cs.WORKLOADS))
    mesh = {p[0]: p for p in cs.MESH_PATHS}
    for label, mesh_label, extra, runs, names in cs.MP_PATHS:
        assert mesh[mesh_label][3] == runs and mesh[mesh_label][4][-1] in (
            names)
    assert cs.MP_WORLD == 2 and cs.MP_PREP_CACHE.parent == cs.SMOKE_DIR
    assert set(cs.MP_STRATEGIES) == {"broadcast", "shuffle", "skew"}


def test_phase_10_collective_costs_on_the_cpu(monkeypatch):
    """tools.collective_cost as one process and as two ranks: every case
    timed in each, the ranks over the gloo transport, the bytes a rank
    sends half of what the one process sends (it owns half the shards),
    and the ranks' largest all_to_all timed in its three parts."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    one, ranks = cs.collective_costs("cpu", timeout=60)
    assert (one["world"], one["shards"]) == (1, 4)
    assert [(r["world"], r["rank"]) for r in ranks] == [(2, 0), (2, 1)]
    assert ranks[0]["transport"].startswith("gloo")
    for r in ranks:
        assert r["cases"].keys() == one["cases"].keys()
        for case, c in r["cases"].items():
            assert c["ms"] > 0
            assert 2 * c["bytes"] == one["cases"][case]["bytes"]
    assert one["cases"]["all_to_all [4, 131,072]"]["bytes"] == 4 * 8 * 4 * (
        1 << 17)
    # the largest all_to_all in its parts, under the group only
    assert one["a2a_parts"] is None
    for r in ranks:
        assert r["a2a_parts"].keys() == {"stage", "exchange", "unstage"}
        assert all(ms > 0 for ms in r["a2a_parts"].values())


def test_phase_11_arms():
    """The edge arms take every join to K1 or none to it; the crossover
    arms are the defaults against bench_probe's crossovers, three runs
    each on the workloads whose joins reach 2^21 padded rows."""
    (zero, zero_env), (huge, huge_env) = cs.THRESHOLD_EDGE
    assert zero_env == {"S18_EMIT_MS_MIN": "0", "S18_RADIX_MIN": "0"}
    assert huge_env == dict.fromkeys(("S18_EMIT_MS_MIN", "S18_RADIX_MIN"),
                                     str(1 << 62))
    assert cs.THRESHOLD_EDGE_WORKLOADS == tuple(cs.WORKLOADS)
    assert [env for _, env in cs.THRESHOLD_CROSSOVER] == [
        {}, {"S18_EMIT_MS_MIN": "4194304", "S18_RADIX_MIN": "1048576"}]
    assert cs.THRESHOLD_RUNS == 3 and cs.K1_WORKLOADS == ("big", "bigdom",
                                                          "zipfbig")
    cs.check_edge_launches({(zero, "big"): 4, (huge, "big"): 0})
    with pytest.raises(AssertionError, match="K1 never launched"):
        cs.check_edge_launches({(zero, "scaled"): 0})
    with pytest.raises(AssertionError, match="K1 launched 2 times"):
        cs.check_edge_launches({(huge, "zipfbig"): 2})


def test_phase_11_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Phase 11's arms on workloads/zipf on the CPU, each from its own copy
    of a prep cache: exact lines (harness_run checks them), the engine
    serving every query of the edge arms, the driver's kernel launches
    parsed (none on the CPU: the plain twins serve), one median line per
    crossover arm and the pairs line."""
    from sigmod2018_tpu_torch.tools.workload import write_relations

    monkeypatch.setattr(cs, "SMOKE_DIR", tmp_path)
    monkeypatch.setattr(cs, "PREP_CACHE", tmp_path / "prep")
    (tmp_path / "prep").mkdir()
    monkeypatch.setenv("S18_PLATFORM", "cpu")
    write_relations(tmp_path / "zipf", **cs.WORKLOADS["zipf"])
    k1 = cs.threshold_edges("cpu", ("zipf",))
    assert k1 == {(label, "zipf"): 0 for label, _ in cs.THRESHOLD_EDGE}
    got = cs.threshold_crossovers("cpu", ("zipf",), runs=1)
    assert list(got["zipf"]) == [label for label, _ in cs.THRESHOLD_CROSSOVER]
    assert all(len(ms) == 1 for ms in got["zipf"].values())
    out = capsys.readouterr().out
    assert out.count("thresholds [zipf ") == 4
    assert "launches K1 0 K4 0 K5 0;" in out
    assert out.count("thresholds median [zipf ") == 2
    assert out.count("thresholds pairs [zipf]: ") == 1
    assert len(list(tmp_path.glob("threshold-prep-*-zipf"))) == 4


def test_emit_bytes_by_hand():
    import numpy as np

    # starts 0, 0, 2, 2, 5: rows 1 and 3 own kept slots, row 4 starts past
    # out_size 4; 4 of the 6 pairs kept
    cnt = np.array([0, 2, 0, 3, 1])
    assert cs.emit_bytes(cnt, 4) == 12 * 2 + 4 * 4 + 8 * 4


def test_emit_cases_are_the_shapes_they_name():
    import numpy as np

    from sigmod2018_tpu_torch.utils.padding import size_class

    (_, Pp, live, Pb, share, _, out_size), (_, bPp, blive, bPb, _, btotal,
                                            _) = cs.EMIT_CASES
    perm, lo, cnt = cs.emit_inputs(Pp, live, Pb, share, None)
    assert cnt[live:].sum() == 0 and int(cnt.max()) == 1
    assert 0.035 * live < cnt.sum() <= out_size  # ~4% matched, all kept
    assert sorted(perm) == list(range(Pb))
    assert (lo[cnt > 0] + cnt[cnt > 0] <= Pb).all()
    perm, lo, cnt = cs.emit_inputs(bPp, blive, bPb, None, btotal)
    assert cnt.sum() == btotal == 4_264_621 and cnt[blive:].sum() == 0
    assert size_class(btotal) == 1 << 23
    assert (lo + cnt <= bPb).all() and lo.dtype == np.int32


def test_phase_emit_on_the_cpu(capsys):
    """Phase 3b at small shapes on the CPU: join_emit equals the NumPy
    expansion (the phase raises otherwise), a total past out_size
    included."""
    cases = (("mostly dead", 4096, 3000, 256, 0.04, None, None),
             ("spread", 2048, 2000, 2048, None, 4300, None),
             ("truncated", 1024, 1000, 512, None, 3000, 1024))
    dev = torch.device("cpu")
    times = cs.phase_emit(dev, "cpu", cs.flush_buffer(dev), cases)
    assert set(times) == {"mostly dead", "spread", "truncated"}
    out = capsys.readouterr().out
    assert out.count("exact against the NumPy expansion") == 3


def test_phase_emit_fails_on_a_wrong_expansion(monkeypatch):
    from sigmod2018_tpu_torch.ops import sort_join

    real = sort_join.join_emit

    def shifted(*args, out_size):
        b, p = real(*args, out_size=out_size)
        return b, torch.roll(p, 1)

    monkeypatch.setattr(sort_join, "join_emit", shifted)
    dev = torch.device("cpu")
    with pytest.raises(AssertionError, match="probe_pos differs"):
        cs.phase_emit(dev, "cpu", cs.flush_buffer(dev),
                      (("spread", 2048, 2000, 2048, None, 4300, None),))
