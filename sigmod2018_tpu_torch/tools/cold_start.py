"""Fresh serving processes under the contest harness, in turns: the
driver's cold start (io/repl.py) against a variant of it.

Run from the repository root on a machine with an NVIDIA GPU:

    python -m sigmod2018_tpu_torch.tools.cold_start [--studies arena,switch]
        [--reps 4] [--parent build/parent]
        [--out build/cold_start/cold_start.json]

Each run is one fresh process of the driver under tools/harness.py (1 s
prep window) on a workload of `chip_smoke.py` (`WORKLOADS`, the relation
binaries under build/smoke/, written from their seeds when missing), as
`chip_smoke.harness_run` drives it; every line must be exact.  The
kernels and the native loader are built before the first run.  A study
compares two arms on some workloads: per workload, one run of each arm
from an emptied prep cache of its own (cold), then `reps` warm runs of
each in turns (A B B A A B B A ...).  The studies:

- arena: the tier off (S18_WARMUP_ORACLE=0) and the default 8 batch
  threads, on bigdom and scaled: the driver as it is against the driver
  without `one_malloc_arena` (glibc's default malloc arenas);
- switch: the tier on, on zipf and scaled: the driver as it is (the
  interpreter's switch interval, 5 ms) against the driver with an
  interval of 0.1 ms from its start;
- parent (with --parent DIR, a directory under build/ that holds
  another checkout, e.g. the parent commit unpacked by `git archive`):
  on every workload, `python -m sigmod2018_tpu_torch` of the package in
  DIR against this one's.

Each run prints its timed ms, the engine's counts, the tier counts and
the start timeline; each study and workload then the medians of each
arm's warm timed ms and of its serving after the engine is made (last
line written less engine built), with the card's name and power limit.
Every record goes to --out.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MAIN = ("-m", "sigmod2018_tpu_torch")


def patched(prelude: str = "") -> tuple:
    """`python` arguments that run the driver's main after `prelude`,
    lines of Python that see the driver's module as `repl`."""
    return ("-c", f"import sys\nfrom sigmod2018_tpu_torch.io import repl\n"
                  f"{prelude}\nrepl.main()")


# study: (workloads, S18_* switches, ((arm, python arguments), ...))
STUDIES = {
    "arena": (("bigdom", "scaled"), {"S18_WARMUP_ORACLE": "0"},
              (("one arena", patched()),
               ("default arenas", patched(
                   "assert callable(repl.one_malloc_arena)\n"
                   "repl.one_malloc_arena = lambda: False")))),
    "switch": (("zipf", "scaled"), {},
               (("5 ms switch", patched()),
                ("0.1 ms switch", patched("sys.setswitchinterval(1e-4)")))),
}


def turns(reps: int) -> list:
    """The order of two arms' warm runs: 0 1 1 0 0 1 ..."""
    return [arm for i in range(reps) for arm in ((0, 1) if i % 2 == 0
                                                 else (1, 0))]


def serving_s(start) -> float | None:
    """Seconds from the engine made to the last line written."""
    if not start or start.get("engine_built") is None \
            or start.get("last_line") is None:
        return None
    return start["last_line"] - start["engine_built"]


def study(label: str, workloads, env: dict, arms, reps: int,
          card: str) -> list:
    """Run one study (module docstring); arms: ((arm, root, python
    arguments), (...)).  Returns every run's record."""
    import chip_smoke

    records = []
    for name in workloads:
        caches = []
        for arm, _, _ in arms:
            caches.append(chip_smoke.SMOKE_DIR
                          / f"cold-start-{label}-{arm}-{name}".replace(" ", "_"))
            shutil.rmtree(caches[-1], ignore_errors=True)
            caches[-1].mkdir(parents=True)
        order = [(i, "cold") for i in (0, 1)] + [(i, "warm")
                                                for i in turns(reps)]
        for i, kind in order:
            arm, root, driver = arms[i]
            rec = chip_smoke.harness_run(name, root, caches[i], env, driver)
            rec.update(study=label, workload=name, arm=arm, kind=kind,
                       serving_s=serving_s(rec["start"]))
            records.append(rec)
            print(f"cold start [{label} {name} {arm} {kind}] "
                  f"{rec['queries']} queries exact; timed phase {rec['ms']} "
                  f"ms; whole harness run {rec['wall']:.3f} s; "
                  f"{rec['engine']}; served by tier {rec['tiers']}; "
                  f"{chip_smoke._start_text(rec['start'])} ({card})",
                  flush=True)
        for arm, _, _ in arms:
            warm = [r for r in records if r["study"] == label and
                    r["workload"] == name and r["arm"] == arm and
                    r["kind"] == "warm"]
            ms = statistics.median(r["ms"] for r in warm)
            serve = [r["serving_s"] for r in warm if r["serving_s"] is not None]
            serve_text = (f"{statistics.median(serve):.3f} s" if serve
                          else "none (no engine made)")
            print(f"cold start median [{label} {name} {arm}] of {len(warm)} "
                  f"warm runs: timed phase {ms} ms, serving after the engine "
                  f"{serve_text} ({card})", flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--studies", default="arena,switch")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--parent", default="",
                    help="another checkout under build/ to compare with")
    ap.add_argument("--out", default=str(ROOT / "build" / "cold_start"
                                         / "cold_start.json"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("cold_start: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from sigmod2018_tpu_torch.ops import _kernels
    from sigmod2018_tpu_torch.storage import native
    from sigmod2018_tpu_torch.tools.workload import write_relations
    from sigmod2018_tpu_torch.utils.timing import card_line

    card = card_line()
    print(card, flush=True)
    _kernels.load_all(_kernels.NAMES)
    native.load()
    plan = [(label, *STUDIES[label][:2],
             [(arm, ROOT, driver) for arm, driver in STUDIES[label][2]])
            for label in filter(None, args.studies.split(","))]
    if args.parent:
        parent = Path(args.parent).resolve()
        if not parent.is_relative_to(ROOT / "build"):
            ap.error("--parent must be a directory under build/")
        for sub in ("kernels", "native"):  # the same sources, built once
            shutil.copytree(ROOT / "build" / sub, parent / "build" / sub,
                            dirs_exist_ok=True)
        plan.append(("parent", tuple(chip_smoke.WORKLOADS), {},
                     [("parent", parent, MAIN), ("change", ROOT, MAIN)]))
    for name in {n for _, names, _, _ in plan for n in names}:
        if not (chip_smoke.SMOKE_DIR / name / "r0").exists():
            write_relations(chip_smoke.SMOKE_DIR / name,
                            **chip_smoke.WORKLOADS[name])
    records = [rec for label, names, env, arms in plan
               for rec in study(label, names, env, arms, args.reps, card)]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(card=card, reps=args.reps,
                                              runs=records), indent=1))
    print(f"cold_start: records written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
