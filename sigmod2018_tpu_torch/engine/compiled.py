"""Whole-query engine: speculative intermediate sizing, learned size
classes and the per-text fast path.

Counterpart of `sigmod2018_tpu/engine/compiled.py::CompiledEngine`.  The
only value the host must supply while a query runs is the padded output
size of each intermediate join.  The operator engine (executor.py) reads
every intermediate join's total to the host to choose it, which stops
the dispatching thread until the card catches up.  This engine supplies
the sizes beforehand instead:

- a query whose final join is fused (or that has no join) needs none:
  its whole device work is dispatched at once;
- a text seen before uses the size classes learned from its earlier
  totals, persisted per (relation set, sizing config) in the prep cache,
  so a new process serving the same files learns nothing twice;
- otherwise each class is guessed as the planner's estimate times
  `spec_margin`.

The device work then returns the true totals in front of the packed
result, [t_1..t_k, count, sum_0..sum_{V-1}], and `SpecResult` checks them
when the batch is fetched: a total over its class (the intermediate was
cut to its first P rows) or over `max_intermediate` sends the query
through `retry`, which runs it again with one host read per intermediate
join.  A query with a guess past `spec_max` takes that path at once.
Only the totals of a line that holds are learned, and no class is used
past the class of the largest total the guard lets through, so a
blow-up is never sized from what an earlier run of its text saw.

A repeated text also skips the host planning: its join order, device
columns and classes are kept per text (`_fastpath`).

The JAX engine's program machinery is not carried over: eager PyTorch
traces and compiles nothing, so there is no program cache to key by the
query's skeleton, no vault of exported programs and nothing to quiesce
(ROADMAP.md Queue 1 #7 and #10).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..config import DEFAULT_CONFIG, EngineConfig, total_limit
from ..frontend.parser import FilterPred, JoinPred, Query, parse_query
from ..planner import plan_joins
from ..planner.join_order import estimate_cardinalities
from ..storage.catalog import Catalog, identity_digest, prep_cache_dir
from ..utils.padding import size_class
from .executor import (IntermediateBlowup, NullResult, PendingResult,
                       Result, TorchEngine, format_batch)

# Dispatches by the way this engine sized them, counted in
# CompiledTorchEngine.counts beside the base engine's segment_reads:
# no_class (fused final join or no join: nothing to size), learned and
# guessed (speculative), retried (a speculation that failed its check at
# fetch), incremental (one host read per intermediate join from the
# start).
SPEC_COUNTS = ("no_class", "learned", "guessed", "retried", "incremental")

FASTPATH_MAX = 8192  # texts kept by the per-text fast path

Cols = Dict[Tuple[int, int], Tuple[torch.Tensor, int]]


class SpecResult(PendingResult):
    """A speculatively sized answer: the packed device vector
    [t_1..t_k, count, sum_0..sum_{V-1}], t_i the true totals of the
    intermediate joins.  Valid iff every t_i fit its class and none
    passed `limit` (total_limit); otherwise `retry` answers.  `record`
    learns the totals of a valid line (a miss is learned by the retry,
    a blow-up never); `served` counts its tier."""

    def __init__(self, packed: torch.Tensor, num_views: int,
                 classes: Tuple[int, ...], limit: int,
                 retry: Callable[[], str],
                 record: Callable[[Tuple[int, ...]], None],
                 served: Callable[[], None]):
        super().__init__(packed, num_views)
        self.classes = classes
        self.limit = limit
        self.retry = retry
        self.record = record
        self.served = served

    def line_from(self, values: Sequence[int]) -> str:
        k = len(self.classes)
        totals = tuple(int(t) for t in values[:k])
        if any(t > c for t, c in zip(totals, self.classes)) or (
                max(totals) > self.limit):
            return self.retry()
        self.record(totals)
        self.served()
        return super().line_from(values[k:])


def _steps(engine: TorchEngine, query: Query, joins, cols: Cols):
    def col_of(binding: int, column: int):
        return cols[(query.relations[binding], column)]

    return engine._steps(query, joins, col_of)


def run_segments(engine: TorchEngine, query: Query,
                 joins: Sequence[JoinPred], classes: Tuple[int, ...],
                 cols: Cols) -> torch.Tensor:
    """The query's device work with the size classes of its first k
    intermediate joins given, reading nothing from the device (the port
    of the JAX `_run_segments` program).  Returns the next intermediate
    join's total (0-d int64) when the query has more than k, else the
    packed int64 vector [t_1..t_k, count, sum_0..sum_{V-1}].  A join
    whose total passes its class keeps its first P rows."""
    steps = _steps(engine, query, joins, cols)
    totals: List[torch.Tensor] = []
    try:
        _, total = next(steps)
        for P in classes:
            totals.append(total.reshape(1))
            _, total = steps.send((P, torch.clamp(total, max=P)))
    except StopIteration as done:
        return torch.cat(totals + [done.value])
    return total


class _Fallback(Exception):
    """The query's shape is not static (a cartesian product of
    disconnected bindings): the operator engine serves it."""


class CompiledTorchEngine(TorchEngine):
    """TorchEngine with speculative sizing (S18_SPECULATE), learned size
    classes and the per-text fast path.  The default engine of
    `python -m sigmod2018_tpu_torch` (S18_COMPILE_QUERIES=0 serves with
    TorchEngine)."""

    def __init__(self, catalog: Catalog,
                 config: EngineConfig = DEFAULT_CONFIG):
        super().__init__(catalog, config)
        self.counts.update(dict.fromkeys(SPEC_COUNTS, 0))
        # query text -> (classes, join order, device columns)
        self._fastpath: Dict[str, tuple] = {}
        # Learned size classes: query text -> classes of the totals of
        # its last run.  Written from the batch threads and at fetch.
        self._learn_lock = threading.Lock()
        # No speculation sizes a join past the class of the largest total
        # the guard lets through.
        self._limit = total_limit(self.config)
        self._class_cap = size_class(self._limit)
        self._learned_path = self._learned_file()
        self._learned_classes = self._learned_cache()

    # ---- learned size classes ----------------------------------------------

    def _prep_key(self) -> Optional[Tuple[str, str, str]]:
        """(cache dir, relation-set digest, sizing-config hash), or None
        when the prep cache is off or the relations are not files."""
        base = prep_cache_dir()
        paths = self.catalog.source_paths
        digest = identity_digest(paths) if (base and paths) else None
        if digest is None:
            return None
        cfg = self.config
        ch = hashlib.sha1(f"{cfg.join_algo}:{cfg.key_table_max}".encode()
                          ).hexdigest()[:8]
        return base, digest, ch

    def _learned_file(self) -> Optional[str]:
        pk = self._prep_key()
        if pk is None:
            return None
        base, digest, ch = pk
        return os.path.join(base, f"learned-torch-{digest}-{ch}.json")

    def _learned_cache(self) -> Dict[str, Tuple[int, ...]]:
        """The persisted classes of this relation set and config (empty
        when there are none): a stale entry costs one retry."""
        if self._learned_path is None:
            return {}
        try:
            with open(self._learned_path) as fh:
                raw = json.load(fh)
        except (OSError, ValueError):
            return {}
        return {k: tuple(int(t) for t in v) for k, v in raw.items()
                if isinstance(v, list)}

    def _learned(self, query: Query) -> Optional[Tuple[int, ...]]:
        """The text's learned classes, or None.  The file is shared by
        every max_intermediate setting, so a class past this engine's
        cap is not used: that text is guessed again."""
        classes = self._learned_classes.get(query.text)
        if classes and max(classes) > self._class_cap:
            return None
        return classes

    def _learn(self, text: str, classes: Tuple[int, ...]) -> None:
        with self._learn_lock:
            if self._learned_classes.get(text) == classes:
                return
            self._learned_classes[text] = classes
            self._persist_learned()

    def _forget(self, text: str) -> None:
        """Drop a text's learned values (the mesh engine's, when a line
        sized from them missed and its retry learned nothing new)."""
        with self._learn_lock:
            if self._learned_classes.pop(text, None) is not None:
                self._persist_learned()

    def _persist_learned(self) -> None:
        """Write the learned classes to the prep cache (under
        _learn_lock)."""
        fp = self._learned_path
        if fp is None:
            return
        try:
            os.makedirs(os.path.dirname(fp), exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(fp),
                                       suffix=".json")
            with os.fdopen(fd, "w") as fh:
                json.dump({k: list(v) for k, v in
                           self._learned_classes.items()}, fh)
            os.replace(tmp, fp)  # atomic: concurrent servers race benignly
        except OSError as exc:
            # Serving goes on: a process that cannot persist its
            # classes only costs the next one a learning run.
            self._learned_path = None
            print(f"learned size classes not persisted: {exc!r}",
                  file=sys.stderr)

    def _make_recorder(self, query: Query):
        def record(totals: Tuple[int, ...]) -> None:
            self._learn(query.text,
                        tuple(size_class(max(t, 1)) for t in totals))

        return record

    def prefetch(self) -> None:
        """The base prefetch, then (S18_WARM_REPLAY=1) one untimed run of
        every text whose classes an earlier process persisted."""
        super().prefetch()
        if self.config.warm_replay:
            self._replay_learned()

    def _replay_learned(self, cap: int = 512) -> None:
        with self._learn_lock:  # serving may be learning meanwhile
            texts = list(self._learned_classes)[:cap]
        # The replay is prep: its dispatches and lines (made in this
        # thread) are not counted, so the counts are serving's alone,
        # also when serving starts while the replay runs (async prep).
        self._uncounted.on = True
        try:
            format_batch([self.execute_async(parse_query(t)) for t in texts])
        finally:
            self._uncounted.on = False

    # ---- execution -----------------------------------------------------------

    def _execute_async_device(self, query: Query) -> Result:
        try:
            res = self._execute_compiled(query)
        except _Fallback:
            return super()._execute_async_device(query)
        except IntermediateBlowup:
            return self._blowup_net(query)
        if isinstance(res, SpecResult):
            return res  # its tier is counted when its line is made
        return self._served("materialized", res)

    def _execute_compiled(self, query: Query) -> Result:
        # Per-text fast path: a repeated text reuses its join order,
        # device columns and classes, unless the learned classes have
        # since diverged from the cached ones.
        fkey = query.text or None
        hit = self._fastpath.get(fkey) if fkey else None
        if hit is not None:
            classes, joins, cols = hit
            learned = self._learned(query)
            if (learned is None or len(learned) != len(classes)
                    or learned == classes):
                return self._speculate(query, joins, cols, classes)
            self._fastpath.pop(fkey, None)
        joins, cols_used, n_classes, class_idx = self._static_plan(query)
        cols = {rc: self.device_column(*rc) for rc in cols_used}
        classes: Optional[Tuple[int, ...]] = ()
        if n_classes:
            classes = None
            if self.config.speculate:
                learned = self._learned(query)
                classes = (learned if learned is not None
                           and len(learned) == n_classes
                           else self._guess_classes(query, joins, class_idx))
            if classes is None:
                self._count("incremental")
                return self._run_incremental(query, joins, cols)
        if fkey:
            if len(self._fastpath) >= FASTPATH_MAX:
                self._fastpath.clear()  # unbounded distinct texts: relearn
            self._fastpath[fkey] = (classes, joins, cols)
        return self._speculate(query, joins, cols, classes)

    def _speculate(self, query: Query, joins, cols: Cols,
                   classes: Tuple[int, ...]) -> PendingResult:
        out = run_segments(self, query, joins, classes, cols)
        # _static_plan and TorchEngine._steps each decide which joins
        # need a class; a disagreement would misread the packed vector.
        if out.dim() != 1 or out.numel() != (len(classes) + 1
                                             + len(query.views)):
            raise RuntimeError(
                f"the static plan sized {len(classes)} intermediate joins, "
                f"the query's steps another number: {query.text!r}")
        if not classes:
            self._count("no_class")
            return PendingResult(out, len(query.views))
        self._count("learned" if classes == self._learned(query)
                    else "guessed")
        return SpecResult(out, len(query.views), classes, self._limit,
                          retry=self._make_retry(query, joins, cols),
                          record=self._make_recorder(query),
                          served=lambda: self._served("materialized", None))

    def _make_retry(self, query: Query, joins, cols: Cols):
        def retry() -> str:
            self._count("retried")
            try:
                res = self._served("materialized",
                                   self._run_incremental(query, joins, cols))
            except IntermediateBlowup:
                res = self._blowup_net(query)
            return res.line()

        return retry

    def _run_incremental(self, query: Query, joins, cols: Cols) -> Result:
        """One host read per intermediate join (TorchEngine._sized); the
        classes found teach the next run of this text."""
        packed, classes = self._sized(_steps(self, query, joins, cols),
                                      guard=True)
        if packed is None:
            return NullResult(len(query.views))
        if classes:
            self._learn(query.text, classes)
        return PendingResult(packed, len(query.views))

    # ---- static analysis ---------------------------------------------------

    def _guess_classes(self, query: Query, joins,
                       class_idx: Tuple[int, ...]
                       ) -> Optional[Tuple[int, ...]]:
        """Size classes from the planner's estimates x spec_margin, none
        past the guard's class (a truth past it is a blow-up whatever
        the class); None when one would pass spec_max."""
        ests = estimate_cardinalities(query, self.catalog, joins)
        classes = []
        for idx in class_idx:
            cls = min(size_class(max(int(ests[idx]), 1)
                                 * self.config.spec_margin), self._class_cap)
            if cls > self.config.spec_max:
                return None
            classes.append(cls)
        return tuple(classes)

    def _static_plan(self, query: Query, use_planner: bool = True):
        """(join order, referenced (relation, column) pairs, number of
        intermediate joins to size, their indices in the order), from the
        component structure alone; the text order when not use_planner.
        Raises _Fallback for a query that needs a cartesian product."""
        joins = query.joins
        if use_planner and len(joins) > 1:
            joins = plan_joins(query, self.catalog)
        joins = tuple(joins)
        self._explain_plan(query, joins)

        comps: List[set] = []

        def find(b):
            for c in comps:
                if b in c:
                    return c
            return None

        for p in query.filters_and_selfjoins:
            b = p.binding if isinstance(p, FilterPred) else p.binding1
            if find(b) is None:
                comps.append({b})
        view_b = {b for b, _ in query.views}
        class_idx: List[int] = []
        for idx, jp in enumerate(joins):
            cl, cr = find(jp.binding1), find(jp.binding2)
            if cl is not None and cl is cr:
                continue  # same-component selection: no class
            merged = {jp.binding1, jp.binding2} | (cl or set()) | (cr or set())
            others = [c for c in comps if c is not cl and c is not cr]
            if idx == len(joins) - 1 and not others and view_b <= merged:
                break  # fused final join: no class
            class_idx.append(idx)
            comps = others + [merged]
        else:
            # No fused final join: one component must cover every view
            # binding, else the result is a cartesian product.
            if len(comps) != 1 or not view_b <= comps[0]:
                raise _Fallback
        cols_used = tuple(sorted(self._columns_referenced(query, joins)))
        return joins, cols_used, len(class_idx), tuple(class_idx)

    @staticmethod
    def _columns_referenced(query: Query, joins) -> set:
        used = set()
        for p in query.filters_and_selfjoins:
            if isinstance(p, FilterPred):
                used.add((query.relations[p.binding], p.column))
            else:
                used.add((query.relations[p.binding1], p.column1))
                used.add((query.relations[p.binding1], p.column2))
        for jp in joins:
            used.add((query.relations[jp.binding1], jp.column1))
            used.add((query.relations[jp.binding2], jp.column2))
        for b, c in query.views:
            used.add((query.relations[b], c))
        return used
