"""The operator-granular query executor on torch tensors.

Counterpart of `sigmod2018_tpu/engine/executor.py::JaxEngine`.  An
intermediate component is a dense [A, P] int32 row-id matrix on the
device (A = active bindings, P = power-of-two padded row count) with a
live count; every operator is a handful of eager torch calls.

Host-sync discipline, as in the reference package:

- filter / self-join / same-component-join counts stay on the device as
  0-d tensors feeding the next operator's live count;
- only an intermediate join syncs: its output cardinality sizes the emit;
- the last join of a query is fused with the checksums (ops/agg_join.py,
  ops/ms_join.py), so the final intermediate is never materialized;
- execute_async() returns a PendingResult holding one packed device
  vector [count, sum_0, ..sum_V]; format_batch fetches a whole batch's
  vectors in one copy.

A query's device work is one generator, `TorchEngine._steps`, which
stops at each intermediate join for its output size.  This engine
answers with the total read to the host (`_sized`);
engine/compiled.py answers with size classes known or guessed
beforehand, and reads nothing.

Empty results: every operator preserves emptiness, so final count == 0
iff some operator went empty iff a NULL line (the contest's rule).

Every op of the query path is called through `self._ops`: the ops
module, or under S18_TRACE the timing proxy of engine/trace.py, whose
report each materializing dispatch (`_execute`) prints.  The prep-time
functions (`device_*`, `prefetch`) stay untraced.  S18_EXPLAIN prints each
join order with the planner's estimates and each intermediate join's
total as `_sized` reads it, in the reference package's words.

The per-column caches of the `device_*` functions are built once per key
(`_once`): under async prep (io/repl.py) the prefetch threads and the
batch threads build them at the same time.

Serving tiers (execute_async; `TorchEngine.tiers` counts which served):

- `factorized_proactive`: a forest query whose PLANNED intermediates
  reach config.factorize_min answers by message passing
  (engine/factorized.py) and materializes nothing;
- `materialized`: the planner's order, operator by operator;
- `factorized_blowup`: the planner's order tripped max_intermediate (skew
  the estimator missed) and the query is a forest;
- `text_order`: it tripped and the query is cyclic or joins one binding
  pair twice: the text order is the net, bounded by the technical cap.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import ops
from ..config import DEFAULT_CONFIG, HARD_INTERMEDIATE_CAP, EngineConfig
from ..frontend.parser import FilterPred, JoinPred, Query
from ..ops import radix_join
from ..ops.u64 import MASK64
from ..planner import plan_joins
from ..planner.join_order import estimate_cardinalities
from ..storage.catalog import Catalog
from ..utils.padding import pad_to, size_class
from . import factorized

Count = Union[int, torch.Tensor]  # host int or device 0-d integer tensor

_MISSING = object()


@dataclasses.dataclass
class Component:
    """One connected piece of the intermediate result."""

    bindings: Tuple[int, ...]  # order matches table rows
    table: torch.Tensor  # [len(bindings), P] int32 row ids into base tables
    count: Count  # live rows (host int once known, else device scalar)

    def row(self, binding: int) -> torch.Tensor:
        return self.table[self.bindings.index(binding)]


class PendingResult:
    """A query's answer as one device vector [count, sum_0, ... sum_{V-1}]
    (int64 bit patterns of u64).  `line()` fetches and formats.  The
    count slot only gates the NULL line, so the factorized path puts its
    exact `exists` flag there."""

    def __init__(self, packed: torch.Tensor, num_views: int):
        self.packed = packed
        self.num_views = num_views

    def line_from(self, values: Sequence[int]) -> str:
        if int(values[0]) == 0:
            return " ".join("NULL" for _ in range(self.num_views))
        return " ".join(str(int(v) & MASK64) for v in values[1:])

    def line(self) -> str:
        return self.line_from(self.packed.tolist())


class NullResult:
    """Known-empty early exit (the host already saw a zero cardinality)."""

    def __init__(self, num_views: int):
        self.num_views = num_views

    def line(self) -> str:
        return " ".join("NULL" for _ in range(self.num_views))


Result = Union[PendingResult, NullResult]


class IntermediateBlowup(RuntimeError):
    """A planned join order produced an intermediate beyond the cap."""

TIERS = ("materialized", "factorized_proactive", "factorized_blowup",
         "text_order")


def format_batch(results: Sequence) -> List[str]:
    """Output lines of a batch: every PendingResult's packed vector comes
    to the host in ONE device->host copy.  Plain strings (answers made
    without the device) pass through."""
    pend = [r for r in results if isinstance(r, PendingResult)]
    fetched = {}
    if pend:
        flat = torch.cat([r.packed for r in pend]).tolist()
        off = 0
        for r in pend:
            fetched[id(r)] = flat[off:off + r.packed.shape[0]]
            off += r.packed.shape[0]
    lines = []
    for r in results:
        if isinstance(r, str):
            lines.append(r)
        elif isinstance(r, PendingResult):
            lines.append(r.line_from(fetched[id(r)]))
        else:
            lines.append(r.line())
    return lines


def _as_i64(n: Count, device) -> torch.Tensor:
    """A count as an int64 [1] device tensor."""
    if isinstance(n, torch.Tensor):
        return n.to(torch.int64).reshape(1)
    return torch.full((1,), n, dtype=torch.int64, device=device)


class TorchEngine:
    """Executes contest queries against a Catalog on one torch device."""

    # Prep-time join artifacts (presorts, key tables' prefix tables, radix
    # artifacts) feed the fused final join and fill the prefetch.  The
    # mesh engines (parallel/) re-partition the build side in their
    # shuffle, so they set this False: the prefetch then copies the
    # columns only, and the fused join takes none of them.
    prep_join_artifacts = True

    def __init__(self, catalog: Catalog,
                 config: EngineConfig = DEFAULT_CONFIG):
        self.catalog = catalog
        self.config = config
        self.device = config.device()
        self._columns: Dict[Tuple[int, int], Tuple[torch.Tensor, int]] = {}
        self._sorted_columns: Dict[Tuple[int, int], tuple] = {}
        self._key_tables: Dict[Tuple[int, int], Optional[torch.Tensor]] = {}
        self._prefix_tables: Dict[Tuple[int, int, int], torch.Tensor] = {}
        self._radix_keys: Dict[Tuple[int, int], Optional[tuple]] = {}
        self._radix_vals: Dict[Tuple[int, int, int], torch.Tensor] = {}
        # engine/factorized.py: per-edge (perm, lo, hi) and the per-text
        # routing decision of _maybe_factorized
        self._edge_ranks: Dict[Tuple[int, int, int, int], tuple] = {}
        self._fact_choice: Dict[str, bool] = {}
        # Queries answered per serving tier.  Incremented under a lock:
        # io/repl.py dispatches a batch's queries from several threads.
        self.tiers: Dict[str, int] = dict.fromkeys(TIERS, 0)
        # Host reads of intermediate-join totals (one per intermediate
        # join here); the compiled engine adds its speculation counts.
        self.counts: Dict[str, int] = {"segment_reads": 0}
        self._tier_lock = threading.Lock()
        # Set in a thread whose dispatches are prep, not serving (the
        # compiled engine's warm replay): they are not counted.
        self._uncounted = threading.local()
        # One lock per (cache, key) being built (_once), made under
        # _locks_lock.
        self._build_locks: Dict[tuple, threading.Lock] = {}
        self._locks_lock = threading.Lock()
        # The ops the query path calls (see the module docstring).
        self._ops = ops
        self._tracer = None
        if config.trace:
            from .trace import TimedOps, Tracer

            self._tracer = Tracer(
                self.device, mode="json" if config.trace == "json"
                else "table")
            self._ops = TimedOps(ops, self._tracer)

    # ---- storage ---------------------------------------------------------

    def _once(self, cache: dict, key, build):
        """cache[key], built by build() once: concurrent callers of one
        key wait for the first instead of building a duplicate (a presort
        of a 2^21-row column costs card time and memory)."""
        hit = cache.get(key, _MISSING)
        if hit is not _MISSING:
            return hit
        with self._locks_lock:
            lock = self._build_locks.setdefault((id(cache), key),
                                                threading.Lock())
        with lock:
            hit = cache.get(key, _MISSING)
            if hit is _MISSING:
                hit = build()
                cache[key] = hit
        return hit

    def device_column(self, rid: int, cid: int) -> Tuple[torch.Tensor, int]:
        """Base column as a padded device tensor (u64 bits in int64, pads
        0) + live length."""
        def build():
            col = np.array(self.catalog.column(rid, cid), dtype=np.uint64)
            host = pad_to(col, size_class(col.shape[0]))
            return (torch.from_numpy(host.view(np.int64)).to(self.device),
                    col.shape[0])

        return self._once(self._columns, (rid, cid), build)

    def device_sorted_column(self, rid: int, cid: int):
        """Prep-time sort of a base column: (sorted_keys, perm) as
        ops.join_build makes them.  The contest's prep window is untimed,
        so a join whose build side is an unfiltered base column skips its
        query-time sort."""
        return self._once(self._sorted_columns, (rid, cid),
                          lambda: ops.join_build(*self.device_column(rid,
                                                                     cid)))

    def device_key_table(self, rid: int, cid: int):
        """Domain rank table of a base column, or None when gated off:
        cumcnt[k] = #rows with key < k, k in [0, u+2], u = the column's
        exact max (catalog stats) — u+3 int32 entries, so the table's
        length encodes u.  A probe row's match range in the prep-sorted
        column is then two gathers.  Built host-side at prep."""
        def build():
            stats = self.catalog.stats
            if not (stats and self.config.key_table_max):
                return None
            u = int(stats[rid][cid].u)
            if u + 3 > self.config.key_table_max:
                return None
            col = np.asarray(self.catalog.column(rid, cid), dtype=np.uint64)
            cumcnt = np.zeros(u + 3, dtype=np.int32)
            cumcnt[1:u + 2] = np.cumsum(
                np.bincount(col.astype(np.int64), minlength=u + 1))
            cumcnt[u + 2] = cumcnt[u + 1]
            return torch.from_numpy(cumcnt).to(self.device)

        return self._once(self._key_tables, (rid, cid), build)

    def device_prefix_table(self, rid: int, key_cid: int, val_cid: int):
        """Prep-time prefix sums of a value column in the key-sorted
        order of `key_cid` ([P+1], ops.prefix_by_perm).  With a key table
        it makes a small fused join probe-only."""
        def build():
            _, perm = self.device_sorted_column(rid, key_cid)
            col, n = self.device_column(rid, val_cid)
            return ops.prefix_by_perm(col, perm, n)

        return self._once(self._prefix_tables, (rid, key_cid, val_cid),
                          build)

    def device_radix_keys(self, rid: int, cid: int):
        """Prep-time radix artifacts of a base column, or None when gated
        off: (bits, krot_sorted, perm, starts, cnts, max_occ) from
        ops.radix_prep_keys at bits = plan_bits(P).  Built only where the
        radix member consumes them: forced radix, padded size at least
        RADIX_MIN_ROWS, and no key table.  A fused radix join whose side
        is this unfiltered column then skips that side's sort."""
        def build():
            dev, n = self.device_column(rid, cid)
            P = dev.shape[0]
            if not (radix_join.radix_member_selected(P, P,
                                                     self.config.join_algo)
                    and P >= radix_join.RADIX_MIN_ROWS
                    and self.device_key_table(rid, cid) is None):
                return None
            bits = radix_join.plan_bits(P)
            return (bits,) + tuple(radix_join.radix_prep_keys(dev, n, bits))

        return self._once(self._radix_keys, (rid, cid), build)

    def device_radix_val(self, rid: int, key_cid: int, val_cid: int):
        """A value column pre-sorted in the radix artifact order of
        `key_cid` (pads ride along; the kernels weight only live slots),
        or None when that column has no radix artifacts."""
        art = self.device_radix_keys(rid, key_cid)
        if art is None:
            return None
        return self._once(
            self._radix_vals, (rid, key_cid, val_cid),
            lambda: self.device_column(rid, val_cid)[0].index_select(
                0, art[2]))

    def prefetch(self) -> None:
        """Copy every base column to the device, presort it, build its
        key table and the prefix tables of every (key-table column, value
        column) pair, or under forced radix its radix artifacts and
        pre-sorted value columns, ahead of the timed phase.  Columns run
        in threads: the copies, sorts and NumPy passes release the
        interpreter lock, and `_once` builds each artifact once."""
        def one_column(rid: int, cid: int, ncols: int) -> None:
            if not self.prep_join_artifacts:
                self.device_column(rid, cid)
                return
            self.device_sorted_column(rid, cid)
            if self.device_key_table(rid, cid) is not None:
                for vcid in range(ncols):
                    self.device_prefix_table(rid, cid, vcid)
            elif self.device_radix_keys(rid, cid) is not None:
                for vcid in range(ncols):
                    self.device_radix_val(rid, cid, vcid)

        work = [(rid, cid, rel.num_columns)
                for rid, rel in enumerate(self.catalog.relations)
                for cid in range(rel.num_columns)]
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=8,
                                thread_name_prefix="s18prep") as pool:
            list(pool.map(lambda w: one_column(*w), work))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- execution -------------------------------------------------------

    def execute(self, query: Query) -> str:
        return self.execute_async(query).line()

    def _served(self, tier: str, res: Result) -> Result:
        if not getattr(self._uncounted, "on", False):
            with self._tier_lock:
                self.tiers[tier] += 1
        return res

    def _maybe_factorized(self, query: Query) -> Optional[Result]:
        """Proactive factorized service: a forest query with at least two
        joins answers by message passing when an intermediate join of the
        planner's order is estimated at config.factorize_min rows or
        more, or the final (fused, never materialized) join at 16x that:
        a final estimate that far out flags a hot-key blowup which the
        intermediate estimates of Zipf workloads miss.  The decision is
        cached per query text; None -> the materializing path serves."""
        fmin = self.config.factorize_min
        if not fmin or len(query.joins) < 2:
            return None
        use = self._fact_choice.get(query.text)
        if use is None:
            ests = estimate_cardinalities(query, self.catalog,
                                          plan_joins(query, self.catalog))
            use = (max(ests[:-1], default=0) >= fmin
                   or ests[-1] >= fmin * 16)
            if use and factorized.plan_forest(query) is None:
                use = False  # cyclic or duplicate pair: not a forest
            self._fact_choice[query.text] = use
        return factorized.factorized_result(self, query) if use else None

    def execute_async(self, query: Query) -> Result:
        res = self._maybe_factorized(query)
        if res is not None:
            return self._served("factorized_proactive", res)
        return self._execute_async_device(query)

    def _execute_async_device(self, query: Query) -> Result:
        """The materializing tiers: the planner's order, and the blow-up
        net behind it.  The compiled engine overrides this."""
        try:
            return self._served("materialized", self._execute(
                query, use_planner=True, guard=True))
        except IntermediateBlowup:
            return self._blowup_net(query)

    def _blowup_net(self, query: Query) -> Result:
        """The planner's order exploded past max_intermediate (hot-key
        skew the estimator missed).  A forest query is answered exactly
        without materializing anything; otherwise the text order is the
        safety net, bounded by the technical cap."""
        res = factorized.factorized_result(self, query)
        if res is not None:
            return self._served("factorized_blowup", res)
        return self._served("text_order", self._execute(
            query, use_planner=False, guard=False))

    def _execute(self, query: Query, use_planner: bool = True,
                 guard: bool = True) -> Result:
        """A materializing dispatch; under S18_TRACE it reports the ops
        of this query (the tracer's records are per thread)."""
        if self._tracer is None:
            return self._execute_sized(query, use_planner, guard)
        self._tracer.reset()
        try:
            return self._execute_sized(query, use_planner, guard)
        finally:
            self._tracer.report(query.text)

    def _execute_sized(self, query: Query, use_planner: bool,
                       guard: bool) -> Result:
        joins = query.joins
        if use_planner and len(joins) > 1:
            joins = plan_joins(query, self.catalog)
        self._explain_plan(query, joins)

        def col_of(binding: int, column: int) -> Tuple[torch.Tensor, int]:
            return self.device_column(query.relations[binding], column)

        packed, _ = self._sized(self._steps(query, joins, col_of), guard)
        if packed is None:
            return NullResult(len(query.views))
        return PendingResult(packed, len(query.views))

    def _explain_plan(self, query: Query, joins: Sequence[JoinPred]) -> None:
        """S18_EXPLAIN: the join order with the planner's estimates."""
        if self.config.explain and joins:
            ests = estimate_cardinalities(query, self.catalog, joins)
            order = " -> ".join(f"{j} (est {e})" for j, e in zip(joins, ests))
            print(f"-- plan: {order}", file=sys.stderr)

    def _count(self, name: str, n: int = 1) -> None:
        if not getattr(self._uncounted, "on", False):
            with self._tier_lock:
                self.counts[name] += n

    def _sized(self, steps, guard: bool):
        """Run a query's steps (`_steps`) to the end, sizing every
        intermediate join from its total read to the host: the one sync
        of an intermediate join.  (packed vector, or None when a join
        came out empty; the size classes used)."""
        classes: List[int] = []
        try:
            jp, total_dev = next(steps)
            while True:
                total = int(total_dev)
                self._count("segment_reads")
                if (guard and 0 < self.config.max_intermediate < total) or (
                        total > HARD_INTERMEDIATE_CAP):
                    raise IntermediateBlowup(total)
                if self.config.explain:
                    print(f"--   {jp}: actual {total}", file=sys.stderr)
                if total == 0:
                    steps.close()
                    return None, tuple(classes)
                classes.append(size_class(total))
                jp, total_dev = steps.send((classes[-1], total))
        except StopIteration as done:
            return done.value, tuple(classes)

    def _steps(self, query: Query, joins: Sequence[JoinPred], col_of):
        """A query's device work in `joins` order, as a generator.  At
        each intermediate join it yields (the join, its total as a 0-d
        int64 device tensor) and takes back (P, count): the padded size of the
        join's output and its live count (a host int, or a 0-d device
        tensor when the output is speculatively sized and may have been
        cut at P).  It returns the packed [count, sum_0, ..] vector, or
        None when the host already knows the result is empty.  Only the
        cartesian phase reads from the device; nothing else here does."""
        components: List[Component] = []

        def find(binding: int) -> Optional[Component]:
            for c in components:
                if binding in c.bindings:
                    return c
            return None

        # ---- phase 1: filters and self-joins (no host syncs) -------------
        for pred in query.filters_and_selfjoins:
            if isinstance(pred, FilterPred):
                self._exec_filter(components, find, col_of, pred)
            else:
                self._exec_selfjoin(components, find, col_of, pred)

        # ---- phase 2: joins ----------------------------------------------
        view_bindings = {b for b, _ in query.views}
        for idx, jp in enumerate(joins):
            comp_l = find(jp.binding1)
            comp_r = find(jp.binding2)

            if comp_l is not None and comp_l is comp_r:
                # Both sides live in one component: value-equality selection.
                c1dev, _ = col_of(jp.binding1, jp.column1)
                c2dev, _ = col_of(jp.binding2, jp.column2)
                v1 = self._ops.gather_u64(c1dev, comp_l.row(jp.binding1))
                v2 = self._ops.gather_u64(c2dev, comp_l.row(jp.binding2))
                self._compact(components, comp_l,
                              self._ops.equal_mask(v1, v2, comp_l.count))
                continue

            if idx == len(joins) - 1:
                new_bindings = {jp.binding1, jp.binding2}
                if comp_l is not None:
                    new_bindings |= set(comp_l.bindings)
                if comp_r is not None:
                    new_bindings |= set(comp_r.bindings)
                lone = all(c is comp_l or c is comp_r for c in components)
                if lone and view_bindings <= new_bindings:
                    return self._exec_join_fused(query, col_of, comp_l,
                                                 comp_r, jp)

            build_left, perm, lo, ccum, total = self._join_counts(
                query, col_of, comp_l, comp_r, jp)
            P, count = yield jp, total
            self._join_emit(components, comp_l, comp_r, jp, build_left,
                            perm, lo, ccum, total, P, count)

        # ---- phase 3: cartesian of leftovers ------------------------------
        for b in view_bindings:
            if find(b) is None:
                n = self.catalog.relation(query.relations[b]).num_tuples
                if n == 0:
                    return None
                P = size_class(n)
                ident = torch.arange(P, dtype=torch.int32,
                                     device=self.device)[None, :]
                components.append(Component((b,), ident, n))
        while len(components) > 1:
            c1, c2 = components[0], components[1]
            total = self._host_count(c1) * self._host_count(c2)
            if total == 0:
                return None
            P = size_class(total)
            i1, i2 = self._ops.cartesian_indices(c1.count, c2.count, P,
                                                 self.device)
            table = torch.cat([self._ops.take_cols(c1.table, i1),
                               self._ops.take_cols(c2.table, i2)], 0)
            components = ([Component(c1.bindings + c2.bindings, table,
                                     total)] + components[2:])

        if not components:
            return None

        # ---- phase 4: checksums (single packed fetch) ---------------------
        comp = components[0]
        parts = [_as_i64(comp.count, self.device)]
        for b, c in query.views:
            coldev, _ = col_of(b, c)
            parts.append(self._ops.checksum(coldev, comp.row(b),
                                            comp.count).reshape(1))
        return torch.cat(parts)

    # ---- operator implementations ----------------------------------------

    @staticmethod
    def _host_count(comp: Component) -> int:
        if not isinstance(comp.count, int):
            comp.count = int(comp.count)
        return comp.count

    def _exec_filter(self, components, find, col_of,
                     pred: FilterPred) -> None:
        coldev, n_base = col_of(pred.binding, pred.column)
        comp = find(pred.binding)
        if comp is None:
            mask = self._ops.compare_mask(coldev, n_base, pred.op,
                                          pred.value)
            pos, cnt = self._ops.mask_positions(mask,
                                                out_size=coldev.shape[0])
            components.append(Component((pred.binding,), pos[None, :], cnt))
            return
        vals = self._ops.gather_u64(coldev, comp.row(pred.binding))
        self._compact(components, comp,
                      self._ops.compare_mask(vals, comp.count, pred.op,
                                             pred.value))

    def _exec_selfjoin(self, components, find, col_of,
                       pred: JoinPred) -> None:
        c1dev, n_base = col_of(pred.binding1, pred.column1)
        c2dev, _ = col_of(pred.binding1, pred.column2)
        comp = find(pred.binding1)
        if comp is None:
            mask = self._ops.equal_mask(c1dev, c2dev, n_base)
            pos, cnt = self._ops.mask_positions(mask,
                                                out_size=c1dev.shape[0])
            components.append(Component((pred.binding1,), pos[None, :], cnt))
            return
        rids = comp.row(pred.binding1)
        mask = self._ops.equal_mask(self._ops.gather_u64(c1dev, rids),
                                    self._ops.gather_u64(c2dev, rids),
                                    comp.count)
        self._compact(components, comp, mask)

    def _compact(self, components, comp: Component,
                 mask: torch.Tensor) -> None:
        pos, cnt = self._ops.mask_positions(mask,
                                            out_size=comp.table.shape[1])
        new = Component(comp.bindings, self._ops.take_cols(comp.table, pos),
                        cnt)
        components[:] = [c if c is not comp else new for c in components]

    def _join_keys(self, col_of, comp: Optional[Component], binding: int,
                   column: int) -> Tuple[torch.Tensor, Count]:
        coldev, n_base = col_of(binding, column)
        if comp is None:
            return coldev, n_base
        return self._ops.gather_u64(coldev, comp.row(binding)), comp.count

    def _build_side(self, query: Query, comp_l, comp_r, keys_l, keys_r,
                    jp: JoinPred):
        """(build_left, key table of the build side or None).  A side
        with a prep-time key table joins with zero sorts whatever its
        size, so it wins outright; else the smaller padded side builds."""
        tbl_l = (self.device_key_table(query.relations[jp.binding1],
                                       jp.column1)
                 if comp_l is None else None)
        tbl_r = (self.device_key_table(query.relations[jp.binding2],
                                       jp.column2)
                 if comp_r is None else None)
        if (tbl_l is None) != (tbl_r is None):
            build_left = tbl_l is not None
        else:
            build_left = keys_l.shape[0] <= keys_r.shape[0]
        return build_left, (tbl_l if build_left else tbl_r)

    def _join_counts(self, query: Query, col_of, comp_l, comp_r,
                     jp: JoinPred):
        """Probe side of an intermediate join: (build_left, perm, lo,
        ccum, total) with the match ranges in the build side's sorted
        coordinates and the total as a 0-d device tensor."""
        keys_l, n_l = self._join_keys(col_of, comp_l, jp.binding1,
                                      jp.column1)
        keys_r, n_r = self._join_keys(col_of, comp_r, jp.binding2,
                                      jp.column2)
        build_left, tbl_b = self._build_side(query, comp_l, comp_r, keys_l,
                                             keys_r, jp)
        keys_b, n_b = (keys_l, n_l) if build_left else (keys_r, n_r)
        keys_p, n_p = (keys_r, n_r) if build_left else (keys_l, n_l)
        comp_b = comp_l if build_left else comp_r
        b, c = ((jp.binding1, jp.column1) if build_left
                else (jp.binding2, jp.column2))
        if tbl_b is not None:
            # Key-table path: match ranges are two gathers, no sort.
            _, perm = self.device_sorted_column(query.relations[b], c)
            lo, _, ccum, total = self._ops.join_probe_count_table(
                tbl_b, keys_p, n_p)
        else:
            if comp_b is None:
                # Unfiltered base build side: prep-time sort.
                sorted_keys, perm = self.device_sorted_column(
                    query.relations[b], c)
            else:
                sorted_keys, perm = self._ops.join_build(keys_b, n_b)
            lo, _, ccum, total = self._ops.join_probe_count_auto(
                sorted_keys, n_b, keys_p, n_p)
        return build_left, perm, lo, ccum, total

    def _join_emit(self, components, comp_l, comp_r, jp: JoinPred,
                   build_left: bool, perm, lo, ccum, total, P: int,
                   count: Count) -> None:
        """Emit side of an intermediate join: the output component of P
        padded rows and `count` live ones replaces both inputs."""
        bpos, ppos = self._ops.join_emit(perm, lo, ccum, total, out_size=P)
        pos_l, pos_r = (bpos, ppos) if build_left else (ppos, bpos)

        rows: List[torch.Tensor] = []
        bindings: List[int] = []
        for comp, binding, pos in ((comp_l, jp.binding1, pos_l),
                                   (comp_r, jp.binding2, pos_r)):
            if comp is not None:
                rows.append(self._ops.take_cols(comp.table, pos))
                bindings.extend(comp.bindings)
                components[:] = [x for x in components if x is not comp]
            else:
                rows.append(pos[None, :])
                bindings.append(binding)
        components.append(Component(tuple(bindings), torch.cat(rows, 0),
                                    count))

    def _exec_join_fused(self, query: Query, col_of, comp_l, comp_r,
                         jp: JoinPred) -> torch.Tensor:
        """Last join + checksums (ops.fused_join_auto): the final
        intermediate is never materialized and needs no sync.  Only the
        real projection columns of each side enter the member; the packed
        vector is assembled per view and returned."""
        keys_l, n_l = self._join_keys(col_of, comp_l, jp.binding1,
                                      jp.column1)
        keys_r, n_r = self._join_keys(col_of, comp_r, jp.binding2,
                                      jp.column2)
        build_left, tbl_b = self._build_side(query, comp_l, comp_r, keys_l,
                                             keys_r, jp)

        def side_of(binding: int) -> bool:
            """True = the jp.binding1 (left) side."""
            if comp_l is not None and binding in comp_l.bindings:
                return True
            if comp_r is not None and binding in comp_r.bindings:
                return False
            return binding == jp.binding1

        keys_b, n_b = (keys_l, n_l) if build_left else (keys_r, n_r)
        keys_p, n_p = (keys_r, n_r) if build_left else (keys_l, n_l)
        comp_b = comp_l if build_left else comp_r
        comp_p = comp_r if build_left else comp_l
        bb, bc = ((jp.binding1, jp.column1) if build_left
                  else (jp.binding2, jp.column2))
        pb, pc = ((jp.binding2, jp.column2) if build_left
                  else (jp.binding1, jp.column1))
        presorted = presorted_p = table = None
        prep = self.prep_join_artifacts
        if comp_b is None and prep:
            presorted = self.device_sorted_column(query.relations[bb], bc)
            if tbl_b is not None:
                table = (tbl_b, presorted[1])
        if comp_p is None and prep:
            # the staircase member consumes BOTH sides' prep sorts
            presorted_p = self.device_sorted_column(query.relations[pb], pc)

        Pb, Pp = keys_b.shape[0], keys_p.shape[0]
        algo = self.config.join_algo
        # The prefix-table member is probe-only: it takes no build-side
        # values, which the staircase, radix and qd members need.
        prefs_mode = (table is not None and algo not in ("radix", "qd")
                      and not self._ops.ms_member_selected(Pb, Pp, algo))

        brows, prows, prefs = [], [], []
        b_idx, p_idx = {}, {}
        for vi, (b, c) in enumerate(query.views):
            coldev, _ = col_of(b, c)
            comp = comp_l if side_of(b) else comp_r
            vals = (coldev if comp is None
                    else self._ops.gather_u64(coldev, comp.row(b)))
            if side_of(b) == build_left:
                if prefs_mode:
                    b_idx[vi] = len(prefs)
                    prefs.append(self.device_prefix_table(
                        query.relations[bb], bc, c))
                else:
                    b_idx[vi] = len(brows)
                    brows.append(vals)
            else:
                p_idx[vi] = len(prows)
                prows.append(vals)

        def stack(rows, P):
            if rows:
                return torch.stack(rows)
            return torch.zeros((0, P), dtype=torch.int64, device=self.device)

        def radix_side(binding: int, column: int, comp, build: bool):
            """(artifacts, pre-sorted value stack) of an unfiltered base
            side whose radix artifacts match this join's bits, else
            (None, None)."""
            if comp is not None or not prep:
                return None, None
            rel = query.relations[binding]
            art = self.device_radix_keys(rel, column)
            if art is None or art[0] != self._ops.plan_bits(Pb):
                return None, None
            rows = [self.device_radix_val(rel, column, c)
                    for b, c in query.views
                    if (side_of(b) == build_left) == build]
            return art[1:2] + art[3:], stack(rows, art[1].shape[0])

        radix_pre_b, radix_vals_b = radix_side(bb, bc, comp_b, True)
        radix_pre_p, radix_vals_p = radix_side(pb, pc, comp_p, False)
        count, sums_b, sums_p = self._fused_join(
            keys_b, None if prefs_mode else stack(brows, Pb), n_b,
            keys_p, stack(prows, Pp), n_p,
            algo=algo, presorted=presorted, table=table,
            table_prefs=stack(prefs, Pb + 1) if prefs_mode else None,
            radix_pre_b=radix_pre_b, radix_vals_b=radix_vals_b,
            radix_pre_p=radix_pre_p, radix_vals_p=radix_vals_p,
            presorted_p=presorted_p)
        parts = [count.reshape(1)]
        for vi in range(len(query.views)):
            s = sums_b[b_idx[vi]] if vi in b_idx else sums_p[p_idx[vi]]
            parts.append(s.reshape(1))
        return torch.cat(parts)

    def _fused_join(self, keys_b, vals_b, n_b: Count, keys_p, vals_p,
                    n_p: Count, **kw):
        """The fused final join's member: (count, sums_build [Vb],
        sums_probe [Vp]).  The mesh operator engine overrides it with the
        hash-shuffle join (parallel/dist_engine.py)."""
        return self._ops.fused_join_auto(keys_b, vals_b, n_b, keys_p, vals_p,
                                         n_p, **kw)
