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

Empty results: every operator preserves emptiness, so final count == 0
iff some operator went empty iff a NULL line (the contest's rule).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import ops
from ..config import DEFAULT_CONFIG, EngineConfig
from ..frontend.parser import FilterPred, JoinPred, Query
from ..ops.u64 import MASK64
from ..planner import plan_joins
from ..storage.catalog import Catalog
from ..utils.padding import pad_to, size_class

Count = Union[int, torch.Tensor]  # host int or device 0-d integer tensor


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
    (int64 bit patterns of u64).  `line()` fetches and formats."""

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


# Technical ceiling on any materialized intermediate, independent of the
# configurable max_intermediate guard.
HARD_INTERMEDIATE_CAP = 1 << 27


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

    def __init__(self, catalog: Catalog,
                 config: EngineConfig = DEFAULT_CONFIG):
        self.catalog = catalog
        self.config = config
        self.device = config.device()
        self._columns: Dict[Tuple[int, int], Tuple[torch.Tensor, int]] = {}
        self._sorted_columns: Dict[Tuple[int, int], tuple] = {}
        self._key_tables: Dict[Tuple[int, int], Optional[torch.Tensor]] = {}
        self._prefix_tables: Dict[Tuple[int, int, int], torch.Tensor] = {}

    # ---- storage ---------------------------------------------------------

    def device_column(self, rid: int, cid: int) -> Tuple[torch.Tensor, int]:
        """Base column as a padded device tensor (u64 bits in int64, pads
        0) + live length."""
        key = (rid, cid)
        hit = self._columns.get(key)
        if hit is not None:
            return hit
        col = np.array(self.catalog.column(rid, cid), dtype=np.uint64)
        n = col.shape[0]
        host = pad_to(col, size_class(n))
        dev = torch.from_numpy(host.view(np.int64)).to(self.device)
        self._columns[key] = (dev, n)
        return dev, n

    def device_sorted_column(self, rid: int, cid: int):
        """Prep-time sort of a base column: (sorted_keys, perm) as
        ops.join_build makes them.  The contest's prep window is untimed,
        so a join whose build side is an unfiltered base column skips its
        query-time sort."""
        key = (rid, cid)
        hit = self._sorted_columns.get(key)
        if hit is None:
            dev, n = self.device_column(rid, cid)
            hit = ops.join_build(dev, n)
            self._sorted_columns[key] = hit
        return hit

    def device_key_table(self, rid: int, cid: int):
        """Domain rank table of a base column, or None when gated off:
        cumcnt[k] = #rows with key < k, k in [0, u+2], u = the column's
        exact max (catalog stats) — u+3 int32 entries, so the table's
        length encodes u.  A probe row's match range in the prep-sorted
        column is then two gathers.  Built host-side at prep."""
        key = (rid, cid)
        if key in self._key_tables:
            return self._key_tables[key]
        tbl = None
        stats = self.catalog.stats
        if stats and self.config.key_table_max:
            u = int(stats[rid][cid].u)
            if u + 3 <= self.config.key_table_max:
                col = np.asarray(self.catalog.column(rid, cid),
                                 dtype=np.uint64)
                cumcnt = np.zeros(u + 3, dtype=np.int32)
                cumcnt[1:u + 2] = np.cumsum(
                    np.bincount(col.astype(np.int64), minlength=u + 1))
                cumcnt[u + 2] = cumcnt[u + 1]
                tbl = torch.from_numpy(cumcnt).to(self.device)
        self._key_tables[key] = tbl
        return tbl

    def device_prefix_table(self, rid: int, key_cid: int, val_cid: int):
        """Prep-time prefix sums of a value column in the key-sorted
        order of `key_cid` ([P+1], ops.prefix_by_perm).  With a key table
        it makes a small fused join probe-only."""
        key = (rid, key_cid, val_cid)
        hit = self._prefix_tables.get(key)
        if hit is None:
            _, perm = self.device_sorted_column(rid, key_cid)
            col, n = self.device_column(rid, val_cid)
            hit = ops.prefix_by_perm(col, perm, n)
            self._prefix_tables[key] = hit
        return hit

    def prefetch(self) -> None:
        """Copy every base column to the device, presort it, build its
        key table and the prefix tables of every (key-table column, value
        column) pair, ahead of the timed phase.  Columns run in threads:
        the copies, sorts and NumPy passes release the interpreter lock
        (a racing duplicate build is benign: equal values)."""
        def one_column(rid: int, cid: int, ncols: int) -> None:
            self.device_sorted_column(rid, cid)
            if self.device_key_table(rid, cid) is not None:
                for vcid in range(ncols):
                    self.device_prefix_table(rid, cid, vcid)

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

    def execute_async(self, query: Query) -> Result:
        try:
            return self._execute(query, use_planner=True, guard=True)
        except IntermediateBlowup:
            # The planner's order exploded past max_intermediate (skew the
            # estimator missed): the text order is the safety net, bounded
            # by the technical cap.
            return self._execute(query, use_planner=False, guard=False)

    def _execute(self, query: Query, use_planner: bool = True,
                 guard: bool = True) -> Result:
        components: List[Component] = []

        def find(binding: int) -> Optional[Component]:
            for c in components:
                if binding in c.bindings:
                    return c
            return None

        def col_of(binding: int, column: int) -> Tuple[torch.Tensor, int]:
            return self.device_column(query.relations[binding], column)

        # ---- phase 1: filters and self-joins (no host syncs) -------------
        for pred in query.filters_and_selfjoins:
            if isinstance(pred, FilterPred):
                self._exec_filter(components, find, col_of, pred)
            else:
                self._exec_selfjoin(components, find, col_of, pred)

        # ---- phase 2: joins ----------------------------------------------
        joins = query.joins
        if use_planner and len(joins) > 1:
            joins = plan_joins(query, self.catalog)

        view_bindings = {b for b, _ in query.views}
        for idx, jp in enumerate(joins):
            comp_l = find(jp.binding1)
            comp_r = find(jp.binding2)

            if comp_l is not None and comp_l is comp_r:
                # Both sides live in one component: value-equality selection.
                c1dev, _ = col_of(jp.binding1, jp.column1)
                c2dev, _ = col_of(jp.binding2, jp.column2)
                v1 = ops.gather_u64(c1dev, comp_l.row(jp.binding1))
                v2 = ops.gather_u64(c2dev, comp_l.row(jp.binding2))
                self._compact(components, comp_l,
                              ops.equal_mask(v1, v2, comp_l.count))
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

            comp = self._exec_join(components, comp_l, comp_r, col_of, jp,
                                   query, guard=guard)
            if comp.count == 0:  # host int: the sized emit observed zero
                return NullResult(len(query.views))

        # ---- phase 3: cartesian of leftovers ------------------------------
        for b in view_bindings:
            if find(b) is None:
                n = self.catalog.relation(query.relations[b]).num_tuples
                if n == 0:
                    return NullResult(len(query.views))
                P = size_class(n)
                ident = torch.arange(P, dtype=torch.int32,
                                     device=self.device)[None, :]
                components.append(Component((b,), ident, n))
        while len(components) > 1:
            c1, c2 = components[0], components[1]
            total = self._host_count(c1) * self._host_count(c2)
            if total == 0:
                return NullResult(len(query.views))
            P = size_class(total)
            i1, i2 = ops.cartesian_indices(c1.count, c2.count, P,
                                           self.device)
            table = torch.cat([ops.take_cols(c1.table, i1),
                               ops.take_cols(c2.table, i2)], 0)
            components = ([Component(c1.bindings + c2.bindings, table,
                                     total)] + components[2:])

        if not components:
            return NullResult(len(query.views))

        # ---- phase 4: checksums (single packed fetch) ---------------------
        comp = components[0]
        parts = [_as_i64(comp.count, self.device)]
        for b, c in query.views:
            coldev, _ = col_of(b, c)
            parts.append(ops.checksum(coldev, comp.row(b),
                                      comp.count).reshape(1))
        return PendingResult(torch.cat(parts), len(query.views))

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
            mask = ops.compare_mask(coldev, n_base, pred.op, pred.value)
            pos, cnt = ops.mask_positions(mask, out_size=coldev.shape[0])
            components.append(Component((pred.binding,), pos[None, :], cnt))
            return
        vals = ops.gather_u64(coldev, comp.row(pred.binding))
        self._compact(components, comp,
                      ops.compare_mask(vals, comp.count, pred.op,
                                       pred.value))

    def _exec_selfjoin(self, components, find, col_of,
                       pred: JoinPred) -> None:
        c1dev, n_base = col_of(pred.binding1, pred.column1)
        c2dev, _ = col_of(pred.binding1, pred.column2)
        comp = find(pred.binding1)
        if comp is None:
            mask = ops.equal_mask(c1dev, c2dev, n_base)
            pos, cnt = ops.mask_positions(mask, out_size=c1dev.shape[0])
            components.append(Component((pred.binding1,), pos[None, :], cnt))
            return
        rids = comp.row(pred.binding1)
        mask = ops.equal_mask(ops.gather_u64(c1dev, rids),
                              ops.gather_u64(c2dev, rids), comp.count)
        self._compact(components, comp, mask)

    @staticmethod
    def _compact(components, comp: Component, mask: torch.Tensor) -> None:
        pos, cnt = ops.mask_positions(mask, out_size=comp.table.shape[1])
        new = Component(comp.bindings, ops.take_cols(comp.table, pos), cnt)
        components[:] = [c if c is not comp else new for c in components]

    def _join_keys(self, col_of, comp: Optional[Component], binding: int,
                   column: int) -> Tuple[torch.Tensor, Count]:
        coldev, n_base = col_of(binding, column)
        if comp is None:
            return coldev, n_base
        return ops.gather_u64(coldev, comp.row(binding)), comp.count

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

    def _exec_join(self, components, comp_l, comp_r, col_of,
                   jp: JoinPred, query: Query,
                   guard: bool = True) -> Component:
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
            lo, cnt, ccum, total_dev = ops.join_probe_count_table(
                tbl_b, keys_p, n_p)
        else:
            if comp_b is None:
                # Unfiltered base build side: prep-time sort.
                sorted_keys, perm = self.device_sorted_column(
                    query.relations[b], c)
            else:
                sorted_keys, perm = ops.join_build(keys_b, n_b)
            lo, cnt, ccum, total_dev = ops.join_probe_count_auto(
                sorted_keys, n_b, keys_p, n_p)
        total = int(total_dev)  # the one required sync: sizes the emit
        if (guard and 0 < self.config.max_intermediate < total) or (
                total > HARD_INTERMEDIATE_CAP):
            raise IntermediateBlowup(total)
        if total == 0:
            return Component((jp.binding1, jp.binding2),
                             torch.zeros((2, size_class(0)),
                                         dtype=torch.int32,
                                         device=self.device), 0)
        P = size_class(total)
        bpos, ppos = ops.join_emit(perm, lo, ccum, total, out_size=P)
        pos_l, pos_r = (bpos, ppos) if build_left else (ppos, bpos)

        rows: List[torch.Tensor] = []
        bindings: List[int] = []
        for comp, binding, pos in ((comp_l, jp.binding1, pos_l),
                                   (comp_r, jp.binding2, pos_r)):
            if comp is not None:
                rows.append(ops.take_cols(comp.table, pos))
                bindings.extend(comp.bindings)
                components[:] = [x for x in components if x is not comp]
            else:
                rows.append(pos[None, :])
                bindings.append(binding)
        new = Component(tuple(bindings), torch.cat(rows, 0), total)
        components.append(new)
        return new

    def _exec_join_fused(self, query: Query, col_of, comp_l, comp_r,
                         jp: JoinPred) -> PendingResult:
        """Last join + checksums (ops.fused_join_auto): the final
        intermediate is never materialized and needs no sync.  Only the
        real projection columns of each side enter the member; the packed
        vector is assembled per view."""
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
        if comp_b is None:
            presorted = self.device_sorted_column(query.relations[bb], bc)
            if tbl_b is not None:
                table = (tbl_b, presorted[1])
        if comp_p is None:
            # the staircase member consumes BOTH sides' prep sorts
            presorted_p = self.device_sorted_column(query.relations[pb], pc)

        Pb, Pp = keys_b.shape[0], keys_p.shape[0]
        use_ms = ops.ms_member_selected(Pb, Pp, self.config.join_algo)
        prefs_mode = table is not None and not use_ms

        brows, prows, prefs = [], [], []
        b_idx, p_idx = {}, {}
        for vi, (b, c) in enumerate(query.views):
            coldev, _ = col_of(b, c)
            comp = comp_l if side_of(b) else comp_r
            vals = (coldev if comp is None
                    else ops.gather_u64(coldev, comp.row(b)))
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

        count, sums_b, sums_p = ops.fused_join_auto(
            keys_b, None if prefs_mode else stack(brows, Pb), n_b,
            keys_p, stack(prows, Pp), n_p,
            algo=self.config.join_algo, presorted=presorted, table=table,
            table_prefs=stack(prefs, Pb + 1) if prefs_mode else None,
            presorted_p=presorted_p)
        parts = [count.reshape(1)]
        for vi in range(len(query.views)):
            s = sums_b[b_idx[vi]] if vi in b_idx else sums_p[p_idx[vi]]
            parts.append(s.reshape(1))
        return PendingResult(torch.cat(parts), len(query.views))
