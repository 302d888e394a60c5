"""Selectivity propagation over per-query column-statistics snapshots.

Host-side scalar math mirroring the reference's estimator (stats.c:88-259):
each bound column carries {l=min, u=max, f=rows, d=distinct}; every executed
or hypothesized predicate updates the touched columns and rescales the
remaining columns of the touched relations via the classic
d' = d * (1 - (1 - f'/f)^(f_c/d_c)) distinct-value survival formula.

The reference stores l/u/f/d as uint64 and mixes in double arithmetic with
silent truncation on assignment; this implementation mirrors the integer
truncation so cost comparisons come out the same way.  Stats are estimates
only — they steer join ordering, never correctness.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..frontend.parser import FilterPred, JoinPred, Predicate, Query
from ..storage.catalog import Catalog, ColumnStats

_MASK64 = (1 << 64) - 1

# Equi-join estimator: "dbound" (default) refines the reference's
# value-span formula with the System-R distinct-count bound
# f1*f2/max(d1, d2); "ref" reproduces the reference math exactly
# (used by the JoinEnum plan-parity test).  The span formula breaks
# after an equality filter — the range collapses to one value, span=1,
# and EVERY candidate join estimates f1*f2, so the DP cannot see that
# chaining from the filtered relation keeps intermediates tiny
# (observed on workloads/scaled: a 4-relation chain planned backwards,
# 20M-row intermediates instead of ~100, 5 s/query instead of 65 ms).
import os as _os

ESTIMATOR = _os.environ.get("S18_ESTIMATOR", "dbound")


def _survival(d: int, f_ratio: float, fc: int, dc: int) -> int:
    """d * (1 - (1 - f_ratio)^(fc/dc)), truncated (stats.c:160-166)."""
    if d == 0 or dc == 0:
        return d
    base = 1.0 - f_ratio
    if base < 0.0:
        base = 0.0
    try:
        val = d * (1.0 - base ** (fc / dc))
    except (OverflowError, ZeroDivisionError):
        return d
    return int(val) if val == val else d  # NaN-safe


class QueryStats:
    """Per-query snapshot: (binding, column) -> ColumnStats."""

    def __init__(self, query: Query, catalog: Catalog):
        self.query = query
        self.cols: Dict[Tuple[int, int], ColumnStats] = {}
        for b, rid in enumerate(query.relations):
            for c in range(catalog.relation(rid).num_columns):
                self.cols[(b, c)] = catalog.column_stats(rid, c).copy()

    def copy(self) -> "QueryStats":
        new = QueryStats.__new__(QueryStats)
        new.query = self.query
        new.cols = {k: v.copy() for k, v in self.cols.items()}
        return new

    def get(self, binding: int, column: int) -> ColumnStats:
        return self.cols[(binding, column)]

    def _rest_columns(self, binding: int, skip_column: int, f_new: int,
                      f_ratio: float) -> None:
        for (b, c), st in self.cols.items():
            if b != binding or c == skip_column:
                continue
            if st.d != 0:
                st.d = _survival(st.d, f_ratio, st.f, st.d)
            st.f = f_new
            st.fmax = max(1, min(st.fmax, f_new))

    def apply(self, pred: Predicate) -> None:
        """Update estimates for one predicate (reference: ValuePredicate)."""
        if isinstance(pred, FilterPred):
            self._apply_filter(pred)
        elif pred.is_self_join:
            self._apply_self_join(pred)
        else:
            self._apply_join(pred)

    def _apply_filter(self, pred: FilterPred) -> None:
        st = self.get(pred.binding, pred.column)
        prev_f, prev_d = st.f, st.d
        v = pred.value & _MASK64
        if pred.op == "=":
            if st.l <= v <= st.u:
                st.d = 1
                st.f = st.f // prev_d if prev_d != 0 else 0
            else:
                st.d = 0
                st.f = 0
            st.l = st.u = v
        else:
            if pred.op == "<":
                k1, k2 = st.l, min(v, st.u)
            else:
                k1, k2 = max(v, st.l), st.u
            if st.u == st.l:
                st.d = 0
            else:
                frac = (k2 - k1) / (st.u - st.l)
                st.d = int(frac * st.d)
                st.f = int(frac * st.f)
            st.l, st.u = k1, k2
        st.fmax = max(1, min(st.fmax, st.f))
        ratio = (st.f / prev_f) if prev_f else 0.0
        self._rest_columns(pred.binding, pred.column, st.f, ratio)

    def _apply_self_join(self, pred: JoinPred) -> None:
        st1 = self.get(pred.binding1, pred.column1)
        st2 = self.get(pred.binding2, pred.column2)
        prev_f = st1.f
        span = ((st1.u - st1.l) & _MASK64) + 1
        f_new = st1.f // span
        ratio = (f_new / prev_f) if prev_f else 0.0
        d_new = _survival(st1.d, ratio, prev_f, st1.d) if st1.d else 0
        st1.f = st2.f = f_new
        st1.d = st2.d = d_new
        st1.fmax = max(1, min(st1.fmax, f_new))
        st2.fmax = max(1, min(st2.fmax, f_new))
        if st1.l >= st2.l:
            st2.l = st1.l
        else:
            st1.l = st2.l
        self._rest_columns(pred.binding1, pred.column1, f_new, ratio)
        self._rest_columns(pred.binding2, pred.column2, f_new, ratio)

    def _apply_join(self, pred: JoinPred) -> None:
        st1 = self.get(pred.binding1, pred.column1)
        st2 = self.get(pred.binding2, pred.column2)
        prev_d1, prev_d2 = st1.d, st2.d
        l = max(st1.l, st2.l)
        u = min(st1.u, st2.u)
        st1.l = st2.l = l
        st1.u = st2.u = u
        span = ((u - l) & _MASK64) + 1
        f_new = int((st1.f * st2.f) / span)
        if ESTIMATOR == "dbound":
            # System-R distinct bound: each of the max(d1, d2) join-key
            # groups matches at most f1/d1 * f2/d2 pairs in expectation,
            # and only min(d1, d2) groups can match at all.  Strictly
            # tighter than the span formula whenever a filter collapsed
            # one side's range (span=1 -> f1*f2); identical on uniform
            # unfiltered columns where d ~ span.
            dmax = max(st1.d, st2.d)
            if dmax:
                f_new = min(f_new, int((st1.f * st2.f) / dmax))
        # 1-bucket MCV correction (not in the reference): when both sides
        # share the same most-common value and it survives the range
        # intersection, that single key alone contributes fmax1*fmax2
        # output rows — the span formula assumes uniformity and misses
        # Zipf hot keys by orders of magnitude, which made the DP pick
        # plans with 100M+-row intermediates.
        hot = 0
        if st1.mode == st2.mode and l <= st1.mode <= u:
            hot = st1.fmax * st2.fmax
        f_new = max(f_new, hot)
        d_new = int((st1.d * st2.d) / span)
        if ESTIMATOR == "dbound":
            # the joined key column's distinct count cannot exceed
            # either side's (the span formula yields d1*d2 at span=1)
            d_new = min(d_new, st1.d, st2.d)
        st1.f = st2.f = f_new
        st1.d = st2.d = d_new
        fmax_new = max(1, min(f_new, st1.fmax * st2.fmax))
        st1.fmax = st2.fmax = fmax_new
        r1 = (d_new / prev_d1) if prev_d1 else 0.0
        r2 = (d_new / prev_d2) if prev_d2 else 0.0
        self._rest_columns(pred.binding1, pred.column1, f_new, r1)
        self._rest_columns(pred.binding2, pred.column2, f_new, r2)

    def estimate_after(self, pred: JoinPred) -> int:
        """Apply `pred` and return the estimated intermediate cardinality
        (reference: CostTree = f of the joined column post-update)."""
        self.apply(pred)
        return self.get(pred.binding1, pred.column1).f
