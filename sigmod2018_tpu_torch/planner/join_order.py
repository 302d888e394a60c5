"""DP join-order enumeration (left-deep trees over binding subsets).

Host-side restatement of the reference's JoinEnum (best_tree.c:105-223):

- state per subset S of join-graph bindings: the cheapest left-deep order
  reaching S, its propagated stats snapshot, and its accumulated cost,
- extension: S + one binding j connected to S by some join predicate
  (best_tree.c Connected); the *first* such predicate in query order is the
  tree edge, matching the reference,
- cost(S + j) = cost(S) + estimated cardinality after applying the edge
  (CostTree, best_tree.c:316-320); the edge completing the full set adds no
  cost (best_tree.c:137-138),
- predicates not used as tree edges (duplicate same-pair predicates and
  cycle-closing edges) are re-inserted at the earliest point where both of
  their bindings are active, where the executor runs them as value-equality
  selections.  The reference only re-inserts duplicate *pairs*
  (best_tree.c:174-219) and would drop a cycle-closing predicate; we keep
  every predicate — correctness over mimicry.

Fallbacks (disconnected join graph, bindings missing from the graph) keep
the original order, which is always correct.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Tuple

from ..frontend.parser import JoinPred, Query
from ..storage.catalog import Catalog
from .stats import QueryStats


def plan_joins(query: Query, catalog: Catalog,
               base_stats: Optional[QueryStats] = None) -> List[JoinPred]:
    joins = query.joins
    if len(joins) <= 1:
        return joins

    stats0 = base_stats.copy() if base_stats is not None else QueryStats(query, catalog)
    if base_stats is None:
        # Filters and self-joins have already run by the time joins are
        # ordered; fold their selectivities in (query.c:337-399 updates
        # query_stats during the filter phase).
        for pred in query.filters_and_selfjoins:
            stats0.apply(pred)

    bindings = sorted({b for j in joins for b in (j.binding1, j.binding2)})
    order = _enumerate(joins, bindings, stats0)
    if order is None:
        return joins
    return _reinsert_dropped(order, joins)


def estimate_cardinalities(query: Query, catalog: Catalog,
                           order: List[JoinPred]) -> List[int]:
    """Planner's estimated output cardinality per join of `order`
    (for --explain's est-vs-actual reporting)."""
    st = QueryStats(query, catalog)
    for pred in query.filters_and_selfjoins:
        st.apply(pred)
    return [st.estimate_after(jp) for jp in order]


def _enumerate(joins: List[JoinPred], bindings: List[int],
               stats0: QueryStats) -> Optional[List[JoinPred]]:
    # state: frozenset(bindings) -> (cost, order, stats)
    State = Tuple[int, List[JoinPred], QueryStats]
    best: Dict[FrozenSet[int], State] = {
        frozenset((b,)): (0, [], stats0) for b in bindings
    }
    full = frozenset(bindings)

    for size in range(1, len(bindings)):
        layer = [s for s in best if len(s) == size]
        for s in sorted(layer, key=lambda x: tuple(sorted(x))):
            cost_s, order_s, stats_s = best[s]
            for j in bindings:
                if j in s:
                    continue
                edge = _connecting_pred(joins, s, j)
                if edge is None:
                    continue
                s_new = s | {j}
                stats_new = stats_s.copy()
                est = stats_new.estimate_after(edge)
                cost_new = cost_s if s_new == full else cost_s + est
                cur = best.get(s_new)
                if cur is None or cur[0] > cost_new:
                    best[s_new] = (cost_new, order_s + [edge], stats_new)

    if full not in best:
        return None  # disconnected join graph — caller falls back
    return best[full][1]


def _connecting_pred(joins: List[JoinPred], s: FrozenSet[int],
                     j: int) -> Optional[JoinPred]:
    """First predicate (query order) linking binding j to the subset s."""
    for p in joins:
        if p.binding1 == j and p.binding2 in s:
            return p
        if p.binding2 == j and p.binding1 in s:
            return p
    return None


def _reinsert_dropped(order: List[JoinPred], all_joins: List[JoinPred]) -> List[JoinPred]:
    """Insert every predicate that is not a tree edge at the earliest point
    where both of its bindings are active."""
    used = list(order)
    dropped = [p for p in all_joins if not _contains(used, p)]
    if not dropped:
        return used
    result: List[JoinPred] = []
    active: set = set()
    pending = list(dropped)
    # Seed with the first edge's bindings as they activate.
    for edge in used:
        result.append(edge)
        active.update((edge.binding1, edge.binding2))
        still = []
        for p in pending:
            if p.binding1 in active and p.binding2 in active:
                result.append(p)
            else:
                still.append(p)
        pending = still
    result.extend(pending)  # defensive; should be empty
    return result


def _contains(preds: List[JoinPred], p: JoinPred) -> bool:
    return any(q is p for q in preds)
