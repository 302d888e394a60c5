"""Factorized (message-passing) aggregate execution for acyclic joins.

Counterpart of `sigmod2018_tpu/engine/factorized.py`.

Why this exists: every other execution path of this engine — like the
reference C engine (inter_res.c row-id materialization, query.c:408-461)
— materializes each intermediate join's row-id table, so a query whose
intermediate cardinality explodes (Zipf heavy hitters: the last query of
workloads/zipfbig reaches ~5.5e11 rows in text order) cannot be answered
by ANY join order.  But the contest output is only COUNT + per-view SUM
checksums, and for an acyclic join graph those are computable without
materializing anything: Yannakakis message passing over the join forest
with (count, sum) annotations — one bottom-up and one top-down sweep of
sort / searchsorted / prefix-sum work, O(N log N) total, independent of
the join's output cardinality.

Math: for binding b let M_b(r) = number of full result tuples whose
b-component is base row r, computed mod 2^64 (wrap-around).  Then

    checksum(b.c) = sum_r M_b(r) * col(b,c)[r]        (mod 2^64)

and the result is NULL iff no full tuple exists.  M_b = up_b * down_b:
`up` aggregates each subtree bottom-up (leaf = the binding's
filter/liveness mask), `down` pushes the rest of the tree back down
with per-child sibling-exclusive products.  Wrapped counts can hit 0
mod 2^64 on astronomically large results, so emptiness rides a
parallel boolean semiring (`exists` flags, exact), never the wrapped
counts.  Disconnected components multiply: each component's total
count scales every other component's checksums (the cartesian phase of
engine/oracle.py, reference inter_res.c:391-428).

Applicability: the join multigraph (after filters/self-joins fold into
per-binding masks) must be a forest — no duplicate binding pairs, no
cycles.  `plan_forest` returns None otherwise and callers fall back to
the materializing engine.

Two twin implementations share `plan_forest`:
  * `execute_query_factorized_np` — NumPy, the independent oracle for
    blowup queries (differential tests);
  * `factorized_result` — plain PyTorch ops on the engine's padded
    device columns (u64 bits in int64, ops/u64.py), returning a
    PendingResult for the engine's retry chain, with no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..frontend.parser import FilterPred, Query
from ..ops.select import compare_mask, equal_mask, live_mask
from ..ops.u64 import MASK64, ranks_u64


# ---------------------------------------------------------------------------
# Shared host-side plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Edge:
    parent: int
    child: int
    pcol: int  # join column on the parent binding
    ccol: int  # join column on the child binding


@dataclasses.dataclass(frozen=True)
class ForestPlan:
    nodes: Tuple[int, ...]           # all participating bindings
    comps: Tuple[Tuple[int, ...], ...]  # bindings per connected component
    roots: Tuple[int, ...]           # one root per component
    # BFS-ordered edges per component (parents precede children)
    edges: Tuple[Tuple[_Edge, ...], ...]


def plan_forest(query: Query) -> Optional[ForestPlan]:
    """The join forest, or None when the join multigraph has a duplicate
    binding pair or a cycle (the materializing engine handles those)."""
    joins = query.joins
    nodes = set(b for b, _ in query.views)
    for p in query.filters_and_selfjoins:
        nodes.add(p.binding if isinstance(p, FilterPred) else p.binding1)
    adj: Dict[int, List[Tuple[int, int, int]]] = {}
    seen_pairs = set()
    parent_uf: Dict[int, int] = {}

    def find(x: int) -> int:
        while parent_uf.setdefault(x, x) != x:
            parent_uf[x] = parent_uf[parent_uf[x]]
            x = parent_uf[x]
        return x

    for jp in joins:
        if jp.binding1 == jp.binding2:  # defensive: parser routes these
            return None                 # to filters_and_selfjoins
        pair = jp.pair()
        if pair in seen_pairs:
            return None  # multi-edge (compound key): not a tree edge
        seen_pairs.add(pair)
        r1, r2 = find(jp.binding1), find(jp.binding2)
        if r1 == r2:
            return None  # cycle
        parent_uf[r1] = r2
        nodes.add(jp.binding1)
        nodes.add(jp.binding2)
        adj.setdefault(jp.binding1, []).append(
            (jp.binding2, jp.column1, jp.column2))
        adj.setdefault(jp.binding2, []).append(
            (jp.binding1, jp.column2, jp.column1))

    # Root each component at a VIEW binding when one exists: the down
    # sweep then only needs edges on root->view paths (down_edges
    # below), and a single-view component needs NO down messages at
    # all.  Each message is a gather, two prefix sums and four prefix
    # gathers of the padded column length, the dominant cost of the
    # at-scale factorized path.
    view_b = {b for b, _ in query.views}
    comp_sets: List[set] = []
    seen = set()
    for start in sorted(nodes):
        if start in seen:
            continue
        comp, frontier = {start}, [start]
        seen.add(start)
        while frontier:
            u = frontier.pop()
            for v, _, _ in adj.get(u, ()):
                if v not in seen:
                    seen.add(v)
                    comp.add(v)
                    frontier.append(v)
        comp_sets.append(comp)

    comps: List[Tuple[int, ...]] = []
    roots: List[int] = []
    all_edges: List[Tuple[_Edge, ...]] = []
    for comp_set in comp_sets:
        vb = sorted(comp_set & view_b)
        start = vb[0] if vb else min(comp_set)
        comp, edges, frontier = [start], [], [start]
        visited = {start}
        while frontier:
            u = frontier.pop()
            for v, ucol, vcol in adj.get(u, ()):
                if v in visited:
                    continue
                visited.add(v)
                comp.append(v)
                edges.append(_Edge(parent=u, child=v, pcol=ucol, ccol=vcol))
                frontier.append(v)
        comps.append(tuple(comp))
        roots.append(start)
        all_edges.append(tuple(edges))
    return ForestPlan(nodes=tuple(sorted(nodes)), comps=tuple(comps),
                      roots=tuple(roots), edges=tuple(all_edges))


def down_edges(plan: ForestPlan, query: Query) -> set:
    """The edges whose DOWN message is actually consumed: those on some
    root->view-binding path (down_w is only read at view bindings; up
    messages always run).  Everything else's down message is skipped."""
    parent_of: Dict[int, _Edge] = {}
    for edges in plan.edges:
        for e in edges:
            parent_of[e.child] = e
    needed: set = set()
    for b, _ in query.views:
        e = parent_of.get(b)
        while e is not None and e not in needed:
            needed.add(e)
            e = parent_of.get(e.parent)
    return needed


# ---------------------------------------------------------------------------
# NumPy twin — the independent oracle for blowup queries
# ---------------------------------------------------------------------------


def _np_msg_cached(sw: np.ndarray, se: np.ndarray, order: np.ndarray,
                   lo: np.ndarray, hi: np.ndarray):
    """Per-receiver-row (sum of sender weights, any sender exists) over
    key equality: group-by via sort + prefix sums, no materialization.
    The edge's query-independent artifacts (sender sort order, receiver
    rank ranges) are precomputed by _np_edge_ranks — the NumPy mirror
    of the device twin's edge_ranks cache — so per message only the
    weight gather + two cumsums + four prefix gathers remain."""
    pw = np.concatenate([[np.uint64(0)],
                         np.cumsum(sw[order], dtype=np.uint64)])
    pe = np.concatenate([[0], np.cumsum(se[order].astype(np.int64))])
    return pw[hi] - pw[lo], (pe[hi] - pe[lo]) > 0


def _np_edge_ranks(catalog, srel: int, scol: int, rrel: int, rcol: int,
                   skey: np.ndarray, rkey: np.ndarray):
    """(order, lo, hi) for a (sender column, receiver column) pair —
    query-independent (base columns are immutable), cached on the
    catalog.  The sender argsort and the two rank queries are the
    dominant cost of the host twin when re-run per message per query."""
    cache = catalog.__dict__.setdefault("_np_edge_ranks", {})
    key = (srel, scol, rrel, rcol)
    hit = cache.get(key)
    if hit is None:
        # two-level: the sender column's sort is shared across every
        # edge it participates in (queries join the same key columns
        # against different receivers)
        scache = catalog.__dict__.setdefault("_np_col_sort", {})
        sk = scache.get((srel, scol))
        if sk is None:
            order = np.argsort(skey, kind="stable")
            sk = (order, skey[order])
            scache[(srel, scol)] = sk
        order, ks = sk
        lo = np.searchsorted(ks, rkey, side="left")
        hi = np.searchsorted(ks, rkey, side="right")
        hit = (order, lo, hi)
        cache[key] = hit
    return hit


def execute_query_factorized_np(query: Query, catalog) -> Optional[str]:
    """Exact result line via NumPy message passing, or None when the
    query is not a forest.  Differentially equal to
    oracle.execute_query_numpy wherever the latter can materialize."""
    plan = plan_forest(query)
    if plan is None:
        return None

    def col(b: int, c: int) -> np.ndarray:
        return np.asarray(catalog.dense_column(query.relations[b], c),
                          dtype=np.uint64)

    # Per-binding masks: filters + self-joins (oracle phase 1).
    mask: Dict[int, np.ndarray] = {}
    for b in plan.nodes:
        n = catalog.relation(query.relations[b]).num_tuples
        mask[b] = np.ones(n, dtype=bool)
    for p in query.filters_and_selfjoins:
        if isinstance(p, FilterPred):
            vals = col(p.binding, p.column)
            v = np.uint64(p.value & MASK64)
            m = (vals < v if p.op == "<"
                 else vals > v if p.op == ">" else vals == v)
            mask[p.binding] &= m
        else:
            mask[p.binding1] &= (col(p.binding1, p.column1)
                                 == col(p.binding1, p.column2))

    if not all(mask[b].any() for b in plan.nodes):
        return " ".join("NULL" for _ in query.views)

    up_w = {b: mask[b].astype(np.uint64) for b in plan.nodes}
    up_e = {b: mask[b].copy() for b in plan.nodes}
    msg_w: Dict[_Edge, np.ndarray] = {}
    msg_e: Dict[_Edge, np.ndarray] = {}
    down_w: Dict[int, np.ndarray] = {}
    down_e: Dict[int, np.ndarray] = {}

    def edge(sb, sc, rb, rc):
        return _np_edge_ranks(catalog, query.relations[sb], sc,
                              query.relations[rb], rc,
                              col(sb, sc), col(rb, rc))

    need_down = down_edges(plan, query)
    for comp, root, edges in zip(plan.comps, plan.roots, plan.edges):
        for e in reversed(edges):  # children complete before parents
            mw, me = _np_msg_cached(up_w[e.child], up_e[e.child],
                                    *edge(e.child, e.ccol,
                                          e.parent, e.pcol))
            msg_w[e], msg_e[e] = mw, me
            up_w[e.parent] = up_w[e.parent] * mw
            up_e[e.parent] &= me
        down_w[root] = np.ones_like(up_w[root])
        down_e[root] = np.ones_like(up_e[root])
        for e in edges:  # parents complete before children
            if e not in need_down:  # down_w never read below this edge
                continue
            excl_w = down_w[e.parent] * mask[e.parent].astype(np.uint64)
            excl_e = down_e[e.parent] & mask[e.parent]
            for sib in edges:
                if sib.parent == e.parent and sib is not e:
                    excl_w = excl_w * msg_w[sib]
                    excl_e &= msg_e[sib]
            dmw, dme = _np_msg_cached(excl_w, excl_e,
                                      *edge(e.parent, e.pcol,
                                            e.child, e.ccol))
            down_w[e.child], down_e[e.child] = dmw, dme

    cnt_w = [np.add.reduce(up_w[r], dtype=np.uint64) for r in plan.roots]
    exists = all(bool(up_e[r].any()) for r in plan.roots)
    if not exists:
        return " ".join("NULL" for _ in query.views)

    comp_of = {b: i for i, comp in enumerate(plan.comps) for b in comp}
    sums = []
    for b, c in query.views:
        m = up_w[b] * down_w[b]
        s = np.add.reduce(m * col(b, c), dtype=np.uint64)
        for i, cw in enumerate(cnt_w):
            if i != comp_of[b]:
                s = s * cw
        sums.append(str(int(s) & MASK64))
    return " ".join(sums)


# ---------------------------------------------------------------------------
# Device executor on the engine's padded columns
# ---------------------------------------------------------------------------


def message(sw: torch.Tensor, se: torch.Tensor, perm: torch.Tensor,
            lo: torch.Tensor, hi: torch.Tensor):
    """[Ps] sender weights (wrap-around u64 in int64) and exists flags
    (bool) + the edge's cached artifacts -> ([Pr] int64 sum of the
    weights of the sender rows with the receiver row's key, [Pr] bool
    any such sender exists).

    The expensive parts of a message — the sender key sort and the
    receiver rank queries — depend only on the two BASE key columns,
    never on the query: `perm` is the sender column's prep-time sort
    permutation and [lo, hi) each receiver row's match range in that
    order (edge_ranks).  What remains per message is one gather of the
    weights into key order, two prefix sums and four prefix gathers.

    Dead and padded sender rows carry weight 0 and exists False
    (liveness is folded into the masks), so no live lengths are needed:
    a receiver key 2^64-1, whose range runs on over the sender's pads,
    adds only zeros."""
    zero = sw.new_zeros(1)
    pw = torch.cat([zero, torch.cumsum(sw.index_select(0, perm), 0)])
    pe = torch.cat([zero.to(torch.int32),
                    torch.cumsum(se.index_select(0, perm), 0,
                                 dtype=torch.int32)])
    return (pw.index_select(0, hi) - pw.index_select(0, lo),
            pe.index_select(0, hi) > pe.index_select(0, lo))


def edge_ranks(engine, srel: int, scol: int, rrel: int, rcol: int):
    """The query-independent artifacts (perm, lo, hi) of the edge that
    sends from base column (srel, scol) to base column (rrel, rcol),
    cached on the engine.  The key holds BOTH ends: a query that joins
    one relation several times uses the same column as sender of one
    edge and receiver of another.  perm is the sender's prep-time sort
    permutation (TorchEngine.device_sorted_column); lo / hi are int32
    ranks of every receiver row's key in the sorted sender keys, in
    unsigned order.  The sender's pads (2^64-1) sort after its live
    rows and the receiver's pads (0) rank like a live 0: neither
    matters, since pad rows carry weight 0 on both sides.  Queries of a
    batch dispatch from several threads; each edge is built once
    (TorchEngine._once)."""
    def build():
        sorted_keys, perm = engine.device_sorted_column(srel, scol)
        rkeys, _ = engine.device_column(rrel, rcol)
        return (perm,
                ranks_u64(sorted_keys, rkeys, "left").to(torch.int32),
                ranks_u64(sorted_keys, rkeys, "right").to(torch.int32))

    return engine._once(engine._edge_ranks, (srel, scol, rrel, rcol), build)


def factorized_result(engine, query: Query):
    """Execute `query` on `engine`'s device columns via message passing.
    Returns a PendingResult ([exists, sums...] packed vector — the
    count slot only gates NULL formatting, so it carries the exact
    boolean, immune to mod-2^64 wrap), or None when not a forest.

    No host sync: an empty mask anywhere still answers correctly,
    because the packed vector's exact `exists` flag (the boolean
    semiring below) gates NULL at format time
    (PendingResult.line_from)."""
    plan = plan_forest(query)
    if plan is None:
        return None
    from .executor import PendingResult

    def col(b: int, c: int):
        return engine.device_column(query.relations[b], c)

    def ranks(sb: int, sc: int, rb: int, rc: int):
        return edge_ranks(engine, query.relations[sb], sc,
                          query.relations[rb], rc)

    mask: Dict[int, torch.Tensor] = {}
    for b in plan.nodes:
        dev, n = col(b, 0)
        mask[b] = live_mask(dev.shape[0], n, dev.device)
    for p in query.filters_and_selfjoins:
        if isinstance(p, FilterPred):
            dev, n = col(p.binding, p.column)
            mask[p.binding] = mask[p.binding] & compare_mask(dev, n, p.op,
                                                             p.value)
        else:
            d1, n = col(p.binding1, p.column1)
            d2, _ = col(p.binding1, p.column2)
            mask[p.binding1] = mask[p.binding1] & equal_mask(d1, d2, n)

    # Weights are wrap-around u64 carried in int64: cumsum, mul and sum
    # wrap mod 2^64 on the CPU and on the card alike.
    up_w = {b: mask[b].to(torch.int64) for b in plan.nodes}
    up_e = dict(mask)
    msg_w: Dict[_Edge, torch.Tensor] = {}
    msg_e: Dict[_Edge, torch.Tensor] = {}
    down_w: Dict[int, torch.Tensor] = {}
    down_e: Dict[int, torch.Tensor] = {}

    need_down = down_edges(plan, query)
    for comp, root, edges in zip(plan.comps, plan.roots, plan.edges):
        for e in reversed(edges):  # children complete before parents
            mw, me = message(up_w[e.child], up_e[e.child],
                             *ranks(e.child, e.ccol, e.parent, e.pcol))
            msg_w[e], msg_e[e] = mw, me
            up_w[e.parent] = up_w[e.parent] * mw
            up_e[e.parent] = up_e[e.parent] & me
        down_w[root] = torch.ones_like(up_w[root])
        down_e[root] = torch.ones_like(up_e[root])
        for e in edges:  # parents complete before children
            if e not in need_down:  # down_w never read below this edge
                continue
            excl_w = down_w[e.parent] * mask[e.parent]
            excl_e = down_e[e.parent] & mask[e.parent]
            for sib in edges:
                if sib.parent == e.parent and sib is not e:
                    excl_w = excl_w * msg_w[sib]
                    excl_e = excl_e & msg_e[sib]
            dmw, dme = message(excl_w, excl_e,
                               *ranks(e.parent, e.pcol, e.child, e.ccol))
            down_w[e.child], down_e[e.child] = dmw, dme

    cnt_w = [up_w[r].sum() for r in plan.roots]
    exists = torch.stack([up_e[r].any() for r in plan.roots]).all()

    comp_of = {b: i for i, comp in enumerate(plan.comps) for b in comp}
    parts = [exists.to(torch.int64).reshape(1)]
    for b, c in query.views:
        s = (up_w[b] * down_w[b] * col(b, c)[0]).sum()
        for i, cw in enumerate(cnt_w):
            if i != comp_of[b]:
                s = s * cw
        parts.append(s.reshape(1))
    return PendingResult(torch.cat(parts), len(query.views))
