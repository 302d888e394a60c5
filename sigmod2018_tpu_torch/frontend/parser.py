"""Query-text frontend: contest format -> typed IR.

Format (reference: query.c:15-313, submission/include/Parser.hpp:9-35):

    "RELATIONS|PREDICATES|SELECTIONS"
    e.g.  "0 2 4|0.1=1.1&1.0=2.2&0.1>3000|0.0 1.1"

- RELATIONS: space-separated relation ids.  Position in the list is the
  *binding*; the same relation id may appear twice with different bindings
  (Parser.cpp resolveRelationIds).
- PREDICATES: '&'-separated.  A predicate with two '.' is a join
  "b1.c1=b2.c2"; with one '.' it is a filter "b.c<CONST" / ">" / "=".
  The constant may appear on either side (query.c TokenizeFilterPredicate).
  A join whose two bindings are equal is a *self-join* (value equality of
  two columns of the same bound relation).
- SELECTIONS: space-separated "b.c" SUM projections.

The reference classifies filters/self-joins to the head of the predicate
list and joins to the tail (query.c:149-169); we keep the original order but
expose `filters_and_selfjoins` / `joins` views with the same split.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Tuple, Union


@dataclasses.dataclass(frozen=True)
class FilterPred:
    binding: int
    column: int
    op: str  # one of '<', '>', '='
    value: int

    def __str__(self) -> str:
        return f"{self.binding}.{self.column}{self.op}{self.value}"


@dataclasses.dataclass(frozen=True)
class JoinPred:
    binding1: int
    column1: int
    binding2: int
    column2: int

    @property
    def is_self_join(self) -> bool:
        return self.binding1 == self.binding2

    def touches(self, binding: int) -> bool:
        return binding in (self.binding1, self.binding2)

    def pair(self) -> Tuple[int, int]:
        """Unordered binding pair (for duplicate-predicate detection)."""
        return (min(self.binding1, self.binding2), max(self.binding1, self.binding2))

    def __str__(self) -> str:
        return f"{self.binding1}.{self.column1}={self.binding2}.{self.column2}"


Predicate = Union[FilterPred, JoinPred]


@dataclasses.dataclass(frozen=True)
class Query:
    relations: Tuple[int, ...]  # binding -> relation id
    predicates: Tuple[Predicate, ...]  # original text order
    views: Tuple[Tuple[int, int], ...]  # (binding, column) SUM projections
    text: str = ""

    @property
    def num_bindings(self) -> int:
        return len(self.relations)

    @property
    def filters_and_selfjoins(self) -> List[Predicate]:
        return [
            p
            for p in self.predicates
            if isinstance(p, FilterPred) or p.is_self_join
        ]

    @property
    def joins(self) -> List[JoinPred]:
        return [
            p
            for p in self.predicates
            if isinstance(p, JoinPred) and not p.is_self_join
        ]

    def __str__(self) -> str:
        rel = " ".join(str(r) for r in self.relations)
        preds = "&".join(str(p) for p in self.predicates)
        views = " ".join(f"{b}.{c}" for b, c in self.views)
        return f"{rel}|{preds}|{views}"


def _parse_predicate(tok: str) -> Predicate:
    if tok.count(".") == 2:
        left, right = tok.split("=", 1)
        b1, c1 = left.split(".")
        b2, c2 = right.split(".")
        return JoinPred(int(b1), int(c1), int(b2), int(c2))
    # Filter: find the comparator (first of <, >, =), constant on either side.
    for i, ch in enumerate(tok):
        if ch in "<>=":
            op, left, right = ch, tok[:i], tok[i + 1 :]
            break
    else:
        raise ValueError(f"no comparator in predicate {tok!r}")
    if "." in left:
        b, c = left.split(".")
        value = int(right)
    else:
        b, c = right.split(".")
        value = int(left)
        # constant on the left flips the comparator's direction
        op = {"<": ">", ">": "<", "=": "="}[op]
    return FilterPred(int(b), int(c), op, value)


def parse_query(line: str) -> Query:
    line = line.strip()
    rel_s, pred_s, view_s = line.split("|")
    relations = tuple(int(t) for t in rel_s.split())
    predicates: Tuple[Predicate, ...] = tuple(
        _parse_predicate(t) for t in pred_s.split("&") if t
    )
    views = tuple(
        (int(t.split(".")[0]), int(t.split(".")[1])) for t in view_s.split()
    )
    return Query(relations, predicates, views, text=line)


def parse_work_file(lines: Iterable[str]) -> Iterator[List[Query]]:
    """Yield batches of queries from a .work stream (batch ends at 'F')."""
    batch: List[Query] = []
    for raw in lines:
        line = raw.strip()
        if not line:
            continue
        if line == "F":
            if batch:
                yield batch
                batch = []
            continue
        batch.append(parse_query(line))
    if batch:
        yield batch
