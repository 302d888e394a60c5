"""Query -> SQL translation for cross-engine validation (counterpart of
`sigmod2018_tpu/frontend/sql.py`).

Mirrors the reference's Query2SQL tool (Query2SQL.cpp, Parser.cpp:224-251):
each contest query becomes a SELECT SUM(...) over the bound relations so the
engine's checksums can be re-derived in PostgreSQL/DuckDB.
"""

from __future__ import annotations

from .parser import FilterPred, JoinPred, Query


def query_to_sql(q: Query) -> str:
    selects = ", ".join(f"SUM({_col(b, c)})" for b, c in q.views)
    froms = ", ".join(f"r{rid} {_alias(b)}" for b, rid in enumerate(q.relations))
    wheres = []
    for p in q.predicates:
        if isinstance(p, JoinPred):
            wheres.append(
                f"{_col(p.binding1, p.column1)}={_col(p.binding2, p.column2)}"
            )
        elif isinstance(p, FilterPred):
            wheres.append(f"{_col(p.binding, p.column)}{p.op}{p.value}")
    where = " and ".join(wheres)
    return f"SELECT {selects} FROM {froms} WHERE {where};"


def _alias(binding: int) -> str:
    return f"r{binding}"


def _col(binding: int, column: int) -> str:
    return f"{_alias(binding)}.c{column}"
