from .parser import (
    FilterPred,
    JoinPred,
    Query,
    parse_query,
    parse_work_file,
)
from .sql import query_to_sql

__all__ = [
    "FilterPred",
    "JoinPred",
    "Query",
    "parse_query",
    "parse_work_file",
    "query_to_sql",
]
