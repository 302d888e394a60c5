from .parser import (
    FilterPred,
    JoinPred,
    Query,
    parse_query,
    parse_work_file,
)

__all__ = [
    "FilterPred",
    "JoinPred",
    "Query",
    "parse_query",
    "parse_work_file",
]
