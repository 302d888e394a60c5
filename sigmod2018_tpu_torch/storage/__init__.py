from .relation import (Relation, dump_sql, load_relation, store_relation,
                       store_relation_csv)
from .catalog import Catalog, ColumnStats

__all__ = [
    "Relation",
    "load_relation",
    "store_relation",
    "store_relation_csv",
    "dump_sql",
    "Catalog",
    "ColumnStats",
]
