from .relation import Relation, load_relation, store_relation
from .catalog import Catalog, ColumnStats

__all__ = [
    "Relation",
    "load_relation",
    "store_relation",
    "Catalog",
    "ColumnStats",
]
