from .stats import QueryStats
from .join_order import plan_joins

__all__ = ["QueryStats", "plan_joins"]
