"""Contest queries to SQL, one statement per query line on stdin ('F',
'Done' and 'Exit' lines skipped): for cross-checking answers against
PostgreSQL or DuckDB.  Counterpart of the JAX package's
tools/query2sql.py, on the port's parser and frontend/sql.py.

    python -m sigmod2018_tpu_torch.tools.query2sql < queries.work
"""

import sys

from ..frontend.parser import parse_query
from ..frontend.sql import query_to_sql


def translate(lines) -> list:
    """The SQL of every query line of `lines`."""
    return [query_to_sql(parse_query(line.strip())) for line in lines
            if line.strip() and line.strip() not in ("F", "Done", "Exit")]


def main() -> int:
    for sql in translate(sys.stdin):
        print(sql)
    return 0


if __name__ == "__main__":
    sys.exit(main())
