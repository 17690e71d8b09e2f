"""SQL datasource (counterpart of ``gofr_tpu/datasource/sql``)."""

from gofr_tpu_torch.datasource.sql.db import DB, SQLError, Tx, new_sql
from gofr_tpu_torch.datasource.sql.query_builder import (
    delete_by_query,
    insert_query,
    select_all_query,
    select_by_query,
    update_by_query,
)

__all__ = ["DB", "SQLError", "Tx", "new_sql", "insert_query",
           "select_all_query", "select_by_query", "update_by_query",
           "delete_by_query"]
