"""Dialect query builders used by CRUD (a copy of
``gofr_tpu/datasource/sql/query_builder.py``): insert, select, update
and delete with each dialect's placeholders.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def insert_query(dialect: str, table: str,
                 columns: Sequence[str]) -> str:
    ph = "?" if dialect == "sqlite" else "%s"
    cols = ", ".join(columns)
    vals = ", ".join([ph] * len(columns))
    return f"INSERT INTO {table} ({cols}) VALUES ({vals})"


def select_all_query(dialect: str, table: str) -> str:
    return f"SELECT * FROM {table}"


def select_by_query(dialect: str, table: str, key: str) -> str:
    ph = "?" if dialect == "sqlite" else "%s"
    return f"SELECT * FROM {table} WHERE {key} = {ph}"


def update_by_query(dialect: str, table: str, columns: Sequence[str],
                    key: str) -> str:
    ph = "?" if dialect == "sqlite" else "%s"
    sets = ", ".join(f"{c} = {ph}" for c in columns)
    return f"UPDATE {table} SET {sets} WHERE {key} = {ph}"


def delete_by_query(dialect: str, table: str, key: str) -> str:
    ph = "?" if dialect == "sqlite" else "%s"
    return f"DELETE FROM {table} WHERE {key} = {ph}"
