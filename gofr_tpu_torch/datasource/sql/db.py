"""SQL datasource (a copy of ``gofr_tpu/datasource/sql/db.py``): a
dialect-aware ``DB`` that logs every query and times it into
``app_sql_stats``, ``Tx``, a binder from rows to dataclasses, health and
the connection gauges. sqlite comes from the stdlib; mysql and postgres
are gated on their drivers.
"""

from __future__ import annotations

import dataclasses
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Type

SUPPORTED_DIALECTS = ("sqlite", "mysql", "postgres")


class SQLError(Exception):
    pass


def _placeholder(dialect: str) -> str:
    return "?" if dialect == "sqlite" else "%s"


class _Cursor:
    """Row access shared by DB and Tx."""

    def __init__(self, db: "DB", conn):
        self._db = db
        self._conn = conn

    def _observe(self, query: str, start: float) -> None:
        elapsed = time.perf_counter() - start
        self._db.metrics.record_histogram("app_sql_stats", elapsed,
                                          type=query.split(None, 1)[0].lower())
        self._db.logger.debug("SQL %s in %.2fms", query, elapsed * 1e3)

    def execute(self, query: str, *args) -> int:
        """INSERT/UPDATE/DELETE/DDL → affected row count."""
        start = time.perf_counter()
        try:
            cursor = self._conn.execute(query, args)
            self._observe(query, start)
            return cursor.rowcount
        except Exception as exc:
            self._db.logger.error("SQL exec failed: %s (%r)", query, exc)
            self._db._on_query_error()
            raise SQLError(str(exc)) from exc

    def select(self, query: str, *args) -> List[Dict[str, Any]]:
        """SELECT → list of dict rows."""
        start = time.perf_counter()
        try:
            cursor = self._conn.execute(query, args)
            columns = [c[0] for c in cursor.description or []]
            rows = [dict(zip(columns, row)) for row in cursor.fetchall()]
            self._observe(query, start)
            return rows
        except Exception as exc:
            self._db.logger.error("SQL select failed: %s (%r)", query, exc)
            self._db._on_query_error()
            raise SQLError(str(exc)) from exc

    def query_row(self, query: str, *args) -> Optional[Dict[str, Any]]:
        rows = self.select(query, *args)
        return rows[0] if rows else None

    def bind(self, entity_class: Type, query: str, *args) -> List[Any]:
        """Reflection binder: SELECT rows → entity instances, matching
        column names to dataclass fields (db.go:260-301 ``rowsToStruct``)."""
        rows = self.select(query, *args)
        if dataclasses.is_dataclass(entity_class):
            names = {f.name for f in dataclasses.fields(entity_class)}
            return [entity_class(**{k: v for k, v in row.items()
                                    if k in names}) for row in rows]
        out = []
        for row in rows:
            obj = entity_class()
            for key, value in row.items():
                setattr(obj, key, value)
            out.append(obj)
        return out


class Tx(_Cursor):
    """Transaction handle (db.go:116-175)."""

    def commit(self) -> None:
        self._conn.commit()
        self._db._release(self)

    def rollback(self) -> None:
        self._conn.rollback()
        self._db._release(self)

    def __enter__(self) -> "Tx":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.commit()
        else:
            self.rollback()


class DB(_Cursor):
    """Connection owner. sqlite runs one serialized connection guarded by a
    lock (handlers run in worker threads); autocommit for plain exec,
    explicit ``begin()`` for transactions.

    A maintenance thread mirrors the reference's two background goroutines
    (sql.go:108-132 ``retryConnection``, sql.go:189-202 ``pushDBMetrics``):
    every ``DB_RETRY_FREQUENCY`` seconds (default 10) it pushes connection
    gauges and pings; a dead backend is reconnected in place — callers
    keep using the same DB object and recover without an app restart. A
    failing query wakes the loop immediately instead of waiting out the
    interval."""

    def __init__(self, config, logger, metrics):
        self.logger = logger
        self.metrics = metrics
        self.dialect = (config.get_or_default("DB_DIALECT", "sqlite")
                        .lower())
        if self.dialect not in SUPPORTED_DIALECTS:
            raise SQLError(f"unsupported DB_DIALECT {self.dialect!r} "
                           f"(supported: {SUPPORTED_DIALECTS})")
        self.database = config.get_or_default("DB_NAME", ":memory:")
        self.placeholder = _placeholder(self.dialect)
        self._config = config
        self._lock = threading.RLock()
        super().__init__(self, self._connect())
        logger.info("SQL connected: dialect=%s db=%s", self.dialect,
                    self.database)
        self.retry_frequency = config.get_float("DB_RETRY_FREQUENCY", 10.0)
        self._inuse = 0
        self._closed = False
        self._wake = threading.Event()
        self._maintenance = threading.Thread(
            target=self._maintenance_loop, daemon=True,
            name="sql-maintenance")
        self._maintenance.start()

    def _connect(self):
        if self.dialect == "sqlite":
            return sqlite3.connect(self.database, check_same_thread=False,
                                   isolation_level=None)  # autocommit
        return self._connect_server(self._config)

    def _on_query_error(self) -> None:
        """Wake the maintenance loop now — a failing statement (direct or
        inside a transaction) should start recovery immediately, not at
        the next interval."""
        self._wake.set()

    # -- maintenance (reconnect + stats push) -------------------------------
    def _maintenance_loop(self) -> None:
        while True:
            self._wake.wait(timeout=self.retry_frequency)
            self._wake.clear()
            if self._closed:
                return
            up = self._ping()
            self.metrics.set_gauge("app_sql_open_connections",
                                   1.0 if up else 0.0)
            self.metrics.set_gauge("app_sql_inuse_connections",
                                   float(self._inuse))
            if not up and not self._closed:
                if self.dialect == "sqlite" and self.database == ":memory:":
                    # an in-memory database IS the connection — swapping
                    # in a fresh one would silently replace every table
                    # with nothing; surface the failure instead
                    self.logger.error(
                        "SQL :memory: connection unhealthy; not replacing "
                        "(reconnect would silently lose all data)")
                    continue
                self.logger.info("retrying SQL database connection")
                self._reconnect()

    def _ping(self) -> bool:
        try:
            with self._lock:
                self._conn.execute("SELECT 1")
            return True
        except Exception:
            return False

    def _reconnect(self) -> None:
        try:
            fresh = self._connect()
            with self._lock:
                if self._closed:      # close() raced us: don't leak fresh
                    fresh.close()
                    return
                old, self._conn = self._conn, fresh
            try:
                old.close()
            except Exception:
                pass
            self.metrics.set_gauge("app_sql_open_connections", 1.0)
            self.logger.info("SQL reconnected: dialect=%s db=%s",
                             self.dialect, self.database)
        except Exception as exc:
            self.logger.error("SQL reconnect failed: %r", exc)

    def _connect_server(self, config):
        host = config.get_or_default("DB_HOST", "localhost")
        if self.dialect == "mysql":
            try:
                import pymysql  # optional driver
            except ImportError as exc:
                raise SQLError(
                    "mysql dialect needs the pymysql driver installed") \
                    from exc
            return pymysql.connect(
                host=host, user=config.get("DB_USER"),
                password=config.get("DB_PASSWORD") or "",
                database=self.database,
                port=config.get_int("DB_PORT", 3306), autocommit=True)
        try:
            import psycopg2  # optional driver
        except ImportError as exc:
            raise SQLError(
                "postgres dialect needs the psycopg2 driver installed") \
                from exc
        conn = psycopg2.connect(
            host=host, user=config.get("DB_USER"),
            password=config.get("DB_PASSWORD") or "",
            dbname=self.database, port=config.get_int("DB_PORT", 5432))
        conn.autocommit = True
        return conn

    # serialize sqlite access across worker threads; a failure wakes the
    # maintenance loop so reconnection starts now, not next interval
    def execute(self, query: str, *args) -> int:
        with self._lock:
            self._inuse += 1
            try:
                return super().execute(query, *args)
            except SQLError:
                self._wake.set()
                raise
            finally:
                self._inuse -= 1

    def select(self, query: str, *args) -> List[Dict[str, Any]]:
        with self._lock:
            self._inuse += 1
            try:
                return super().select(query, *args)
            except SQLError:
                self._wake.set()
                raise
            finally:
                self._inuse -= 1

    def begin(self) -> Tx:
        self._lock.acquire()
        self._inuse += 1
        try:
            self._conn.execute("BEGIN")
        except Exception:
            self._inuse -= 1
            self._lock.release()
            self._wake.set()
            raise
        return Tx(self, self._conn)

    def _release(self, tx: Tx) -> None:
        self._inuse -= 1
        self._lock.release()

    def health_check(self) -> Dict[str, Any]:
        try:
            with self._lock:
                self._conn.execute("SELECT 1").fetchone()
            return {"status": "UP",
                    "details": {"dialect": self.dialect,
                                "database": self.database}}
        except Exception as exc:
            return {"status": "DOWN", "details": {"error": repr(exc)}}

    def close(self) -> None:
        self._closed = True
        self._wake.set()
        if getattr(self, "_maintenance", None) is not None:
            self._maintenance.join(timeout=2.0)
        # under the lock: a maintenance ping past the _closed check must
        # not race the close, and _reconnect's _closed re-check (also
        # under the lock) guarantees no fresh connection leaks after this
        with self._lock:
            try:
                self._conn.close()
            except Exception:
                pass


def new_sql(config, logger, metrics) -> DB:
    return DB(config, logger, metrics)
