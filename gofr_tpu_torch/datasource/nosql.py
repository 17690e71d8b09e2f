"""Cassandra and ClickHouse datasources (a copy of
``gofr_tpu/datasource/nosql.py``): ``MockCassandra`` and
``MockClickhouse`` record queries and replay canned rows; the providers
over ``cassandra-driver`` and ``clickhouse-driver`` are gated on their
drivers.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple, Type


class NoSQLError(Exception):
    pass


def _bind_rows(entity_class: Optional[Type],
               rows: List[Dict[str, Any]]) -> List[Any]:
    if entity_class is None:
        return rows
    if dataclasses.is_dataclass(entity_class):
        names = {f.name for f in dataclasses.fields(entity_class)}
        return [entity_class(**{k: v for k, v in row.items() if k in names})
                for row in rows]
    out = []
    for row in rows:
        obj = entity_class()
        for key, value in row.items():
            setattr(obj, key, value)
        out.append(obj)
    return out


class _Observed:
    def __init__(self, logger, metrics, kind: str):
        self.logger = logger
        self.metrics = metrics
        self._kind = kind

    def _observe(self, query: str, start: float) -> None:
        elapsed = time.perf_counter() - start
        self.metrics.record_histogram("app_sql_stats", elapsed,
                                      type=self._kind)
        self.logger.debug("%s %s in %.2fms", self._kind.upper(), query,
                          elapsed * 1e3)


class MockCassandra(_Observed):
    """Seam double (reference: cassandra mock_interfaces.go): records every
    statement; ``stub(substring, rows)`` primes SELECT replies."""

    def __init__(self, logger, metrics):
        super().__init__(logger, metrics, "cassandra")
        self.executed: List[Tuple[str, tuple]] = []
        self._stubs: List[Tuple[str, List[Dict[str, Any]]]] = []
        self._lock = threading.Lock()

    def stub(self, substring: str, rows: List[Dict[str, Any]]) -> None:
        self._stubs.append((substring, rows))

    def _rows_for(self, query: str) -> List[Dict[str, Any]]:
        for substring, rows in self._stubs:
            if substring in query:
                return rows
        return []

    def query(self, entity_class: Optional[Type], query: str,
              *args) -> List[Any]:
        start = time.perf_counter()
        with self._lock:
            self.executed.append((query, args))
        rows = self._rows_for(query)
        self._observe(query, start)
        return _bind_rows(entity_class, rows)

    def exec(self, query: str, *args) -> None:
        start = time.perf_counter()
        with self._lock:
            self.executed.append((query, args))
        self._observe(query, start)

    def exec_cas(self, query: str, *args) -> bool:
        """Lightweight transaction: applied iff no stub marks a conflict."""
        self.exec(query, *args)
        return True

    def health_check(self) -> Dict[str, Any]:
        return {"status": "UP", "details": {"engine": "mock",
                                            "statements": len(self.executed)}}

    def close(self) -> None:
        pass


class CassandraClient(_Observed):
    """Driver-backed provider (gated on cassandra-driver); reference
    provider pattern UseLogger/UseMetrics/Connect (externalDB.go:5-39)."""

    def __init__(self, config, logger, metrics):
        super().__init__(logger, metrics, "cassandra")
        try:
            from cassandra.cluster import Cluster
        except ImportError as exc:
            raise NoSQLError(
                "CASSANDRA_HOSTS configured but cassandra-driver is not "
                "installed") from exc
        hosts = (config.get_or_default("CASSANDRA_HOSTS", "localhost")
                 .split(","))
        self._cluster = Cluster(hosts,
                                port=config.get_int("CASSANDRA_PORT", 9042))
        self._session = self._cluster.connect(
            config.get("CASSANDRA_KEYSPACE"))
        logger.info("cassandra connected %s", hosts)

    def query(self, entity_class, query, *args):
        start = time.perf_counter()
        rows = [dict(row._asdict()) for row in
                self._session.execute(query, args or None)]
        self._observe(query, start)
        return _bind_rows(entity_class, rows)

    def exec(self, query, *args):
        start = time.perf_counter()
        self._session.execute(query, args or None)
        self._observe(query, start)

    def exec_cas(self, query, *args) -> bool:
        result = self._session.execute(query, args or None)
        row = result.one()
        return bool(row and getattr(row, "applied", True))

    def health_check(self):
        try:
            self._session.execute("SELECT release_version FROM system.local")
            return {"status": "UP", "details": {"engine": "cassandra"}}
        except Exception as exc:
            return {"status": "DOWN", "details": {"error": repr(exc)}}

    def close(self):
        self._cluster.shutdown()


class MockClickhouse(_Observed):
    """Seam double for the Exec/Select/AsyncInsert surface."""

    def __init__(self, logger, metrics):
        super().__init__(logger, metrics, "clickhouse")
        self.executed: List[Tuple[str, tuple]] = []
        self.async_inserts: List[Tuple[str, tuple]] = []
        self._stubs: List[Tuple[str, List[Dict[str, Any]]]] = []

    def stub(self, substring: str, rows: List[Dict[str, Any]]) -> None:
        self._stubs.append((substring, rows))

    def exec(self, query: str, *args) -> None:
        start = time.perf_counter()
        self.executed.append((query, args))
        self._observe(query, start)

    def select(self, entity_class: Optional[Type], query: str,
               *args) -> List[Any]:
        start = time.perf_counter()
        self.executed.append((query, args))
        rows = next((rows for substring, rows in self._stubs
                     if substring in query), [])
        self._observe(query, start)
        return _bind_rows(entity_class, rows)

    def async_insert(self, query: str, *args) -> None:
        self.async_inserts.append((query, args))

    def health_check(self) -> Dict[str, Any]:
        return {"status": "UP", "details": {"engine": "mock"}}

    def close(self) -> None:
        pass


class ClickhouseClient(_Observed):
    """Driver-backed provider for the Exec/Select/AsyncInsert surface
    (reference clickhouse interface.go:5-9), gated on clickhouse-driver."""

    def __init__(self, config, logger, metrics):
        super().__init__(logger, metrics, "clickhouse")
        try:
            import clickhouse_driver
        except ImportError as exc:
            raise NoSQLError(
                "CLICKHOUSE_HOST configured but clickhouse-driver is not "
                "installed") from exc
        host = config.get_or_default("CLICKHOUSE_HOST", "localhost")
        self._client = clickhouse_driver.Client(
            host=host, port=config.get_int("CLICKHOUSE_PORT", 9000),
            user=config.get_or_default("CLICKHOUSE_USER", "default"),
            password=config.get_or_default("CLICKHOUSE_PASSWORD", ""),
            database=config.get_or_default("CLICKHOUSE_DB", "default"))
        logger.info("clickhouse connected %s", host)

    @staticmethod
    def _bind_params(query: str, args: tuple):
        """Map the framework's positional ``?`` placeholders onto
        clickhouse-driver's dict form (``%(name)s`` style) — the Python
        driver rejects positional tuples for non-insert statements.
        Pass-throughs: no args → None; a single dict → used
        as-is (driver-native named params); a single list/tuple-of-rows →
        used as-is (driver-native bulk INSERT)."""
        if not args:
            return query, None
        if len(args) == 1 and isinstance(args[0], dict):
            return query, args[0]
        if len(args) == 1 and isinstance(args[0], (list, tuple)):
            rows = args[0]
            if rows and isinstance(rows[0], (list, tuple, dict)):
                return query, rows       # driver-native list of rows
            if "?" not in query:
                return query, [tuple(rows)]   # one flat row for INSERT
        # Quote-aware scan: '?' inside single-quoted SQL literals is text,
        # not a placeholder, and literal '%' must become '%%' because the
        # driver substitutes dict params via Python %-formatting.
        out: List[str] = []
        params: Dict[str, Any] = {}
        index = 0
        in_string = False
        for ch in query:
            if in_string:
                out.append("%%" if ch == "%" else ch)
                if ch == "'":
                    in_string = False
            elif ch == "'":
                in_string = True
                out.append(ch)
            elif ch == "%":
                out.append("%%")
            elif ch == "?":
                if index >= len(args):
                    raise NoSQLError(
                        f"query has more '?' placeholders than the "
                        f"{len(args)} parameters given")
                params[f"p{index}"] = args[index]
                out.append(f"%(p{index})s")
                index += 1
            else:
                out.append(ch)
        if index != len(args):
            raise NoSQLError(
                f"query has {index} '?' placeholders but {len(args)} "
                f"parameters were given")
        return "".join(out), params

    def exec(self, query: str, *args) -> None:
        start = time.perf_counter()
        bound, params = self._bind_params(query, args)
        self._client.execute(bound, params)
        self._observe(query, start)

    def select(self, entity_class: Optional[Type], query: str,
               *args) -> List[Any]:
        start = time.perf_counter()
        bound, params = self._bind_params(query, args)
        rows, columns = self._client.execute(bound, params,
                                             with_column_types=True)
        out = [dict(zip((name for name, _ in columns), row))
               for row in rows]
        self._observe(query, start)
        return _bind_rows(entity_class, out)

    def async_insert(self, query: str, *args) -> None:
        # driver exposes async inserts via settings on execute
        start = time.perf_counter()
        bound, params = self._bind_params(query, args)
        self._client.execute(bound, params,
                             settings={"async_insert": 1,
                                       "wait_for_async_insert": 0})
        self._observe(query, start)

    def health_check(self) -> Dict[str, Any]:
        try:
            self._client.execute("SELECT 1")
            return {"status": "UP", "details": {"engine": "clickhouse"}}
        except Exception as exc:
            return {"status": "DOWN", "details": {"error": repr(exc)}}

    def close(self) -> None:
        self._client.disconnect()


def new_cassandra(config, logger, metrics):
    hosts = config.get_or_default("CASSANDRA_HOSTS", "")
    if hosts in ("", "mock"):
        return MockCassandra(logger, metrics)
    return CassandraClient(config, logger, metrics)


def new_clickhouse(config, logger, metrics):
    host = config.get_or_default("CLICKHOUSE_HOST", "")
    if host in ("", "mock"):
        return MockClickhouse(logger, metrics)
    return ClickhouseClient(config, logger, metrics)
