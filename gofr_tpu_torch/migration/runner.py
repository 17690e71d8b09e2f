"""Versioned, transactional, journaled migrations (a copy of
``gofr_tpu/migration/runner.py``). Migrations are keyed by a positive
int version and run in order, each in one SQL transaction, skipping
those at or below the last applied version; each applied version is
journaled in the ``gofr_migrations`` table and the ``gofr_migrations``
Redis hash, and the resume point is the larger of the two.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, Optional, Union

MIGRATION_TABLE_DDL = """
CREATE TABLE IF NOT EXISTS gofr_migrations (
    version INTEGER PRIMARY KEY,
    method TEXT NOT NULL,
    start_time TEXT NOT NULL,
    duration_ms REAL
)
"""

REDIS_JOURNAL_KEY = "gofr_migrations"


class MigrationError(Exception):
    pass


class Migration:
    """A single UP step: ``Migration(up=fn)`` where fn(datasources)."""

    def __init__(self, up: Callable[["Datasources"], None]):
        if not callable(up):
            raise MigrationError("migration UP must be callable")
        self.up = up


class Datasources:
    """What a migration sees: the SQL handle is the transaction, Redis is
    live, pub/sub exposes topic create/delete (interface.go:27-30)."""

    def __init__(self, sql=None, redis=None, pubsub=None, logger=None):
        self.sql = sql
        self.redis = redis
        self.pubsub = pubsub
        self.logger = logger

    def create_topic(self, name: str) -> None:
        if self.pubsub is not None:
            self.pubsub.create_topic(name)

    def delete_topic(self, name: str) -> None:
        if self.pubsub is not None:
            self.pubsub.delete_topic(name)


def _last_sql_version(sql) -> int:
    sql.execute(MIGRATION_TABLE_DDL)
    row = sql.query_row("SELECT MAX(version) AS v FROM gofr_migrations")
    return int(row["v"] or 0) if row else 0


def _last_redis_version(redis) -> int:
    journal = redis.hgetall(REDIS_JOURNAL_KEY)
    return max((int(v) for v in journal.keys()), default=0)


def run_migrations(container,
                   migrations: Dict[int, Union[Migration, Callable]]) -> int:
    """Run pending migrations in version order; returns how many ran."""
    logger = container.logger
    if not migrations:
        return 0
    for version in migrations:
        if not isinstance(version, int) or version <= 0:
            raise MigrationError(f"invalid migration version {version!r}")

    sql = container.sql
    redis = container.redis
    last = 0
    if sql is not None:
        last = max(last, _last_sql_version(sql))
    if redis is not None:
        last = max(last, _last_redis_version(redis))

    ran = 0
    for version in sorted(migrations):
        if version <= last:
            continue
        migration = migrations[version]
        up = migration.up if isinstance(migration, Migration) else migration
        start = time.time()
        t0 = time.perf_counter()
        tx = sql.begin() if sql is not None else None
        try:
            up(Datasources(sql=tx if tx is not None else None, redis=redis,
                           pubsub=container.pubsub, logger=logger))
            duration_ms = (time.perf_counter() - t0) * 1e3
            if tx is not None:
                tx.execute(
                    "INSERT INTO gofr_migrations "
                    "(version, method, start_time, duration_ms) "
                    "VALUES (?, ?, ?, ?)",
                    version, "UP",
                    time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(start)),
                    duration_ms)
                tx.commit()
            if redis is not None:
                redis.hsetnx(REDIS_JOURNAL_KEY, str(version), json.dumps({
                    "method": "UP", "start_time": start,
                    "duration_ms": duration_ms}))
            logger.info("migration %d UP ok in %.1fms", version, duration_ms)
            ran += 1
        except Exception as exc:
            if tx is not None:
                tx.rollback()
            logger.error("migration %d failed, rolled back: %r", version, exc)
            raise MigrationError(f"migration {version} failed: {exc}") \
                from exc
    return ran


def last_migration(container) -> int:
    """Highest applied version across journals (the resume point)."""
    last = 0
    if container.sql is not None:
        last = max(last, _last_sql_version(container.sql))
    if container.redis is not None:
        last = max(last, _last_redis_version(container.redis))
    return last
