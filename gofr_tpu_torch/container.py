"""Container — the dependency-injection root owning the app's shared state
(counterpart of ``gofr_tpu/container.py``): the logger, the metrics
manager with the framework's catalog, the tracer, the SLO tracker, the
datasources (SQL, Redis, pub/sub, Mongo, Cassandra, ClickHouse, the file
system), the serving datasource (``tpu``: the executor, an engine or a
registry), aggregated deep health (``health()``) and ``close()``.

``create`` wires what configuration names, in JAX's order: the remote
log level (``REMOTE_LOG_URL``), SQL (``DB_DIALECT``), Redis
(``REDIS_HOST``), pub/sub (``PUBSUB_BACKEND``), the file datasource and
the executor (``TPU_ENABLED``), which runs on ``device`` (default the
card). Mongo, Cassandra and ClickHouse come from ``App.add_mongo`` and
its siblings, as in JAX.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from gofr_tpu_torch.config import Config, MapConfig
from gofr_tpu_torch.logging import Level, Logger, new_logger, new_silent_logger
from gofr_tpu_torch.metrics import (Manager, new_manager,
                                    register_framework_metrics)
from gofr_tpu_torch.slo import SLOTracker
from gofr_tpu_torch.trace import Tracer, new_tracer
from gofr_tpu_torch.version import FRAMEWORK_VERSION


class Container:
    def __init__(self, config: Optional[Config] = None,
                 logger: Optional[Logger] = None, device="cuda"):
        self.config: Config = config if config is not None else MapConfig()
        self.app_name = self.config.get_or_default("APP_NAME", "gofr-tpu-app")
        self.app_version = self.config.get_or_default("APP_VERSION", "dev")
        self.logger: Logger = logger if logger is not None else new_logger()
        self.metrics: Manager = new_manager(self.logger)
        self.tracer: Tracer = Tracer()
        self.services: Dict[str, Any] = {}
        # the device the app's executor runs on (App.add_model, TPU_ENABLED)
        self.device = device
        self.slo = SLOTracker(self.metrics)
        self.watchdog = None          # built by App.start (needs the loop)

        # datasources (all optional; wired by create())
        self.sql = None
        self.redis = None
        self.pubsub = None
        self.mongo = None
        self.cassandra = None
        self.clickhouse = None
        self.file = None
        self.tpu = None
        self.tpu_batcher = None       # built by App.start when tpu is wired
        self.batch_lane = None        # BATCH_LANE_TOPIC
        self.cluster = None           # ClusterRegistry, folded into health()
        self.cluster_router = None
        # the planes App.start builds
        self.telemetry = None
        self.workload = None
        self.slo_budget = None
        self.offenders = None
        self.autotune = None

        self._start_time = time.time()

    # -- composition root ---------------------------------------------------
    @classmethod
    def create(cls, config: Config, logger: Optional[Logger] = None,
               device="cuda") -> "Container":
        level = Level.parse(config.get_or_default("LOG_LEVEL", "INFO"))
        log = logger if logger is not None else new_logger(level)
        container = cls(config=config, logger=log, device=device)
        container.tracer = new_tracer(config, log)
        container.register_framework_metrics()
        remote_url = config.get("REMOTE_LOG_URL")
        if remote_url:
            from gofr_tpu_torch.logging.remote_level import (
                start_remote_level_poller)
            interval = config.get_float("REMOTE_LOG_FETCH_INTERVAL", 15.0)
            start_remote_level_poller(log, remote_url, interval)
        if config.get("DB_DIALECT"):
            from gofr_tpu_torch.datasource.sql import new_sql
            container.sql = new_sql(config, log, container.metrics)
        if config.get("REDIS_HOST"):
            from gofr_tpu_torch.datasource.redisx import new_redis
            container.redis = new_redis(config, log, container.metrics)
        backend = (config.get("PUBSUB_BACKEND") or "").upper()
        if backend:
            from gofr_tpu_torch.datasource.pubsub import new_pubsub
            container.pubsub = new_pubsub(backend, config, log,
                                          container.metrics,
                                          tracer=container.tracer)
        from gofr_tpu_torch.datasource.file import LocalFileSystem
        container.file = LocalFileSystem(log)
        if config.get_bool("TPU_ENABLED", False):
            from gofr_tpu_torch.tpu import new_executor
            container.tpu = new_executor(config, log, container.metrics,
                                         device=device)
        log.debug("container created for app %s@%s (framework %s)",
                  container.app_name, container.app_version,
                  FRAMEWORK_VERSION)
        return container

    def register_framework_metrics(self) -> None:
        register_framework_metrics(self.metrics)

    # -- outbound services ----------------------------------------------------
    def add_http_service(self, name: str, service: Any) -> None:
        self.services[name] = service

    def get_http_service(self, name: str) -> Any:
        return self.services.get(name)

    # -- aggregated health ----------------------------------------------------
    def health(self) -> Dict[str, Any]:
        details: Dict[str, Any] = {
            "name": self.app_name,
            "version": self.app_version,
            "framework": FRAMEWORK_VERSION,
            "uptime_seconds": round(time.time() - self._start_time, 3),
        }
        statuses = []
        for name in ("sql", "redis", "pubsub", "mongo", "cassandra",
                     "clickhouse", "tpu", "cluster"):
            source = getattr(self, name)
            if source is None:
                continue
            try:
                health = source.health_check()
            except Exception as exc:
                health = {"status": "DOWN", "details": {"error": repr(exc)}}
            details[name] = health
            statuses.append(health.get("status", "DOWN"))
        for name, service in self.services.items():
            try:
                health = service.health_check()
            except Exception as exc:
                health = {"status": "DOWN", "details": {"error": repr(exc)}}
            details.setdefault("services", {})[name] = health
            statuses.append(health.get("status", "DOWN"))
        details["status"] = "DEGRADED" if "DOWN" in statuses else "UP"
        # a replica whose SLO windows crossed the watchdog's thresholds
        # reports DEGRADED while every datasource is UP
        if self.watchdog is not None:
            details["watchdog"] = self.watchdog.statusz()
            if self.watchdog.state == "DEGRADED":
                details["status"] = "DEGRADED"
        return details

    async def close(self) -> None:
        """Close the datasources (an engine or a registry as ``tpu`` is
        stopped: its device thread ends), then flush the tracer. A failure
        is logged and the rest still close."""
        for name in ("sql", "redis", "pubsub", "tpu"):
            source = getattr(self, name)
            closer = getattr(source, "close", None)
            if closer is None and name == "tpu":
                closer = getattr(source, "stop", None)
            if closer is None:
                continue
            try:
                result = closer()
                if hasattr(result, "__await__"):
                    await result
            except Exception as exc:  # noqa: BLE001 - shutdown must finish
                self.logger.error("closing %s failed: %r", name, exc)
        try:
            self.tracer.shutdown()
        except Exception as exc:  # noqa: BLE001 - a lost span batch
            self.logger.error("trace export failed: %r", exc)


def new_mock_container(config: Optional[Dict[str, str]] = None,
                       device="cuda") -> Container:
    """Test fixture: a silent logger, the framework's catalog, the
    in-memory broker, an unconfined file datasource, ``InMemoryRedis``
    and a sqlite ``:memory:`` DB."""
    container = Container(config=MapConfig(config or {}),
                          logger=new_silent_logger(), device=device)
    container.register_framework_metrics()
    from gofr_tpu_torch.datasource.file import LocalFileSystem
    from gofr_tpu_torch.datasource.pubsub import InMemoryBroker
    from gofr_tpu_torch.datasource.redisx import InMemoryRedis
    from gofr_tpu_torch.datasource.sql import new_sql
    container.pubsub = InMemoryBroker(container.logger, container.metrics,
                                      tracer=container.tracer)
    container.file = LocalFileSystem(container.logger, sandbox=False)
    container.redis = InMemoryRedis(container.logger, container.metrics)
    container.sql = new_sql(MapConfig({"DB_DIALECT": "sqlite",
                                       "DB_NAME": ":memory:"}),
                            container.logger, container.metrics)
    return container
