"""Container — the dependency-injection root owning the app's shared state
(counterpart of ``gofr_tpu/container.py``): the logger, the metrics
manager with the framework's catalog, the tracer, the SLO tracker, the
file datasource, the in-memory pub/sub broker, the serving datasource
(``tpu``: the executor, an engine or a registry), aggregated deep health
(``health()``) and ``close()``.

The port has the in-memory broker only. A configured datasource it does
not have yet (SQL, Redis, Kafka / MQTT / Google pub/sub, Mongo,
Cassandra, ClickHouse, the remote log level) raises at
:meth:`Container.create`, naming its ROADMAP entry, instead of being
left unset. The executor ``TPU_ENABLED`` builds runs on ``device``
(default the card).
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

FRAMEWORK_VERSION = "0.1.0"

# config key -> the datasource it configures; none is ported yet
NOT_PORTED = (
    ("DB_DIALECT", "SQL"),
    ("REDIS_HOST", "Redis"),
    ("MONGO_URI", "Mongo"),
    ("CASSANDRA_HOSTS", "Cassandra"),
    ("CLICKHOUSE_HOST", "ClickHouse"),
    ("REMOTE_LOG_URL", "the remote log level"),
)
PORTED_PUBSUB = ("INMEM", "MEMORY")
ROADMAP_ENTRY = ("ROADMAP.md §1, the rest of the framework: the "
                 "datasources")


class NotPorted(ValueError):
    """A configured datasource the port does not have yet."""


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

        self.pubsub = None
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
        for key, name in NOT_PORTED:
            if config.get(key):
                raise NotPorted(f"{key}: the {name} datasource is not ported "
                                f"to gofr_tpu_torch yet ({ROADMAP_ENTRY})")
        backend = (config.get("PUBSUB_BACKEND") or "").upper()
        if backend and backend not in PORTED_PUBSUB:
            raise NotPorted(f"PUBSUB_BACKEND={backend}: only the in-memory "
                            f"broker (INMEM) is ported to gofr_tpu_torch "
                            f"({ROADMAP_ENTRY})")
        level = Level.parse(config.get_or_default("LOG_LEVEL", "INFO"))
        log = logger if logger is not None else new_logger(level)
        container = cls(config=config, logger=log, device=device)
        container.tracer = new_tracer(config, log)
        container.register_framework_metrics()
        if backend:
            from gofr_tpu_torch.datasource.pubsub import InMemoryBroker
            container.pubsub = InMemoryBroker(log, container.metrics,
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
        for name in ("pubsub", "tpu", "cluster"):
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
        for name in ("pubsub", "tpu"):
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
    in-memory broker and an unconfined file datasource."""
    container = Container(config=MapConfig(config or {}),
                          logger=new_silent_logger(), device=device)
    container.register_framework_metrics()
    from gofr_tpu_torch.datasource.file import LocalFileSystem
    from gofr_tpu_torch.datasource.pubsub import InMemoryBroker
    container.pubsub = InMemoryBroker(container.logger, container.metrics,
                                      tracer=container.tracer)
    container.file = LocalFileSystem(container.logger, sandbox=False)
    return container
