"""App — the one object wiring every entry point of the framework
(counterpart of ``gofr_tpu/app.py``).

One asyncio loop owns the HTTP server, the metrics server, the gRPC
server (when a service is registered), the subscriber loops and the cron
task; handlers may be async or plain ``def`` (run in a thread with the
request's contextvars). ``start()`` wires every serving plane in JAX's
order (``gofr_tpu/app.py:472-676``): the workload recorder, the dynamic
batcher, the fault plan, the telemetry store, the watchdog and its
brownout ladder, the error budget, the auto-tuner cron, the worst
offenders and the batch lane; then the servers bind. Startup hooks (a
model's warm-up and graph captures) run first, so no request lands
before them.

``App(device=...)`` is where ``add_model`` builds its executor and what
the profiler traces: the container's device, the card unless the caller
asks for the CPU. The ``enable_*`` methods register the ``/debug/*``
pages (each off by default) and the ``/debug/`` index of those enabled;
``add_http_service`` registers an outbound client in the container;
``migrate`` runs versioned migrations over the container's SQL and
Redis; ``add_mongo``, ``add_cassandra`` and ``add_clickhouse`` inject an
external datasource. ``add_rest_handlers`` registers a dataclass's five
CRUD routes, ``websocket`` a websocket route, ``sub_command`` a CLI
command; an app with commands runs them from ``run()`` (``new_cmd``
builds one that logs to ``CMD_LOGS_FILE``). ``./static/openapi.json``
under the working directory is served with the swagger UI.

``run()`` returns the CLI's exit code where JAX's returns None (ROADMAP
§3, divergences).
"""

from __future__ import annotations

import asyncio
import os
import signal
from typing import Any, Callable, Dict, List, Optional

from gofr_tpu_torch.config import Config, EnvConfig
from gofr_tpu_torch.container import Container
from gofr_tpu_torch.context import Context
from gofr_tpu_torch.cron import Crontab
from gofr_tpu_torch.handler import (
    Handler,
    catch_all_handler,
    favicon_handler,
    live_handler,
    make_health_handler,
    wrap_handler,
)
from gofr_tpu_torch.http.middleware import (
    api_key_auth_middleware,
    basic_auth_middleware,
    cors_middleware,
    logging_middleware,
    metrics_middleware,
    oauth_middleware,
    tracing_middleware,
)
from gofr_tpu_torch.http.request import Request
from gofr_tpu_torch.http.router import Router
from gofr_tpu_torch.http.server import HTTPServer
from gofr_tpu_torch.logging import new_file_logger
from gofr_tpu_torch.metrics import render_prometheus, system_metrics_refresh

DEFAULT_HTTP_PORT = 8000
DEFAULT_GRPC_PORT = 9000
DEFAULT_METRICS_PORT = 2121


class App:
    def __init__(self, config: Optional[Config] = None,
                 container: Optional[Container] = None, device=None):
        self.config: Config = config if config is not None else EnvConfig()
        self.container: Container = (
            container if container is not None
            else Container.create(self.config, device=device or "cuda")
        )
        if device is not None:
            self.container.device = device
        self.logger = self.container.logger
        self.router = Router()
        self.crontab = Crontab(self.container)
        self._subscriptions: Dict[str, Handler] = {}
        self._grpc_services: List[tuple] = []
        self._cli_commands: List[Any] = []
        self._request_timeout = self.config.get_float("REQUEST_TIMEOUT", 0.0)
        # how long stop() lets responses in flight (SSE generation streams
        # too) finish before their connections are closed
        self._shutdown_grace = self.config.get_float(
            "SHUTDOWN_GRACE_PERIOD", 5.0)
        self.http_port = self.config.get_int("HTTP_PORT", DEFAULT_HTTP_PORT)
        self.grpc_port = self.config.get_int("GRPC_PORT", DEFAULT_GRPC_PORT)
        self.metrics_port = self.config.get_int("METRICS_PORT",
                                                DEFAULT_METRICS_PORT)
        self._http_server: Optional[HTTPServer] = None
        self._metrics_server: Optional[HTTPServer] = None
        self._grpc_server = None
        self._tasks: List[asyncio.Task] = []
        self._startup_hooks: List[Callable] = []
        self._shutdown_hooks: List[Callable] = []
        self._shutdown: Optional[asyncio.Event] = None  # made in start()
        # every enabled /debug/* page with its one-line description
        self._debug_surfaces: Dict[str, str] = {}
        self._install_default_middleware()

    def on_startup(self, func: Callable) -> Callable:
        """Run a (possibly async) callable inside ``start()`` before the
        servers accept traffic: a model's warm-up and graph captures, so
        the first request never pays one. Returns ``func``."""
        self._startup_hooks.append(func)
        return func

    def on_shutdown(self, func: Callable) -> Callable:
        """Run a (possibly async) callable first thing in ``stop()``,
        while the datasources are open. A failure is logged, and the
        shutdown goes on. Returns ``func``."""
        self._shutdown_hooks.append(func)
        return func

    # -- middleware chain ---------------------------------------------------
    def _install_default_middleware(self) -> None:
        self.router.use_middleware(
            tracing_middleware(self.container.tracer),
            logging_middleware(self.logger),
            cors_middleware(self.config, self.router),
            metrics_middleware(self.container.metrics),
        )

    def use_middleware(self, *middlewares) -> None:
        self.router.use_middleware(*middlewares)

    def enable_basic_auth(self, users: Dict[str, str]) -> None:
        self.router.use_middleware(basic_auth_middleware(users=users))

    def enable_basic_auth_with_validator(self, validate: Callable) -> None:
        self.router.use_middleware(
            basic_auth_middleware(validate=validate, container=self.container))

    def enable_api_key_auth(self, *keys: str) -> None:
        self.router.use_middleware(api_key_auth_middleware(keys=keys))

    def enable_api_key_auth_with_validator(self, validate: Callable) -> None:
        self.router.use_middleware(
            api_key_auth_middleware(validate=validate,
                                    container=self.container))

    def enable_oauth(self, jwks_url: str,
                     refresh_interval: float = 300.0) -> None:
        self.router.use_middleware(
            oauth_middleware(jwks_url=jwks_url,
                             refresh_interval=refresh_interval))

    # -- route verbs --------------------------------------------------------
    def add_route(self, method: str, pattern: str, handler: Handler) -> None:
        wire = wrap_handler(handler, self.container,
                            timeout=self._request_timeout or None)
        self.router.add(method, pattern, wire)

    def get(self, pattern: str, handler: Handler) -> None:
        self.add_route("GET", pattern, handler)

    def post(self, pattern: str, handler: Handler) -> None:
        self.add_route("POST", pattern, handler)

    def put(self, pattern: str, handler: Handler) -> None:
        self.add_route("PUT", pattern, handler)

    def patch(self, pattern: str, handler: Handler) -> None:
        self.add_route("PATCH", pattern, handler)

    def delete(self, pattern: str, handler: Handler) -> None:
        self.add_route("DELETE", pattern, handler)

    def options(self, pattern: str, handler: Handler) -> None:
        self.add_route("OPTIONS", pattern, handler)

    def head(self, pattern: str, handler: Handler) -> None:
        self.add_route("HEAD", pattern, handler)

    def add_static_files(self, url_prefix: str, directory: str) -> None:
        self.router.add_static_files(url_prefix, directory)

    def add_rest_handlers(self, entity_class: type) -> None:
        """POST, GET (all and one), PUT and DELETE routes of a dataclass
        over the container's SQL."""
        from gofr_tpu_torch.crud import register_crud_routes
        register_crud_routes(self, entity_class)

    def websocket(self, pattern: str, handler: Handler) -> None:
        """A websocket route: the handler reads and writes messages
        through ``ctx.read_message()`` / ``ctx.write_message()``."""
        from gofr_tpu_torch.websocket.upgrade import make_ws_route
        self.router.add("GET", pattern, make_ws_route(handler, self.container))

    def sub_command(self, pattern: str, handler: Handler,
                    description: str = "", help_text: str = "") -> None:
        """A CLI command: ``pattern`` is a regex over argv's positional
        words."""
        from gofr_tpu_torch.cli.command import CLICommand
        self._cli_commands.append(
            CLICommand(pattern, handler, description, help_text))

    # -- pub/sub, cron, gRPC --------------------------------------------------
    def subscribe(self, topic: str, handler: Handler) -> None:
        if self.container.pubsub is None:
            self.logger.error(
                "subscribe(%r) ignored: no PUBSUB_BACKEND configured", topic)
            return
        self._subscriptions[topic] = handler

    def migrate(self, migrations: Dict[int, Any]) -> None:
        """Run the pending ``migrations`` ({version: up(datasources)})
        over the container's SQL, Redis and pub/sub."""
        from gofr_tpu_torch.migration import run_migrations
        try:
            run_migrations(self.container, migrations)
        except Exception as exc:
            self.logger.error("migration run failed: %r", exc)
            raise

    def add_cron_job(self, spec: str, name: str, func: Handler) -> None:
        self.crontab.add_job(spec, name, func)

    def register_grpc_service(self, register_fn: Callable,
                              servicer: Any) -> None:
        """``register_fn`` is the protoc-generated
        ``add_*Servicer_to_server``; ``servicer`` the implementation."""
        self._grpc_services.append((register_fn, servicer))

    def register_grpc_unary(self, service: str, method: str,
                            handler: Handler) -> None:
        """A dynamic JSON unary RPC, ``/gofr.<service>/<method>``."""
        self._grpc_services.append((("dynamic", service, method), handler))

    def register_grpc_stream(self, service: str, method: str,
                             handler: Handler) -> None:
        """A dynamic JSON server-streaming RPC: the handler returns an
        async iterator, and each item is a message of its own."""
        self._grpc_services.append(
            (("dynamic_stream", service, method), handler))

    # -- debug pages ----------------------------------------------------------
    def enable_profiler(self, prefix: str = "/debug/profiler") -> None:
        from gofr_tpu_torch.profiler import enable_profiler
        enable_profiler(self, prefix)
        self._note_debug_surface(
            prefix, "on-demand single-flight device trace capture")

    def enable_statusz(self, prefix: str = "/debug/statusz") -> None:
        from gofr_tpu_torch.statusz import enable_statusz
        enable_statusz(self, prefix)
        self._note_debug_surface(
            prefix, "live serving state: queues, slots, flight records, "
                    "watchdog, KV occupancy")

    def enable_varz(self, prefix: str = "/debug/varz") -> None:
        from gofr_tpu_torch.varz import enable_varz
        enable_varz(self, prefix)
        self._note_debug_surface(
            prefix, "windowed SLO attainment, goodput, and device "
                    "saturation rates")

    def enable_xlaz(self, prefix: str = "/debug/xlaz") -> None:
        from gofr_tpu_torch.xlaz import enable_xlaz
        enable_xlaz(self, prefix)
        self._note_debug_surface(
            prefix, "compile ledger, bucket ladders, and padding-optimal "
                    "ladder suggestions")

    def enable_clusterz(self, prefix: str = "/debug/clusterz") -> None:
        from gofr_tpu_torch.clusterz import enable_clusterz
        enable_clusterz(self, prefix)
        self._note_debug_surface(
            prefix, "fleet rollup: per-replica health, per-role "
                    "aggregates, router stats")

    def enable_tracez(self, prefix: str = "/debug/tracez") -> None:
        from gofr_tpu_torch.clusterz import enable_tracez
        enable_tracez(self, prefix)
        self._note_debug_surface(
            f"{prefix}/{{trace_id}}",
            "cross-replica stitched timeline for one trace id")

    def enable_hbmz(self, prefix: str = "/debug/hbmz") -> None:
        from gofr_tpu_torch.hbmz import enable_hbmz
        enable_hbmz(self, prefix)
        self._note_debug_surface(
            prefix, "HBM attribution: per-tenant KV pages, pools, "
                    "residual accounting")

    def enable_timez(self, prefix: str = "/debug/timez") -> None:
        from gofr_tpu_torch.timez import enable_timez
        enable_timez(self, prefix)
        self._note_debug_surface(
            prefix, "multi-resolution time series, anomalies, and "
                    "sampled tick anatomy")

    def enable_workloadz(self, prefix: str = "/debug/workloadz") -> None:
        from gofr_tpu_torch.workloadz import enable_workloadz
        enable_workloadz(self, prefix)
        self._note_debug_surface(
            prefix, "shape-only workload capture and per-executable "
                    "roofline attribution")

    def enable_sloz(self, prefix: str = "/debug/sloz") -> None:
        from gofr_tpu_torch.sloz import enable_sloz
        enable_sloz(self, prefix)
        self._note_debug_surface(
            prefix, "error-budget burn rates per (model, SLO class) and "
                    "the worst-offender ring")

    def enable_tunez(self, prefix: str = "/debug/tunez") -> None:
        from gofr_tpu_torch.tunez import enable_tunez
        enable_tunez(self, prefix)
        self._note_debug_surface(
            prefix, "live operating point with provenance, candidate "
                    "ledger, and auto-tuner guard states")

    def enable_whyz(self, prefix: str = "/debug/whyz") -> None:
        from gofr_tpu_torch.whyz import enable_whyz
        enable_whyz(self, prefix)
        self._note_debug_surface(
            f"{prefix}/{{trace_id}}",
            "automated root-cause verdicts for one slow request")

    def _note_debug_surface(self, path: str, description: str) -> None:
        self._debug_surfaces[path] = description
        routes = set(self.router.registered_routes)
        if "GET /debug/" not in routes:
            self.get("/debug/", lambda ctx: self.debug_index())

    def debug_index(self) -> Dict[str, str]:
        """The ``/debug/`` index payload: every enabled debug surface
        with its one-line description, sorted by path."""
        return {path: self._debug_surfaces[path]
                for path in sorted(self._debug_surfaces)}

    # -- external datasources -----------------------------------------------
    def add_mongo(self, client=None) -> None:
        if client is None:
            from gofr_tpu_torch.datasource.mongo import new_mongo
            client = new_mongo(self.config, self.logger,
                               self.container.metrics)
        self.container.mongo = client

    def add_cassandra(self, client=None) -> None:
        if client is None:
            from gofr_tpu_torch.datasource.nosql import new_cassandra
            client = new_cassandra(self.config, self.logger,
                                   self.container.metrics)
        self.container.cassandra = client

    def add_clickhouse(self, client=None) -> None:
        if client is None:
            from gofr_tpu_torch.datasource.nosql import new_clickhouse
            client = new_clickhouse(self.config, self.logger,
                                    self.container.metrics)
        self.container.clickhouse = client

    # -- outbound services ----------------------------------------------------
    def add_http_service(self, name: str, base_url: str, *options,
                         timeout: float = 30.0) -> None:
        from gofr_tpu_torch.service import new_http_service
        service = new_http_service(
            base_url, self.logger, self.container.metrics,
            self.container.tracer, *options, timeout=timeout,
            service_name=name)
        self.container.add_http_service(name, service)

    # -- models ---------------------------------------------------------------
    def add_model(self, name: str, fn, params=None, **kwargs) -> None:
        """Register a servable model (``fn(params, batch)``) with the
        container's executor, built on the app's device at first use."""
        if self.container.tpu is None:
            from gofr_tpu_torch.tpu import new_executor
            self.container.tpu = new_executor(
                self.config, self.logger, self.container.metrics,
                device=self.container.device)
        self.container.tpu.register(name, fn, params, **kwargs)

    # -- dispatch -------------------------------------------------------------
    async def _dispatch(self, request: Request):
        handler, params, other_method, template = self.router.lookup(
            request.method, request.path)
        request.route = template
        if handler is None:
            if other_method:
                from gofr_tpu_torch.http.errors import MethodNotAllowed
                wire = self.router.wrap(
                    lambda req: _error_response(MethodNotAllowed()))
                return await wire(request)
            wire = self.router.wrap(catch_all_handler)
            return await wire(request)
        request.path_params = params
        return await self.router.wrap(handler)(request)

    def _register_default_routes(self) -> None:
        routes = set(self.router.registered_routes)
        if "GET /.well-known/health" not in routes:
            self.router.add("GET", "/.well-known/health",
                            make_health_handler(self.container))
        if "GET /.well-known/alive" not in routes:
            self.router.add("GET", "/.well-known/alive", live_handler)
        if "GET /favicon.ico" not in routes:
            self.router.add("GET", "/favicon.ico", favicon_handler)
        openapi_path = os.path.join("static", "openapi.json")
        if os.path.isfile(openapi_path):
            from gofr_tpu_torch.openapi import make_openapi_handlers
            spec_handler, ui_handler, asset_handler = \
                make_openapi_handlers(openapi_path)
            self.router.add("GET", "/.well-known/openapi.json", spec_handler)
            self.router.add("GET", "/.well-known/swagger", ui_handler)
            self.router.add("GET", "/.well-known/swagger/{asset}",
                            asset_handler)

    async def _metrics_dispatch(self, request: Request):
        if request.path in ("/metrics", "/"):
            system_metrics_refresh(self.container.metrics,
                                   self.container.app_name,
                                   self.container.app_version)
            # windowed SLO rates and the executor's saturation, a scrape
            self.container.slo.export_gauges()
            if self.container.tpu is not None \
                    and hasattr(self.container.tpu, "saturation"):
                try:
                    self.container.tpu.saturation()
                except Exception as exc:
                    self.logger.error("saturation refresh failed: %r", exc)
            body = render_prometheus(self.container.metrics).encode()
            return 200, {"Content-Type": "text/plain; version=0.0.4"}, body
        return 404, {}, b"not found"

    # -- subscriber loops -----------------------------------------------------
    async def _subscriber_loop(self, topic: str, handler: Handler) -> None:
        pubsub = self.container.pubsub
        while True:
            try:
                message = await pubsub.subscribe(topic)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                self.logger.error("subscriber %s receive error: %r", topic,
                                  exc)
                await asyncio.sleep(1.0)
                continue
            if message is None:
                return
            ctx = Context(message, self.container)
            # continue the publisher's trace when the message carries a
            # traceparent
            from gofr_tpu_torch.trace import extract_traceparent
            remote = extract_traceparent(message.header("traceparent") or "")
            with self.container.tracer.start_span(
                    "pubsub.consume", remote_parent=remote) as span:
                span.set_attribute("topic", topic)
                try:
                    result = handler(ctx)
                    if asyncio.iscoroutine(result):
                        await result
                    message.commit()  # commit on success
                except asyncio.CancelledError:
                    raise
                except Exception as exc:
                    self.logger.error(
                        "subscriber %s handler panicked: %r", topic, exc)

    # -- lifecycle ------------------------------------------------------------
    async def start(self) -> None:
        self._shutdown = asyncio.Event()
        self._register_default_routes()

        for hook in self._startup_hooks:
            result = hook()
            if asyncio.iscoroutine(result):
                await result

        # the shape-only traffic recorder (TRAFFIC_REC_ENABLED, default
        # on), before the batcher so its enqueue hook rides the batcher's
        # constructor; the engine's admission hook attaches here
        from gofr_tpu_torch.tpu.workload import new_traffic_recorder
        self.container.workload = new_traffic_recorder(
            self.config, metrics=self.container.metrics)
        if (self.container.workload is not None
                and self.container.tpu is not None
                and hasattr(self.container.tpu, "attach_workload")):
            self.container.tpu.attach_workload(self.container.workload)

        # the dynamic batcher on the serving loop: concurrent predicts
        # coalesce into one graph replay
        if self.container.tpu is not None:
            from gofr_tpu_torch.tpu import DynamicBatcher
            self.container.tpu_batcher = DynamicBatcher(
                self.container.tpu,
                max_batch=self.config.get_int("TPU_MAX_BATCH", 32),
                max_delay_ms=self.config.get_float("TPU_BATCH_DELAY_MS", 2.0),
                logger=self.logger, tracer=self.container.tracer,
                slo=self.container.slo, metrics=self.container.metrics,
                workload=self.container.workload)

        # FAULT_PLAN installs a seeded fault-injection plan; unset leaves
        # the no-op plan
        from gofr_tpu_torch.tpu import faults
        plan = faults.plan_from_env(metrics=self.container.metrics)
        if plan is not None:
            faults.install(plan)
            self.logger.warn("fault injection ACTIVE: FAULT_PLAN=%r "
                             "(seed %d)", os.environ.get("FAULT_PLAN"),
                             plan.seed)

        # the time-series store and its sampler (TELEMETRY_ENABLED, default
        # on), before the watchdog so it can read the store's anomalies
        from gofr_tpu_torch.metrics.timeseries import new_timeseries
        self.container.telemetry = new_timeseries(
            self.config, slo=self.container.slo, tpu=self.container.tpu,
            container=self.container, metrics=self.container.metrics,
            logger=self.logger)
        if self.container.telemetry is not None:
            if self.container.tpu is not None and \
                    hasattr(self.container.tpu, "attach_telemetry"):
                self.container.tpu.attach_telemetry(
                    self.container.telemetry,
                    every=self.container.telemetry.tick_sample)
            self.container.telemetry.start()

        # the watchdog over the SLO windows (SLO_WATCHDOG_ENABLED), with
        # the brownout ladder the engine enforces
        from gofr_tpu_torch.slo import new_brownout, new_watchdog
        self.container.watchdog = new_watchdog(
            self.config, self.container.slo, metrics=self.container.metrics,
            logger=self.logger,
            ledger=getattr(self.container.tpu, "ledger", None))
        if self.container.watchdog is not None:
            if self.container.telemetry is not None:
                self.container.watchdog.anomaly_fn = \
                    self.container.telemetry.watchdog_reasons
            self.container.watchdog.brownout = new_brownout(
                self.config, self.container.tpu,
                metrics=self.container.metrics, logger=self.logger)

        # the error-budget burn rates over the store: watchdog reasons and
        # the ladder's escalation gate
        from gofr_tpu_torch.slo_budget import new_error_budget
        self.container.slo_budget = new_error_budget(
            self.config, self.container.telemetry, self.container.metrics,
            logger=self.logger)
        if self.container.slo_budget is not None \
                and self.container.watchdog is not None:
            self.container.watchdog.budget_fn = \
                self.container.slo_budget.watchdog_reasons
            if self.container.watchdog.brownout is not None:
                self.container.watchdog.brownout.escalation_gate = \
                    self.container.slo_budget.fast_burning
        if self.container.slo_budget is not None \
                and self.container.tpu is not None \
                and hasattr(self.container.tpu, "stats"):
            self.container.tpu.slo_budget = self.container.slo_budget
        if self.container.watchdog is not None:
            self.container.watchdog.start()

        # the operating-point auto-tuner (AUTOTUNE_ENABLED, default off)
        # as a cron job, after the budget so its fast-burn gate is wired
        from gofr_tpu_torch.tpu.autotune import new_autotuner
        self.container.autotune = new_autotuner(
            self.config, self.container.tpu,
            workload=self.container.workload,
            telemetry=self.container.telemetry,
            metrics=self.container.metrics, logger=self.logger,
            fast_burn_fn=(self.container.slo_budget.fast_burning
                          if self.container.slo_budget is not None
                          else None))
        if self.container.autotune is not None:
            self.add_cron_job(
                self.config.get("AUTOTUNE_CRON") or "* * * * *",
                "autotune", self.container.autotune)

        # the worst-offender ring, on every flight recorder the serving
        # layer has (an engine's, or each of a registry's engines')
        from gofr_tpu_torch.tpu.diagnose import (build_window_context,
                                                 new_offenders)
        tpu = self.container.tpu
        engine = tpu if tpu is not None and hasattr(tpu, "stats") else None
        ledger = getattr(tpu, "ledger", None) if tpu is not None else None
        xledger = getattr(tpu, "exec_ledger", None) if tpu is not None \
            else None
        context_fn = (lambda: build_window_context(
            engine=engine, store=self.container.telemetry,
            ledger=ledger, xledger=xledger))
        self.container.offenders = new_offenders(
            self.config, context_fn=context_fn, logger=self.logger)
        if self.container.offenders is not None and tpu is not None:
            recorders = []
            if getattr(tpu, "recorder", None) is not None:
                recorders.append(tpu.recorder)
            else:
                for entry in (getattr(tpu, "_entries", None) or {}).values():
                    recorder = getattr(entry.engine, "recorder", None)
                    if recorder is not None:
                        recorders.append(recorder)
            for recorder in recorders:
                recorder.offenders = self.container.offenders

        # the batch lane (BATCH_LANE_TOPIC): built here from config unless
        # the app wired one (with its tokenizer's hooks), then started
        if self.container.batch_lane is None \
                and self.config.get("BATCH_LANE_TOPIC") \
                and self.container.pubsub is not None \
                and self.container.tpu is not None \
                and (hasattr(self.container.tpu, "generate")
                     or hasattr(self.container.tpu, "route")):
            from gofr_tpu_torch.tpu.batch_lane import new_batch_lane
            self.container.batch_lane = new_batch_lane(
                self.config, self.container.tpu, self.container)
        if self.container.batch_lane is not None:
            if getattr(self.container.batch_lane, "watchdog", None) is None:
                self.container.batch_lane.watchdog = self.container.watchdog
            await self.container.batch_lane.start()

        self._metrics_server = HTTPServer(
            self._metrics_dispatch, self.metrics_port, logger=self.logger)
        await self._metrics_server.start()

        self._http_server = HTTPServer(
            self._dispatch, self.http_port, logger=self.logger)
        await self._http_server.start()

        if self._grpc_services:
            from gofr_tpu_torch.grpcx.server import GRPCServer
            self._grpc_server = GRPCServer(
                self.container, self.grpc_port, logger=self.logger)
            for spec, servicer in self._grpc_services:
                self._grpc_server.register(spec, servicer)
            await self._grpc_server.start()

        from gofr_tpu_torch.aio import spawn_logged
        for topic, handler in self._subscriptions.items():
            self._tasks.append(spawn_logged(
                self._subscriber_loop(topic, handler), self.logger,
                f"pubsub.subscriber.{topic}",
                metrics=self.container.metrics))

        self.crontab.start()
        self.logger.info("app %s started (http=:%d metrics=:%d%s)",
                         self.container.app_name, self.bound_http_port,
                         self.bound_metrics_port,
                         f" grpc=:{self._grpc_server.bound_port}"
                         if self._grpc_server else "")

    async def stop(self) -> None:
        for hook in self._shutdown_hooks:
            try:
                result = hook()
                if asyncio.iscoroutine(result):
                    await result
            except Exception as exc:
                self.logger.error("shutdown hook failed: %r", exc)
        self.crontab.stop()
        if self.container.batch_lane is not None:
            # stop pulling jobs; generations in flight land first
            await self.container.batch_lane.stop(
                grace_s=self._shutdown_grace)
        if self.container.watchdog is not None:
            await self.container.watchdog.stop()
        if self.container.telemetry is not None:
            await self.container.telemetry.stop()
        for task in self._tasks:
            task.cancel()
        self._tasks.clear()
        if self._http_server is not None:
            await self._http_server.shutdown(drain_grace=self._shutdown_grace)
        if self._metrics_server is not None:
            await self._metrics_server.shutdown()
        if self._grpc_server is not None:
            await self._grpc_server.stop()
        await self.container.close()
        if self._shutdown is not None:
            self._shutdown.set()

    async def serve(self) -> None:
        await self.start()
        loop = asyncio.get_running_loop()
        stop_requested = asyncio.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop_requested.set)
            except (NotImplementedError, RuntimeError):
                pass
        await stop_requested.wait()
        self.logger.info("shutdown signal received")
        await self.stop()

    def run(self) -> Optional[int]:
        """Blocking entry point: serve until SIGINT or SIGTERM. An app
        with CLI commands runs the one argv names instead and returns its
        exit code (0 ok, 1 it raised, 2 no command matched)."""
        if self._cli_commands:
            from gofr_tpu_torch.cli.runner import run_cli
            return run_cli(self)
        try:
            asyncio.run(self.serve())
        except KeyboardInterrupt:
            pass
        return None

    @property
    def bound_http_port(self) -> int:
        return self._http_server.bound_port if self._http_server \
            else self.http_port

    @property
    def bound_metrics_port(self) -> int:
        return self._metrics_server.bound_port if self._metrics_server \
            else self.metrics_port

    @property
    def bound_grpc_port(self) -> Optional[int]:
        return self._grpc_server.bound_port if self._grpc_server else None


async def _error_response(error):
    from gofr_tpu_torch.http.responder import Responder
    return Responder().respond(None, error, "GET")


def new_app(config_dir: str = "./configs", device="cuda") -> App:
    """Server app factory: config from ``<config_dir>/.env`` layers and the
    environment; ``device`` for the app's executor."""
    return App(config=EnvConfig(config_dir), device=device)


def new_cmd(config_dir: str = "./configs", device="cuda") -> App:
    """CLI app factory: with ``CMD_LOGS_FILE`` set the logs go to that
    file, so stdout holds the commands' output alone; ``device`` for the
    app's executor."""
    config = EnvConfig(config_dir)
    log_file = config.get_or_default("CMD_LOGS_FILE", "")
    container = Container.create(
        config, logger=new_file_logger(log_file) if log_file else None,
        device=device)
    return App(config=config, container=container)
