"""Context — the per-request object handed to every handler (a copy of
``gofr_tpu/context.py``): the transport-agnostic request, the container
and a responder, so a handler is the same behind HTTP, gRPC, pub/sub or
cron. ``ctx.predict`` goes through the port's ``DynamicBatcher``.
"""

from __future__ import annotations

from typing import Any, List


class Context:
    __slots__ = ("request", "container", "responder", "_span_stack")

    def __init__(self, request: Any, container: Any, responder: Any = None):
        self.request = request
        self.container = container
        self.responder = responder
        self._span_stack: List[Any] = []

    # -- request passthrough (reference: context embeds Request) ----------
    def param(self, key: str) -> str:
        return self.request.param(key)

    def params(self, key: str) -> List[str]:
        getter = getattr(self.request, "params", None)
        return getter(key) if getter else []

    def path_param(self, key: str) -> str:
        return self.request.path_param(key)

    def bind(self, target: Any = None) -> Any:
        """Decode the request body (context.go:57-59)."""
        return self.request.bind(target)

    def header(self, key: str) -> str:
        getter = getattr(self.request, "header", None)
        return getter(key) if getter else ""

    # -- container accessors -----------------------------------------------
    @property
    def logger(self):
        return self.container.logger

    @property
    def metrics(self):
        return self.container.metrics

    @property
    def config(self):
        return self.container.config

    @property
    def sql(self):
        return self.container.sql

    @property
    def redis(self):
        return self.container.redis

    @property
    def mongo(self):
        return self.container.mongo

    @property
    def cassandra(self):
        return self.container.cassandra

    @property
    def clickhouse(self):
        return self.container.clickhouse

    @property
    def pubsub(self):
        return self.container.pubsub

    @property
    def tpu(self):
        """The serving datasource: the executor, an engine or a registry
        (``ctx.tpu.predict()``)."""
        return self.container.tpu

    async def predict(self, model: str, example):
        """Predict for ONE example through the app's dynamic batcher (the
        concurrent requests of a flush share one graph replay); without a
        batcher (cron contexts) one direct executor call of a batch of
        one."""
        batcher = getattr(self.container, "tpu_batcher", None)
        if batcher is not None:
            return await batcher.predict(model, example)
        import asyncio

        import numpy as np

        from gofr_tpu_torch.utils.tree import tree_map

        def _direct():
            # off the loop: executor.predict waits for the device
            batch = tree_map(lambda l: np.asarray(l)[None], example)
            result = self.container.tpu.predict(model, batch)
            return tree_map(lambda l: np.asarray(l)[0], result)

        return await asyncio.get_running_loop().run_in_executor(
            None, _direct)

    @property
    def file(self):
        return self.container.file

    def get_http_service(self, name: str):
        """Named outbound HTTP service (container/container.go:150-152)."""
        return self.container.get_http_service(name)

    def publish(self, topic: str, payload: bytes) -> None:
        """Publish to the configured pub/sub backend."""
        self.container.pubsub.publish(topic, payload)

    # -- logging sugar ------------------------------------------------------
    def log(self, message: str, *args, **fields) -> None:
        self.container.logger.info(message, *args, **fields)

    # -- tracing (context.go:45-55) -----------------------------------------
    def trace(self, name: str):
        """Open a user span: ``with ctx.trace("work"):``"""
        return self.container.tracer.start_span(name)

    # -- websocket passthrough ----------------------------------------------
    async def read_message(self) -> Any:
        reader = getattr(self.request, "read_message", None)
        if reader is None:
            raise TypeError("context request is not a websocket connection")
        return await reader()

    async def write_message(self, data: Any) -> None:
        writer = getattr(self.request, "write_message", None)
        if writer is None:
            raise TypeError("context request is not a websocket connection")
        await writer(data)
