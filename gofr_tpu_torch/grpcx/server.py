"""gRPC transport on ``grpc.aio``, sharing the app's event loop (a copy of
``gofr_tpu/grpcx/server.py``): protoc-generated services, and dynamic
JSON unary and server-streaming methods (``/gofr.<Service>/<method>``)
whose handlers take a normal Context, behind a logging interceptor that
times every RPC shape in ``app_http_service_response``
(``service="grpc"``, status OK | ERROR | CANCELLED).

``grpc`` is imported only when a service starts: a host without
``grpcio`` imports this module, and :func:`grpc_available` says whether
a server can start there.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from gofr_tpu_torch.context import Context


def grpc_available() -> bool:
    """Whether ``grpc`` imports on this host."""
    import importlib.util
    return importlib.util.find_spec("grpc") is not None


class GRPCRequest:
    """Transport-agnostic Request over a JSON unary payload."""

    def __init__(self, payload: Any, service: str, method: str,
                 metadata: Dict[str, str]):
        self.payload = payload if isinstance(payload, dict) else {}
        self._raw = payload
        self.service = service
        self.method_name = method
        self.metadata = metadata

    def param(self, key: str) -> str:
        value = self.payload.get(key, "")
        return "" if value is None else str(value)

    def params(self, key: str) -> List[str]:
        value = self.payload.get(key)
        if isinstance(value, list):
            return [str(v) for v in value]
        return [str(value)] if value is not None else []

    def path_param(self, key: str) -> str:
        return self.param(key)

    def bind(self, target: Any = None) -> Any:
        if target is None:
            return self._raw
        if isinstance(self._raw, dict):
            return target(**self._raw)
        return self._raw

    def header(self, key: str) -> str:
        return self.metadata.get(key.lower(), "")

    @property
    def method(self) -> str:
        return "GRPC"

    @property
    def path(self) -> str:
        return f"/{self.service}/{self.method_name}"


def _interceptor_class():
    """The logging interceptor's class, built at the first server start:
    ``grpc`` is imported only when a gRPC service is started."""
    global _INTERCEPTOR
    if _INTERCEPTOR is not None:
        return _INTERCEPTOR
    import grpc

    class _LoggingInterceptor(grpc.aio.ServerInterceptor):
        """Per-RPC log + latency (parity: grpc/log.go:59 LoggingInterceptor).

        Wraps all four RPC shapes with the same latency histogram
        (server-streaming/bidi timed from call to stream exhaustion with the
        outbound message count; client-streaming counts inbound messages),
        labeling failures status=ERROR and client deadline-expiry/
        disconnects status=CANCELLED, so error rate and error latency are
        visible, not just successes: no RPC shape bypasses
        observability."""

        def __init__(self, logger, metrics):
            self.logger = logger
            self.metrics = metrics

        def _observe(self, method: str, start: float, status: str,
                     messages: Optional[int] = None) -> None:
            elapsed = time.perf_counter() - start
            if messages is None:
                self.logger.info("gRPC %s %s in %.2fms", method,
                                 status.lower(), elapsed * 1e3)
            else:
                self.logger.info("gRPC %s %s in %.2fms (%d messages)", method,
                                 status.lower(), elapsed * 1e3, messages)
            self.metrics.record_histogram("app_http_service_response", elapsed,
                                          service="grpc", method=method,
                                          status=status)

        async def intercept_service(self, continuation, handler_call_details):
            handler = await continuation(handler_call_details)
            if handler is None:
                return handler
            method = handler_call_details.method
            logger = self.logger

            if handler.unary_unary is not None:
                inner = handler.unary_unary

                async def unary_wrapper(request, context):
                    start = time.perf_counter()
                    try:
                        response = await inner(request, context)
                        self._observe(method, start, "OK")
                        return response
                    except asyncio.CancelledError:
                        # client deadline/disconnect: the most common failure
                        # class under load-shedding must not vanish from the
                        # histogram
                        self._observe(method, start, "CANCELLED")
                        raise
                    except Exception as exc:
                        logger.error("gRPC %s failed: %r", method, exc)
                        self._observe(method, start, "ERROR")
                        raise

                return grpc.unary_unary_rpc_method_handler(
                    unary_wrapper,
                    request_deserializer=handler.request_deserializer,
                    response_serializer=handler.response_serializer)

            if handler.unary_stream is not None:
                inner_stream = handler.unary_stream

                async def stream_wrapper(request, context):
                    start = time.perf_counter()
                    count = 0
                    try:
                        result = inner_stream(request, context)
                        if hasattr(result, "__aiter__"):
                            async for item in result:
                                count += 1
                                yield item
                        else:
                            await result   # handler streamed via context.write
                        self._observe(method, start, "OK", messages=count)
                    except (asyncio.CancelledError, GeneratorExit):
                        self._observe(method, start, "CANCELLED",
                                      messages=count)
                        raise
                    except Exception as exc:
                        logger.error("gRPC %s failed after %d messages: %r",
                                     method, count, exc)
                        self._observe(method, start, "ERROR", messages=count)
                        raise

                return grpc.unary_stream_rpc_method_handler(
                    stream_wrapper,
                    request_deserializer=handler.request_deserializer,
                    response_serializer=handler.response_serializer)

            if handler.stream_unary is not None:
                inner_su = handler.stream_unary

                async def stream_unary_wrapper(request_iterator, context):
                    start = time.perf_counter()
                    received = [0]

                    async def counted():
                        async for item in request_iterator:
                            received[0] += 1
                            yield item

                    try:
                        response = await inner_su(counted(), context)
                        self._observe(method, start, "OK",
                                      messages=received[0])
                        return response
                    except asyncio.CancelledError:
                        self._observe(method, start, "CANCELLED",
                                      messages=received[0])
                        raise
                    except Exception as exc:
                        logger.error("gRPC %s failed after %d messages: %r",
                                     method, received[0], exc)
                        self._observe(method, start, "ERROR",
                                      messages=received[0])
                        raise

                return grpc.stream_unary_rpc_method_handler(
                    stream_unary_wrapper,
                    request_deserializer=handler.request_deserializer,
                    response_serializer=handler.response_serializer)

            if handler.stream_stream is not None:
                inner_ss = handler.stream_stream

                async def stream_stream_wrapper(request_iterator, context):
                    start = time.perf_counter()
                    count = 0
                    try:
                        result = inner_ss(request_iterator, context)
                        if hasattr(result, "__aiter__"):
                            async for item in result:
                                count += 1
                                yield item
                        else:
                            await result
                        self._observe(method, start, "OK", messages=count)
                    except (asyncio.CancelledError, GeneratorExit):
                        self._observe(method, start, "CANCELLED",
                                      messages=count)
                        raise
                    except Exception as exc:
                        logger.error("gRPC %s failed after %d messages: %r",
                                     method, count, exc)
                        self._observe(method, start, "ERROR", messages=count)
                        raise

                return grpc.stream_stream_rpc_method_handler(
                    stream_stream_wrapper,
                    request_deserializer=handler.request_deserializer,
                    response_serializer=handler.response_serializer)

            return handler

    _INTERCEPTOR = _LoggingInterceptor
    return _INTERCEPTOR


_INTERCEPTOR = None


class GRPCServer:
    def __init__(self, container, port: int, logger=None,
                 host: str = "0.0.0.0"):
        self.container = container
        self.port = port
        self.host = host
        self.logger = logger or container.logger
        self._dynamic: Dict[str, Dict[str, Callable]] = {}
        self._protoc: List[Tuple[Callable, Any]] = []
        self._server = None
        self.bound_port: int = port

    def register(self, spec, servicer) -> None:
        if isinstance(spec, tuple) and spec \
                and spec[0] in ("dynamic", "dynamic_stream"):
            kind, service, method = spec
            self._dynamic.setdefault(service, {})[method] = (
                servicer, kind == "dynamic_stream")
        else:
            self._protoc.append((spec, servicer))

    def _dynamic_handler(self, service: str,
                         methods: Dict[str, Tuple[Callable, bool]]):
        import grpc

        container = self.container

        def make_ctx(request_bytes, context, method_name):
            payload = json.loads(request_bytes or b"null")
            metadata = {k: v for k, v in
                        (context.invocation_metadata() or [])}
            return Context(GRPCRequest(payload, service, method_name,
                                       metadata), container)

        def make(method_name: str, handler: Callable):
            async def unary(request_bytes: bytes, context) -> bytes:
                try:
                    ctx = make_ctx(request_bytes, context, method_name)
                except json.JSONDecodeError:
                    await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                        "body is not valid JSON")
                try:
                    result = handler(ctx)
                    if asyncio.iscoroutine(result):
                        result = await result
                except Exception as exc:  # panic isolation (grpc.go:23-25)
                    container.logger.error("gRPC handler panic: %r", exc)
                    await context.abort(grpc.StatusCode.INTERNAL, str(exc))
                from gofr_tpu_torch.http.responder import _jsonable
                return json.dumps({"data": _jsonable(result)},
                                  default=str).encode()

            return grpc.unary_unary_rpc_method_handler(unary)

        def make_stream(method_name: str, handler: Callable):
            """Server-streaming JSON RPC: the handler returns an async
            iterator (async generator) of payloads; each is sent as its
            own ``{"data": ...}`` message: the token-streaming surface."""
            async def stream(request_bytes: bytes, context):
                try:
                    ctx = make_ctx(request_bytes, context, method_name)
                except json.JSONDecodeError:
                    await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                        "body is not valid JSON")
                from gofr_tpu_torch.http.responder import _jsonable
                try:
                    result = handler(ctx)
                    if asyncio.iscoroutine(result):
                        result = await result
                except Exception as exc:
                    # pre-stream failure (validation/admission): client
                    # errors map to INVALID_ARGUMENT, the rest to INTERNAL
                    try:
                        status = int(getattr(exc, "status_code", 500))
                    except (TypeError, ValueError):
                        status = 500
                    code = (grpc.StatusCode.INVALID_ARGUMENT
                            if 400 <= status < 500
                            else grpc.StatusCode.INTERNAL)
                    container.logger.error("gRPC stream handler error: %r",
                                           exc)
                    await context.abort(code, str(exc))
                try:
                    async for item in result:
                        yield json.dumps({"data": _jsonable(item)},
                                         default=str).encode()
                except Exception as exc:  # panic isolation
                    container.logger.error("gRPC stream handler panic: %r",
                                           exc)
                    await context.abort(grpc.StatusCode.INTERNAL, str(exc))

            return grpc.unary_stream_rpc_method_handler(stream)

        handlers = {
            name: (make_stream(name, fn) if streaming else make(name, fn))
            for name, (fn, streaming) in methods.items()}
        return grpc.method_handlers_generic_handler(f"gofr.{service}",
                                                    handlers)

    async def start(self) -> None:
        import grpc

        self._server = grpc.aio.server(
            interceptors=[_interceptor_class()(self.logger,
                                               self.container.metrics)])
        for register_fn, servicer in self._protoc:
            register_fn(servicer, self._server)
        for service, methods in self._dynamic.items():
            self._server.add_generic_rpc_handlers(
                (self._dynamic_handler(service, methods),))
        self.bound_port = self._server.add_insecure_port(
            f"{self.host}:{self.port}")
        await self._server.start()
        self.logger.info("gRPC server listening on %s:%d", self.host,
                         self.bound_port)

    async def stop(self, grace: float = 1.0) -> None:
        if self._server is not None:
            await self._server.stop(grace)
            self._server = None
