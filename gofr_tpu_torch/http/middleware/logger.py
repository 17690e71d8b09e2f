"""Request logging middleware (a copy of
``gofr_tpu/http/middleware/logger.py``): one structured line a request
with its trace id and microseconds (a stream's when it ends, 500 if its
producer failed), ``X-Correlation-ID``, and last-resort recovery of an
escaped exception as a 500.
"""

from __future__ import annotations

import json
import time

from gofr_tpu_torch.http.router import Middleware, WireHandler
from gofr_tpu_torch.logging import Logger


class RequestLog:
    """Structured request log entry; pretty-printable (logger.go:44-61)."""

    def __init__(self, trace_id: str, method: str, uri: str,
                 status: int, duration_us: int, remote: str):
        self.trace_id = trace_id
        self.method = method
        self.uri = uri
        self.status = status
        self.duration_us = duration_us
        self.remote = remote

    def to_log(self):
        return vars(self)

    def pretty_print(self, writer) -> None:
        color = "\033[32m" if self.status < 400 else (
            "\033[33m" if self.status < 500 else "\033[31m")
        writer.write(
            f"  {color}{self.status}\033[0m {self.method:<7} "
            f"{self.uri} {self.duration_us}µs\n"
        )


def logging_middleware(logger: Logger) -> Middleware:
    def middleware(next_handler: WireHandler) -> WireHandler:
        async def handle(request):
            start = time.perf_counter()
            span = request.context_values.get("span")
            trace_id = span.trace_id if span is not None else ""
            try:
                status, headers, body = await next_handler(request)
            except Exception as exc:  # last-resort panic recovery
                logger.error("panic recovered in handler: %r", exc,
                             method=request.method, uri=request.path)
                status = 500
                headers = {"Content-Type": "application/json"}
                body = json.dumps(
                    {"error": {"message": "some unexpected error has occurred"}}
                ).encode()
            if trace_id:
                headers.setdefault("X-Correlation-ID", trace_id)

            def emit(status: int) -> None:
                duration_us = int((time.perf_counter() - start) * 1e6)
                entry = RequestLog(trace_id, request.method, request.path,
                                   status, duration_us, request.remote_addr)
                if status >= 500:
                    logger.error("request failed", payload=entry)
                else:
                    logger.info("request", payload=entry)

            from gofr_tpu_torch.http.response import StreamBody
            if isinstance(body, StreamBody):
                # log when the stream finishes: true duration, and a 500
                # if the producer died mid-stream
                body.on_complete(
                    lambda ok, messages, status=status:
                        emit(status if ok else 500))
            else:
                emit(status)
            return status, headers, body
        return handle
    return middleware
