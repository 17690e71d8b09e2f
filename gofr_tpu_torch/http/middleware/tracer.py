"""Tracing middleware (a copy of
``gofr_tpu/http/middleware/tracer.py``): a ``"METHOD /path"`` span of the
port's tracer, parented on the incoming ``traceparent``, open while the
handler runs, so the engine's ``current_span()`` sees the request; the
response carries its ``X-Trace-Id``.
"""

from __future__ import annotations

from gofr_tpu_torch.http.router import Middleware, WireHandler
from gofr_tpu_torch.trace import Tracer, extract_traceparent


def tracing_middleware(tracer: Tracer) -> Middleware:
    def middleware(next_handler: WireHandler) -> WireHandler:
        async def handle(request):
            remote = extract_traceparent(request.headers.get("traceparent"))
            span = tracer.start_span(
                f"{request.method} {request.path}", remote_parent=remote
            )
            with span:
                span.set_attribute("http.method", request.method)
                span.set_attribute("http.target", request.path)
                request.context_values["span"] = span
                status, headers, body = await next_handler(request)
                span.set_attribute("http.status_code", status)
                if status >= 500:
                    span.set_status("ERROR")
                # clients/operators can join logs, exemplars, and the
                # flight recorder on this id without parsing traceparent
                headers = dict(headers or {})
                headers.setdefault("X-Trace-Id", span.trace_id)
                return status, headers, body
        return handle
    return middleware
