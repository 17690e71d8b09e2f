"""Metrics middleware (a copy of
``gofr_tpu/http/middleware/metrics.py``): ``app_http_response`` by route
template, method and status (a stream's at its end, 500 if its producer
failed; an escaped exception as 500), and ``app_http_inflight``.
"""

from __future__ import annotations

import time

from gofr_tpu_torch.http.router import Middleware, WireHandler
from gofr_tpu_torch.metrics import Manager


def metrics_middleware(manager: Manager) -> Middleware:
    def middleware(next_handler: WireHandler) -> WireHandler:
        async def handle(request):
            start = time.perf_counter()
            # label by the matched route template, never the raw path: a
            # path with an embedded id (/debug/tracez/{trace_id}) would
            # mint one time series per request; unmatched paths
            # collapse into one bucket for the same reason
            route = getattr(request, "route", "") or "unmatched"
            manager.delta_updown_counter("app_http_inflight", 1.0)
            inflight_open = True

            def settle() -> None:
                nonlocal inflight_open
                if inflight_open:
                    inflight_open = False
                    manager.delta_updown_counter("app_http_inflight", -1.0)

            try:
                status, headers, body = await next_handler(request)
            except Exception:
                # the handler layer normally converts failures to a 500
                # response; anything escaping past it would otherwise
                # never reach the histogram
                manager.record_histogram(
                    "app_http_response", time.perf_counter() - start,
                    path=route, method=request.method, status="500")
                settle()
                raise
            from gofr_tpu_torch.http.response import StreamBody
            if isinstance(body, StreamBody):
                # a stream's latency is its full production time, and a
                # producer failure mid-stream is a 500, not the header
                # status — observe at completion instead of header time
                def observe(ok: bool, messages: int,
                            status=status) -> None:
                    manager.record_histogram(
                        "app_http_response", time.perf_counter() - start,
                        path=route, method=request.method,
                        status=str(status if ok else 500))
                    settle()

                body.on_complete(observe)
            else:
                manager.record_histogram(
                    "app_http_response", time.perf_counter() - start,
                    path=route, method=request.method,
                    status=str(status),
                )
                settle()
            return status, headers, body
        return handle
    return middleware
