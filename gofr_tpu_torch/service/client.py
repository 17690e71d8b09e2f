"""Outbound HTTP service client: the inter-service call path (the port's
copy of ``gofr_tpu/service/client.py``).

Verbs Get/Post/Put/Patch/Delete over one send path: a span per call with
the W3C ``traceparent`` injected, the ``app_http_service_response``
histogram, a structured request log; ``health_check`` probes
``/.well-known/alive`` (or the endpoint ``HealthConfig`` sets).

The sync core is stdlib urllib (handlers run in a worker thread, so
blocking IO stays off the event loop); every verb also has an
``a``-prefixed async variant that offloads to the loop's default
executor.
"""

from __future__ import annotations

import asyncio
import json as jsonlib
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, Optional

from gofr_tpu_torch.trace.tracer import format_traceparent


class ServiceResponse:
    def __init__(self, status_code: int, headers: Dict[str, str],
                 body: bytes):
        self.status_code = status_code
        self.headers = headers
        self.body = body

    def json(self) -> Any:
        return jsonlib.loads(self.body.decode() or "null")

    @property
    def ok(self) -> bool:
        return 200 <= self.status_code < 300


class ServiceError(Exception):
    """Transport-level failure (connection refused, DNS, timeout)."""


class HTTPService:
    """Plain client; decorators (auth, circuit breaker, headers) wrap it
    (``options.Option``)."""

    def __init__(self, base_url: str, logger=None, metrics=None,
                 tracer=None, timeout: float = 30.0,
                 service_name: str = ""):
        self.base_url = base_url.rstrip("/")
        self.logger = logger
        self.metrics = metrics
        self.tracer = tracer
        self.timeout = timeout
        self.service_name = service_name or self.base_url

    # -- verbs --------------------------------------------------------------
    def get(self, path: str, params: Optional[Dict] = None,
            headers: Optional[Dict] = None) -> ServiceResponse:
        return self.request("GET", path, params=params, headers=headers)

    def post(self, path: str, params: Optional[Dict] = None,
             body: Any = None, headers: Optional[Dict] = None):
        return self.request("POST", path, params=params, body=body,
                            headers=headers)

    def put(self, path: str, params: Optional[Dict] = None, body: Any = None,
            headers: Optional[Dict] = None):
        return self.request("PUT", path, params=params, body=body,
                            headers=headers)

    def patch(self, path: str, params: Optional[Dict] = None,
              body: Any = None, headers: Optional[Dict] = None):
        return self.request("PATCH", path, params=params, body=body,
                            headers=headers)

    def delete(self, path: str, body: Any = None,
               headers: Optional[Dict] = None):
        return self.request("DELETE", path, body=body, headers=headers)

    # async variants (offloaded; the event loop never blocks)
    async def aget(self, path: str, params=None, headers=None):
        return await self._offload(self.get, path, params, headers)

    async def apost(self, path: str, params=None, body=None, headers=None):
        return await self._offload(self.post, path, params, body, headers)

    async def aput(self, path: str, params=None, body=None, headers=None):
        return await self._offload(self.put, path, params, body, headers)

    async def apatch(self, path: str, params=None, body=None, headers=None):
        return await self._offload(self.patch, path, params, body, headers)

    async def adelete(self, path: str, body=None, headers=None):
        return await self._offload(self.delete, path, body, headers)

    async def _offload(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(
            None, fn, *args)

    # -- the one send path --------------------------------------------------
    def request(self, method: str, path: str, params: Optional[Dict] = None,
                body: Any = None,
                headers: Optional[Dict] = None) -> ServiceResponse:
        url = f"{self.base_url}/{path.lstrip('/')}" if path else self.base_url
        if params:
            url += ("&" if "?" in url else "?") + urllib.parse.urlencode(
                params, doseq=True)
        send_headers = dict(headers or {})
        data: Optional[bytes] = None
        if body is not None:
            if isinstance(body, (bytes, bytearray)):
                data = bytes(body)
            else:
                data = jsonlib.dumps(body).encode()
                send_headers.setdefault("Content-Type", "application/json")

        span = None
        if self.tracer is not None:
            span = self.tracer.start_span(
                f"http-service {method} {self.service_name}")
            span.set_attribute("http.url", url)
            send_headers.setdefault("traceparent", format_traceparent(span))

        start = time.perf_counter()
        try:
            request = urllib.request.Request(url, data=data, method=method,
                                             headers=send_headers)
            try:
                with urllib.request.urlopen(request,
                                            timeout=self.timeout) as resp:
                    response = ServiceResponse(resp.status,
                                               dict(resp.headers),
                                               resp.read())
            except urllib.error.HTTPError as exc:  # non-2xx still a response
                response = ServiceResponse(exc.code, dict(exc.headers or {}),
                                           exc.read())
        except Exception as exc:
            elapsed = time.perf_counter() - start
            self._observe(method, url, None, elapsed)
            if span is not None:
                span.set_status("ERROR")
                span.finish()
            raise ServiceError(f"{method} {url}: {exc}") from exc

        elapsed = time.perf_counter() - start
        self._observe(method, url, response.status_code, elapsed)
        if span is not None:
            span.set_attribute("http.status_code", response.status_code)
            span.finish()
        return response

    def _observe(self, method: str, url: str, status: Optional[int],
                 elapsed: float) -> None:
        if self.metrics is not None:
            self.metrics.record_histogram(
                "app_http_service_response", elapsed, service=self.service_name,
                method=method, status=str(status or "error"))
        if self.logger is not None:
            log = self.logger.error if (status is None or status >= 500) \
                else self.logger.info
            log("HTTP %s %s -> %s in %.1fms", method, url,
                status if status is not None else "ERR", elapsed * 1e3,
                service=self.service_name)

    # -- health -------------------------------------------------------------
    health_endpoint = ".well-known/alive"

    def health_check(self) -> Dict[str, Any]:
        try:
            response = self.get(self.health_endpoint)
            status = "UP" if response.ok else "DOWN"
            return {"status": status,
                    "details": {"host": self.base_url,
                                "code": response.status_code}}
        except Exception as exc:
            return {"status": "DOWN",
                    "details": {"host": self.base_url, "error": repr(exc)}}
