"""Distributed tracing (a copy of ``gofr_tpu/trace/tracer.py``): spans,
W3C ``traceparent`` parsing and formatting, the batching export worker,
and its exporters: in memory, console, and Zipkin v2 JSON over HTTP
(``new_tracer(config)``: ``TRACE_EXPORTER`` none|console|zipkin,
``TRACER_URL``).

Spans follow asyncio tasks and threads through a contextvar of the
port's own (``gofr_tpu_torch_span``): a span opened with the JAX
package's tracer is not the port's :func:`current_span`, as the port's
deadline contextvar is not the JAX package's. The engine hands an
explicit ``parent`` to every span it opens on the loop, so only the
submitting coroutine's context matters. A failed Zipkin post is kept
as the tracer's ``export_error`` (the app logs it at close), where JAX's
exporter drops it.
"""

from __future__ import annotations

import contextvars
import json
import queue
import random
import re
import threading
import time
import urllib.request
from typing import Dict, List, Optional

_current: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "gofr_tpu_torch_span", default=None
)

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)

# sentinel telling the export worker to flush its batch and exit
_STOP = object()


def _rand_hex(nbits: int) -> str:
    return f"{random.getrandbits(nbits):0{nbits // 4}x}"


class Span:
    """A single span; use as a context manager.

    ``with tracer.start_span("name"):`` parents subsequent spans in the same
    task/thread automatically (reference analog: otel context propagation).
    """

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start", "end",
                 "attributes", "links", "events", "_tracer", "_token",
                 "status")

    # span events are bounded so a chaos storm (one event per injected
    # fault) can never grow a span without limit
    MAX_EVENTS = 64

    def __init__(self, tracer: Optional["Tracer"], name: str,
                 trace_id: Optional[str] = None, parent_id: Optional[str] = None):
        self.name = name
        self.trace_id = trace_id or _rand_hex(128)
        self.span_id = _rand_hex(64)
        self.parent_id = parent_id
        self.start = time.time()
        self.end: Optional[float] = None
        self.attributes: Dict[str, str] = {}
        self.links: List[Dict[str, str]] = []
        self.events: List[Dict[str, object]] = []
        self.status: str = "OK"
        self._tracer = tracer
        self._token: Optional[contextvars.Token] = None

    def set_attribute(self, key: str, value) -> None:
        self.attributes[str(key)] = str(value)

    def add_link(self, other: "Span") -> None:
        """Link another span (many-to-one causality, e.g. one batched engine
        step serving several requests — OTel span-links analog)."""
        if len(self.links) < self.MAX_EVENTS:
            self.links.append({"trace_id": other.trace_id,
                               "span_id": other.span_id})

    def add_event(self, name: str, **attrs) -> None:
        """Timestamped point annotation inside the span (OTel span-events
        analog) — why a phase stalled, not just that it did. The chaos
        plane stamps fault injections here, the brownout ladder its
        level transitions; past ``MAX_EVENTS`` further events drop
        silently rather than growing the span."""
        if len(self.events) < self.MAX_EVENTS:
            self.events.append({
                "name": str(name),
                "t": time.time(),
                "attributes": {str(k): str(v) for k, v in attrs.items()},
            })

    def find_events(self, name: str) -> List[Dict[str, object]]:
        return [e for e in self.events if e["name"] == name]

    def set_status(self, status: str) -> None:
        self.status = status

    def finish(self) -> None:
        if self.end is not None:
            return
        self.end = time.time()
        if self._token is not None:
            try:
                _current.reset(self._token)
            except ValueError:
                _current.set(None)
            self._token = None
        if self._tracer is not None:
            self._tracer._export(self)

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.status = "ERROR"
            self.set_attribute("error", repr(exc))
        self.finish()


def current_span() -> Optional[Span]:
    return _current.get()


def extract_traceparent(header: Optional[str]) -> Optional[Dict[str, str]]:
    """Parse a W3C ``traceparent`` header → {trace_id, span_id} or None."""
    if not header:
        return None
    match = _TRACEPARENT_RE.match(header.strip().lower())
    if not match:
        return None
    _, trace_id, span_id, _ = match.groups()
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return {"trace_id": trace_id, "span_id": span_id}


def format_traceparent(span: Span) -> str:
    return f"00-{span.trace_id}-{span.span_id}-01"


class _Exporter:
    def export(self, spans: List[Span]) -> None:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class ListExporter(_Exporter):
    """Collects exported spans in memory — test double / flight-recorder
    introspection (``Tracer(exporter=ListExporter())``)."""

    def __init__(self):
        self.spans: List[Span] = []

    def export(self, spans: List[Span]) -> None:
        self.spans.extend(spans)

    def find(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


class _ConsoleExporter(_Exporter):
    def export(self, spans: List[Span]) -> None:
        for span in spans:
            dur_us = int(((span.end or span.start) - span.start) * 1e6)
            print(f"[trace] {span.trace_id} {span.name} {dur_us}us "
                  f"{span.status} {span.attributes}")


class _ZipkinExporter(_Exporter):
    """POST Zipkin v2 JSON spans to ``url``; a failed post raises, so the
    tracer keeps it."""

    def __init__(self, url: str, service_name: str):
        self.url = url
        self.service_name = service_name

    def export(self, spans: List[Span]) -> None:
        body = json.dumps([
            {
                "id": span.span_id,
                "traceId": span.trace_id,
                "parentId": span.parent_id,
                "name": span.name,
                "timestamp": int(span.start * 1e6),
                "duration": int(((span.end or span.start) - span.start) * 1e6),
                "localEndpoint": {"serviceName": self.service_name},
                # span events are Zipkin v2's annotations
                "annotations": [
                    {"timestamp": int(e["t"] * 1e6),
                     "value": "%s %s" % (e["name"], e["attributes"])
                     if e["attributes"] else e["name"]}
                    for e in span.events
                ],
                # Zipkin v2 has no span links: they ride a tag
                "tags": dict(
                    span.attributes, status=span.status,
                    **({"links": ",".join(
                        f"{l['trace_id']}:{l['span_id']}"
                        for l in span.links)} if span.links else {})),
            }
            for span in spans
        ]).encode()
        req = urllib.request.Request(
            self.url, data=body, headers={"Content-Type": "application/json"}
        )
        urllib.request.urlopen(req, timeout=5).close()


class Tracer:
    """Span factory + batching export pipeline. A failed export does not
    stop the worker; the first failure is kept (``export_error``) and
    :meth:`shutdown` raises it, so a lost batch cannot pass unseen.
    """

    def __init__(self, service_name: str = "gofr-tpu",
                 exporter: Optional[_Exporter] = None):
        self.service_name = service_name
        self._exporter = exporter
        self._queue: "queue.Queue[Optional[Span]]" = queue.Queue(maxsize=4096)
        self._worker: Optional[threading.Thread] = None
        self.export_error: Optional[BaseException] = None
        self.dropped = 0     # spans the full queue refused
        if exporter is not None:
            self._worker = threading.Thread(
                target=self._run_worker, name="trace-export", daemon=True
            )
            self._worker.start()

    def start_span(self, name: str,
                   remote_parent: Optional[Dict[str, str]] = None,
                   parent: Optional[Span] = None) -> Span:
        """Start a span. Parent resolution: ``remote_parent`` (a parsed
        ``traceparent``) wins, then an explicit ``parent`` span, then the
        context-local current span. An explicit ``parent`` is how background
        tasks (batcher flushes, engine ticks) attach child spans to a
        request whose contextvar scope they never run under."""
        if remote_parent is not None:
            return Span(self, name, trace_id=remote_parent["trace_id"],
                        parent_id=remote_parent["span_id"])
        if parent is None:
            parent = current_span()
        if parent is not None:
            return Span(self, name, trace_id=parent.trace_id,
                        parent_id=parent.span_id)
        return Span(self, name)

    def _export(self, span: Span) -> None:
        if self._exporter is None:
            return
        try:
            self._queue.put_nowait(span)
        except queue.Full:
            self.dropped += 1

    def _run_worker(self) -> None:
        batch: List[Span] = []
        while True:
            try:
                item = self._queue.get(timeout=1.0)
            except queue.Empty:
                item = None
            stopping = item is _STOP
            span = None if stopping else item
            if span is not None:
                batch.append(span)
            if batch and (span is None or len(batch) >= 128):
                try:
                    self._exporter.export(batch)  # type: ignore[union-attr]
                # a flaky exporter must not kill the span worker; the
                # failure is kept for shutdown() to raise
                except Exception as exc:  # noqa: BLE001
                    if self.export_error is None:
                        self.export_error = exc
                batch = []
            if stopping:
                return

    def shutdown(self, timeout: float = 5.0) -> None:
        """Drain queued spans and export the final batch before closing the
        exporter — spans finished just before shutdown must not be lost.
        Raises the first export failure, if any."""
        if self._exporter is None:
            return
        if self._worker is not None and self._worker.is_alive():
            try:
                self._queue.put_nowait(_STOP)
            except queue.Full:
                pass  # drained inline below
            self._worker.join(timeout=timeout)
            self._worker = None
        # anything still queued (full queue above, dead worker, or spans
        # finished while the worker was stopping) exports inline
        batch: List[Span] = []
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                batch.append(item)
        if batch:
            self._exporter.export(batch)
        self._exporter.shutdown()
        if self.export_error is not None:
            raise self.export_error


def new_tracer(config, logger=None) -> Tracer:
    """Build a tracer from config: ``TRACE_EXPORTER`` none (default),
    console, or zipkin (alias gofr) posting to ``TRACER_URL``."""
    name = config.get_or_default("APP_NAME", "gofr-tpu-app")
    kind = config.get_or_default("TRACE_EXPORTER", "none").lower()
    exporter: Optional[_Exporter] = None
    if kind == "console":
        exporter = _ConsoleExporter()
    elif kind in ("zipkin", "gofr"):
        url = config.get_or_default(
            "TRACER_URL", "http://localhost:9411/api/v2/spans"
        )
        exporter = _ZipkinExporter(url, name)
        if logger is not None:
            logger.info("tracing exporter %s -> %s", kind, url)
    return Tracer(service_name=name, exporter=exporter)
