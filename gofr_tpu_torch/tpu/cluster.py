"""Disaggregated serving cluster: replica roles, routing, KV handoff (a
copy of ``gofr_tpu/tpu/cluster.py`` over the port's engines, with both
of its transports; ``tpu/fleet`` builds the fleet router on it).

Prefill is compute-bound (one big prompt forward),
decode is memory-bound (thousands of small batched steps); a monolithic
replica sizes both phases with one knob. This module lets them live on
*different replicas*, each tuned to its own batch operating point (the
batch-size/latency tradeoff study in PAPERS.md, arxiv 1812.11731):

- **Roles** — every replica serves as ``prefill``, ``decode``, or
  ``both``. A ``both`` replica is a valid target for either phase, so a
  cluster degrades gracefully to monolithic serving.
- **ClusterRegistry** — names replicas, tracks READY/DRAINING state and
  router-level in-flight counts, and picks targets round-robin per role,
  skipping DRAINING replicas and peers whose circuit is open (a
  transport whose ``available()`` is False). ``drain`` stops new routing
  and waits for in-flight streams; a drained in-proc replica's page-pool
  free list returns to its idle level because migrated requests release
  pages through the engine's normal slot teardown.
- **DisaggRouter** — the request front-end: dispatches the prompt to a
  prefill replica (one ``prefill_export``), ships the packed
  :mod:`~gofr_tpu_torch.tpu.kv_wire` payload to a decode replica
  (``adopt_kv``), and relays the decode replica's token stream. The
  W3C ``traceparent`` rides both hops, so the prefill span, the
  ``kv_transfer`` span (bytes shipped, transport kind), and the decode
  spans land in ONE trace.
- **Transports** — :class:`InProcTransport` (same-process engines; the
  payload still round-trips ``pack``/``iter_chunks``/``unpack`` so the
  tests exercise the exact wire path), and :class:`HTTPTransport` (remote
  peers over ``service/client.py`` + circuit breaker, KV chunks fetched
  over a ``gofr.Disagg/fetch`` gRPC server-stream when the peer
  advertises a gRPC target, plain HTTP fetch as the fallback).

The decode replica admits migrated KV as page-table entries — zero
prefill dispatches (``stats()["prefill_bucket_tokens"]`` does not move),
which is the property the tier-1 disagg tests assert.
"""

from __future__ import annotations

import asyncio
import base64
import json
import os
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

from gofr_tpu_torch.tpu import faults, kv_wire
from gofr_tpu_torch.tpu.registry import (STATE_DRAINING, STATE_READY,
                                         _STATE_GAUGE)
from gofr_tpu_torch.tpu.retry import RetryBudgetExceeded, RetryPolicy
from gofr_tpu_torch.trace import current_span
from gofr_tpu_torch.trace.tracer import format_traceparent

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_BOTH = "both"
ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_BOTH)

__all__ = [
    "ROLE_PREFILL", "ROLE_DECODE", "ROLE_BOTH", "ROLES",
    "NoReplicaAvailable", "HandoffExpired", "HandoffTable",
    "InProcTransport", "HTTPTransport", "ClusterRegistry",
    "DisaggRouter", "parse_peers",
]


class NoReplicaAvailable(RuntimeError):
    """No READY replica serves the requested role (all draining, circuit
    open, or none registered). 503 semantics for the HTTP layer."""

    status_code = 503

    def __init__(self, role: str):
        super().__init__(f"no READY replica serves role {role!r}")
        self.role = role


class HandoffExpired(KeyError):
    """The handoff id WAS valid but its TTL lapsed before pickup. 410
    semantics for the HTTP layer — distinct from a never-issued id so a
    slow router sees "you were too late", not a generic miss."""

    status_code = 410

    def __init__(self, handoff: str):
        super().__init__(f"handoff {handoff!r} expired before pickup")
        self.handoff = handoff


def parse_peers(spec: Optional[str]) -> List[Tuple[str, str, str,
                                                   Optional[str]]]:
    """Parse the ``CLUSTER_PEERS`` knob: comma-separated
    ``name=role@base_url`` entries, each optionally suffixed
    ``#grpc_host:port`` to advertise the peer's gRPC endpoint for
    chunked KV fetch, e.g.::

        p0=prefill@http://10.0.0.1:8000#10.0.0.1:9000,d0=decode@http://10.0.0.2:8000

    Malformed entries raise ``ValueError`` — a typo'd cluster topology
    must fail at startup, not route traffic into the void."""
    peers: List[Tuple[str, str, str, Optional[str]]] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, rest = part.partition("=")
        role, at, url = rest.partition("@")
        if not eq or not at or not name or not url:
            raise ValueError(
                f"CLUSTER_PEERS entry {part!r}: expected name=role@url")
        role = role.strip().lower()
        if role not in ROLES:
            raise ValueError(
                f"CLUSTER_PEERS entry {part!r}: role must be one of "
                f"{ROLES}")
        url, _, grpc_target = url.partition("#")
        peers.append((name.strip(), role, url.strip(),
                      grpc_target.strip() or None))
    return peers


class HandoffTable:
    """Bounded TTL store of packed KV payloads awaiting pickup on a
    prefill replica. The prefill HTTP response carries only the handoff
    id + byte count; the (potentially large) blob travels over the
    chunked fetch stream. Entries expire so an abandoned handoff (router
    died between prefill and fetch) cannot pin host memory."""

    def __init__(self, capacity: int = 64, ttl_s: float = 120.0,
                 logger=None, metrics=None):
        self.capacity = int(capacity)
        self.ttl_s = float(ttl_s)
        self.logger = logger
        self.metrics = metrics
        self._entries: Dict[str, Tuple[float, bytes]] = {}
        # ids that aged out recently, so an adopting replica arriving late
        # gets the precise "expired" answer instead of "unknown" (bounded:
        # ids are 16 hex chars, not blobs)
        self._expired: "deque[str]" = deque(maxlen=256)
        self._expired_total = 0

    def put(self, blob: bytes) -> str:
        self._sweep()
        while len(self._entries) >= self.capacity:
            oldest = min(self._entries, key=lambda k: self._entries[k][0])
            self._drop(oldest, "evicted")
        handoff = os.urandom(8).hex()
        # pack() already produced owned bytes — re-copying a multi-MB KV
        # blob here would double the handoff's host-memory footprint
        owned = blob if isinstance(blob, bytes) else bytes(blob)
        self._entries[handoff] = (time.monotonic(), owned)
        return handoff

    def get(self, handoff: str) -> bytes:
        self._sweep()
        entry = self._entries.get(handoff)
        if entry is None:
            if handoff in self._expired:
                raise HandoffExpired(handoff)
            raise KeyError(f"unknown handoff {handoff!r}")
        return entry[1]

    def pop(self, handoff: str) -> None:
        self._entries.pop(handoff, None)

    def _drop(self, handoff: str, why: str) -> None:
        at, blob = self._entries.pop(handoff)
        self._expired.append(handoff)
        self._expired_total += 1
        if self.logger is not None:
            self.logger.warn(
                "disagg: handoff %s %s after %.1fs unclaimed (%d bytes "
                "dropped)", handoff, why, time.monotonic() - at, len(blob))
        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_tpu_kv_handoff_expired_total", reason=why)

    def _sweep(self) -> None:
        cutoff = time.monotonic() - self.ttl_s
        for key in [k for k, (at, _) in self._entries.items()
                    if at < cutoff]:
            self._drop(key, "expired")

    def stats(self) -> Dict[str, Any]:
        return {"entries": len(self._entries),
                "bytes": sum(len(b) for _, b in self._entries.values()),
                "expired_total": self._expired_total}

    def __len__(self) -> int:
        return len(self._entries)


class InProcTransport:
    """Same-process replica (one engine per role inside one container —
    the CI/smoke topology, and the building block for tests). The
    payload still runs the full ``pack → iter_chunks → assemble →
    unpack`` pipeline so the in-proc path exercises byte-identical wire
    framing; only sockets are skipped."""

    kind = "inproc"

    def __init__(self, engine, chunk_bytes: Optional[int] = None):
        self.engine = engine
        # None resolves the validated KV_WIRE_CHUNK_BYTES knob
        self.chunk_bytes = kv_wire.resolve_chunk_bytes(chunk_bytes)

    def available(self) -> bool:
        return True

    async def prefill(self, prompt_ids, sampling,
                      traceparent: Optional[str] = None) -> bytes:
        payload = await self.engine.prefill_export(
            prompt_ids, sampling=sampling, traceparent=traceparent)
        # chaos site transport_prefill: the work succeeded but the reply
        # is lost — the router's retry leg must treat prefill as
        # idempotent and simply redo it on another (or the same) replica
        faults.active().raise_if("transport_prefill")
        loop = asyncio.get_running_loop()
        blob = await loop.run_in_executor(None, kv_wire.pack, payload)
        return kv_wire.assemble(
            kv_wire.iter_chunks(blob, self.chunk_bytes))

    async def adopt(self, blob: bytes, max_new_tokens: int,
                    eos_id: Optional[int], sampling,
                    traceparent: Optional[str] = None,
                    submitted_at: Optional[float] = None,
                    transfer_s: float = 0.0,
                    dedupe: Optional[str] = None):
        # chaos site crash_mid_transfer: the replica dies while the blob
        # is in flight — the adopt never lands, no slot is claimed
        faults.active().raise_if("crash_mid_transfer")
        loop = asyncio.get_running_loop()
        # the unpack is the in-proc leg's share of the wire cost; fold it
        # into the transfer figure the decode record reports
        unpack_started = time.perf_counter()
        payload = await loop.run_in_executor(None, kv_wire.unpack, blob)
        transfer_s += time.perf_counter() - unpack_started
        return await self.engine.adopt_kv(
            payload, max_new_tokens, eos_id=eos_id, sampling=sampling,
            submitted_at=submitted_at, traceparent=traceparent,
            transfer_s=transfer_s, transfer_bytes=len(blob),
            dedupe=dedupe)

    async def adopt_session(self, blob: bytes, state: Dict[str, Any],
                            traceparent: Optional[str] = None,
                            transfer_s: float = 0.0,
                            dedupe: Optional[str] = None):
        """Adopt a live decode session snapshot: same wire
        pipeline as ``adopt``, but the engine resumes decoding mid-stream
        — no first-token re-publish, remaining budget and sampling state
        come from the exporter's ``state`` dict."""
        loop = asyncio.get_running_loop()
        unpack_started = time.perf_counter()
        payload = await loop.run_in_executor(None, kv_wire.unpack, blob)
        transfer_s += time.perf_counter() - unpack_started
        from gofr_tpu_torch.tpu.generate import Sampling
        sampling = Sampling(
            temperature=float(state.get("temperature", 0.0)),
            top_k=int(state.get("top_k", 0)),
            top_p=float(state.get("top_p", 1.0)))
        return await self.engine.adopt_session(
            payload, int(state["remaining"]),
            eos_id=state.get("eos_id"), sampling=sampling,
            submitted_at=state.get("submitted_at"),
            traceparent=traceparent, transfer_s=transfer_s,
            transfer_bytes=len(blob), dedupe=dedupe)

    async def observe(self) -> Dict[str, Any]:
        """One clusterz probe: the replica's engine stats + SLO view.
        In-proc, so this is a plain snapshot — no sockets, no awaits on
        the serving loop."""
        engine = self.engine
        out: Dict[str, Any] = {"kind": self.kind,
                               "model": getattr(engine, "model_name", None),
                               "stats": engine.stats()}
        health = engine.health_check()
        out["health"] = health.get("status", "UNKNOWN")
        slo = getattr(engine, "slo", None)
        if slo is not None:
            out["slo"] = slo.snapshot()
        # error-budget burn rollup: App.start attaches the
        # ErrorBudgetPlane here the same way it attaches telemetry, so
        # the fleet view lifts burn rates without a second HTTP hop
        # (a failing plane raises, as every seam of the port does)
        plane = getattr(engine, "slo_budget", None)
        if plane is not None:
            out["slo_budget"] = plane.statusz()
        digest_fn = getattr(engine, "prefix_digest", None)
        if digest_fn is not None:
            # fleet routing (tpu/fleet.py): compact resident-prefix
            # digest so the router can steer by cache affinity
            digest = digest_fn()
            if digest is not None:
                out["prefix_digest"] = digest
        return out

    async def telemetry_delta(
            self, cursor: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Cursor-based pull of the replica's telemetry samples: the
        fleet rollup calls this from ``FleetRouter.refresh``. None when
        the replica has no telemetry store attached."""
        store = getattr(self.engine, "telemetry", None)
        if store is None:
            return None
        return store.delta(cursor)

    async def tracez(self, trace_id: str) -> List[Dict[str, Any]]:
        recorder = getattr(self.engine, "recorder", None)
        if recorder is None:
            return []
        return recorder.find(trace_id)

    def health_check(self) -> Dict[str, Any]:
        return self.engine.health_check()

    def describe(self) -> Dict[str, Any]:
        return {"kind": self.kind,
                "model": getattr(self.engine, "model_name", None)}


class HTTPTransport:
    """Remote replica over the service layer. Control plane rides
    ``service/client.py`` (traceparent injection, response histogram,
    circuit breaker); the KV blob is fetched from the prefill peer's
    handoff table — over a ``gofr.Disagg/fetch`` gRPC server-stream in
    bounded chunks when the peer advertises ``grpc_target``, over plain
    HTTP otherwise (or when the gRPC fetch fails: a ``warn``, then HTTP).
    The adopt response is buffered JSON (sync-core HTTP client in a
    worker thread, so the loop never blocks on a hop).

    A peer's JSON answers come in the framework's ``{"data": ...}``
    envelope (``http/responder.py``); :func:`_answer` takes the payload
    out of it. JAX's transport reads the envelope as the payload, so
    against JAX's own example its prefill leg raises ``KeyError`` and its
    probes read empty pages (ROADMAP.md §3)."""

    kind = "http"

    def __init__(self, base_url: str, grpc_target: Optional[str] = None,
                 service=None, breaker_threshold: int = 5,
                 breaker_interval: float = 10.0, timeout: float = 120.0,
                 logger=None, metrics=None, tracer=None,
                 retry_policy: Optional[RetryPolicy] = None):
        from gofr_tpu_torch.service.circuit_breaker import (
            CircuitBreakerConfig)
        from gofr_tpu_torch.service.client import HTTPService
        if service is None:
            service = HTTPService(base_url, logger=logger, metrics=metrics,
                                  tracer=tracer, timeout=timeout,
                                  service_name=base_url)
        self.service = CircuitBreakerConfig(
            breaker_threshold, breaker_interval).add_option(service)
        self.grpc_target = grpc_target
        self.logger = logger
        # the handoff fetch is idempotent (GET of an immutable blob), so
        # it earns a small bounded retry; control-plane POSTs do not —
        # the router owns those budgets
        self.retry = retry_policy if retry_policy is not None \
            else RetryPolicy(attempts=2, base_s=0.05)

    def available(self) -> bool:
        return not getattr(self.service, "is_open", False)

    async def prefill(self, prompt_ids, sampling,
                      traceparent: Optional[str] = None) -> bytes:
        headers = {"traceparent": traceparent} if traceparent else None
        response = await self.service.apost(
            "/disagg/prefill",
            body={"prompt": [int(t) for t in prompt_ids],
                  "sampling": _sampling_dict(sampling)},
            headers=headers)
        if not response.ok:
            raise RuntimeError(
                f"prefill peer answered {response.status_code}: "
                f"{response.body[:200]!r}")
        info = _answer(response)
        blob = await self._fetch(info["handoff"], headers)
        if len(blob) != int(info.get("bytes", len(blob))):
            raise kv_wire.KVWireError(
                f"handoff fetch returned {len(blob)} bytes, peer "
                f"declared {info.get('bytes')}")
        return blob

    async def _fetch(self, handoff: str,
                     headers: Optional[Dict[str, str]]) -> bytes:
        if self.grpc_target:
            try:
                return await _grpc_fetch(self.grpc_target, handoff)
            except Exception as exc:
                if self.logger is not None:
                    self.logger.warn(
                        "grpc KV fetch from %s failed (%r); falling back "
                        "to HTTP", self.grpc_target, exc)

        async def attempt(n: int) -> bytes:
            response = await self.service.aget(
                "/disagg/fetch", params={"handoff": handoff},
                headers=headers)
            if not response.ok:
                raise RuntimeError(
                    f"handoff fetch answered {response.status_code}")
            return response.body
        try:
            return await self.retry.run(attempt)
        except RetryBudgetExceeded as exc:
            raise (exc.__cause__ or exc) from None

    async def adopt(self, blob: bytes, max_new_tokens: int,
                    eos_id: Optional[int], sampling,
                    traceparent: Optional[str] = None,
                    submitted_at: Optional[float] = None,
                    transfer_s: float = 0.0,
                    dedupe: Optional[str] = None):
        headers = {"Content-Type": "application/octet-stream"}
        if traceparent:
            headers["traceparent"] = traceparent
        params = {"max_new_tokens": int(max_new_tokens)}
        if eos_id is not None:
            params["eos_id"] = int(eos_id)
        if dedupe:
            # idempotency key: a replayed adopt for the same id returns
            # the peer's prior stream instead of double-claiming pages
            params["dedupe"] = dedupe
        params.update(_sampling_dict(sampling))
        response = await self.service.apost(
            "/disagg/adopt", params=params, body=bytes(blob),
            headers=headers)
        if not response.ok:
            raise RuntimeError(
                f"decode peer answered {response.status_code}: "
                f"{response.body[:200]!r}")
        return _ListStream(_answer(response).get("tokens", []))

    async def adopt_session(self, blob: bytes, state: Dict[str, Any],
                            traceparent: Optional[str] = None,
                            transfer_s: float = 0.0,
                            dedupe: Optional[str] = None):
        """Ship a live session snapshot to a remote decode peer. Like
        ``adopt``, the response is the buffered remainder of the
        completion relayed token-wise; the peer resumes mid-stream with
        zero re-prefill."""
        headers = {"Content-Type": "application/octet-stream"}
        if traceparent:
            headers["traceparent"] = traceparent
        params: Dict[str, Any] = {
            "remaining": int(state["remaining"]),
            "temperature": float(state.get("temperature", 0.0)),
            "top_k": int(state.get("top_k", 0)),
            "top_p": float(state.get("top_p", 1.0)),
        }
        if state.get("eos_id") is not None:
            params["eos_id"] = int(state["eos_id"])
        if dedupe:
            params["dedupe"] = dedupe
        response = await self.service.apost(
            "/disagg/adopt_session", params=params, body=bytes(blob),
            headers=headers)
        if not response.ok:
            raise RuntimeError(
                f"migration target answered {response.status_code}: "
                f"{response.body[:200]!r}")
        return _ListStream(_answer(response).get("tokens", []))

    async def observe(self) -> Dict[str, Any]:
        """One clusterz probe: the peer's ``/debug/statusz`` page, which
        already carries engine stats, SLO snapshot, and watchdog state.
        Raises on a non-2xx answer — the caller marks the replica stale."""
        response = await self.service.aget("/debug/statusz",
                                           params={"recent": 1})
        if not response.ok:
            raise RuntimeError(
                f"statusz probe answered {response.status_code}")
        peer = _answer(response)
        return {"kind": self.kind, "statusz": peer,
                "health": "UP"}

    async def telemetry_delta(
            self, cursor: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Cursor-based telemetry pull over the peer's ``/debug/timez``
        endpoint. None when the peer has no timez surface or no
        telemetry store — the rollup simply skips the replica."""
        params: Dict[str, Any] = {"cursor": int(cursor)
                                  if cursor is not None else 0}
        response = await self.service.aget("/debug/timez", params=params)
        if not response.ok:
            return None
        return _answer(response).get("delta")

    async def tracez(self, trace_id: str) -> List[Dict[str, Any]]:
        response = await self.service.aget(
            f"/debug/tracez/{trace_id}", params={"local": "1"})
        if not response.ok:
            return []
        return _answer(response).get("records", [])

    def health_check(self) -> Dict[str, Any]:
        return self.service.health_check()

    def describe(self) -> Dict[str, Any]:
        return {"kind": self.kind, "base_url": self.service.base_url,
                "grpc_target": self.grpc_target,
                "circuit": "open" if not self.available() else "closed"}


def _answer(response) -> Any:
    """A peer's JSON answer without the framework's ``{"data": ...}``
    envelope (a bare JSON answer as it is)."""
    payload = response.json()
    if isinstance(payload, dict) and set(payload) == {"data"}:
        return payload["data"]
    return payload


async def _grpc_fetch(target: str, handoff: str,
                      timeout: float = 60.0) -> bytes:
    """Pull one handoff's chunks over the peer's ``gofr.Disagg/fetch``
    server-stream (grpcx dynamic JSON framing: each frame is
    ``{"data": {"chunk": <base64>}}``). ``grpc`` is imported here, at the
    call: a host without grpcio raises, and the caller falls back to
    HTTP."""
    try:
        import grpc
    except ImportError as exc:
        raise RuntimeError("grpcio is not installed") from exc
    channel = grpc.aio.insecure_channel(target)
    try:
        call = channel.unary_stream(
            "/gofr.Disagg/fetch",
            request_serializer=lambda payload: json.dumps(payload).encode(),
            response_deserializer=lambda raw: json.loads(
                raw.decode() or "null"))
        chunks: List[bytes] = []
        async for frame in call({"handoff": handoff}, timeout=timeout):
            data = (frame or {}).get("data") or {}
            chunks.append(base64.b64decode(data.get("chunk", "")))
        return kv_wire.assemble(chunks)
    finally:
        await channel.close()


def _sampling_dict(sampling) -> Dict[str, Any]:
    if sampling is None:
        return {}
    return {"temperature": float(sampling.temperature),
            "top_k": int(sampling.top_k),
            "top_p": float(sampling.top_p),
            "seed": int(sampling.seed)}


class _ListStream:
    """Buffered token list behind the TokenStream async-iterator shape —
    the HTTP adopt response's whole completion, relayed token-wise."""

    def __init__(self, tokens: List[int]):
        self._tokens = [int(t) for t in tokens]
        self._i = 0

    def __aiter__(self) -> "_ListStream":
        return self

    async def __anext__(self) -> int:
        if self._i >= len(self._tokens):
            raise StopAsyncIteration
        token = self._tokens[self._i]
        self._i += 1
        return token

    def cancel(self) -> None:
        self._i = len(self._tokens)

    async def aclose(self) -> None:
        self.cancel()


class Replica:
    """One registry entry: role, transport, lifecycle state, and the
    router-level in-flight count drain waits on."""

    __slots__ = ("name", "role", "transport", "state", "inflight",
                 "requests", "registered_at")

    def __init__(self, name: str, role: str, transport):
        self.name = name
        self.role = role
        self.transport = transport
        self.state = STATE_READY
        self.inflight = 0
        self.requests = 0
        self.registered_at = time.monotonic()

    def serves(self, role: str) -> bool:
        return self.role == role or self.role == ROLE_BOTH

    def describe(self) -> Dict[str, Any]:
        return {"role": self.role, "state": self.state,
                "inflight": self.inflight, "requests": self.requests,
                "transport": self.transport.describe()}


class ClusterRegistry:
    """Replica registry with health/drain-aware, per-role round-robin
    routing. Mirrors the model registry's lifecycle vocabulary
    (READY/DRAINING and the same state-gauge encoding) so dashboards
    treat models and replicas uniformly."""

    def __init__(self, logger=None, metrics=None):
        self.logger = logger
        self.metrics = metrics
        self._replicas: Dict[str, Replica] = {}
        self._rr: Dict[str, int] = {}

    # -- lifecycle ----------------------------------------------------------
    def register(self, name: str, role: str, transport) -> Replica:
        name = str(name)
        if role not in ROLES:
            raise ValueError(f"replica role {role!r}: expected one of "
                             f"{ROLES}")
        if name in self._replicas:
            raise ValueError(f"replica {name!r} is already registered")
        replica = Replica(name, role, transport)
        self._replicas[name] = replica
        self._set_state(replica, STATE_READY)
        if self.logger is not None:
            self.logger.info("cluster: registered replica %r role=%s "
                             "transport=%s", name, role,
                             getattr(transport, "kind", "?"))
        return replica

    async def drain(self, name: str, timeout_s: float = 30.0,
                    poll_s: float = 0.05) -> bool:
        """READY → DRAINING: the router stops picking this replica
        immediately; then wait for its router-level in-flight streams —
        and, for an in-proc replica, the engine's own slots/backlog — to
        finish. Returns True when fully drained in time (state stays
        DRAINING either way; ``resume`` is the exit)."""
        replica = self._require(name)
        self._set_state(replica, STATE_DRAINING)
        engine = getattr(replica.transport, "engine", None)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            busy = replica.inflight
            if engine is not None:
                pending = getattr(engine, "_pending", None)
                busy = busy or getattr(engine, "active_slots", 0) \
                    or (pending is not None and not pending.empty())
            if not busy:
                return True
            await asyncio.sleep(poll_s)
        return False

    def resume(self, name: str) -> None:
        self._set_state(self._require(name), STATE_READY)

    def _require(self, name: str) -> Replica:
        replica = self._replicas.get(name)
        if replica is None:
            raise KeyError(f"unknown replica {name!r}; registered: "
                           f"{sorted(self._replicas)}")
        return replica

    def _set_state(self, replica: Replica, state: str) -> None:
        replica.state = state
        if self.metrics is not None:
            self.metrics.set_gauge(
                "app_tpu_replica_state", _STATE_GAUGE[state],
                replica=replica.name, role=replica.role)

    # -- routing ------------------------------------------------------------
    def pick(self, role: str) -> Replica:
        """Least-inflight routing over READY replicas serving ``role``
        (a ``both`` replica serves either phase), skipping peers whose
        circuit is open; replicas tied on in-flight count are broken by
        round-robin so an idle fleet still spreads warm-up traffic
        instead of hammering rotation order onto one peer. Raises
        :class:`NoReplicaAvailable` when none qualify."""
        candidates = [r for r in self._replicas.values()
                      if r.state == STATE_READY and r.serves(role)
                      and r.transport.available()]
        if not candidates:
            raise NoReplicaAvailable(role)
        least = min(r.inflight for r in candidates)
        candidates = [r for r in candidates if r.inflight == least]
        turn = self._rr.get(role, 0)
        self._rr[role] = turn + 1
        return candidates[turn % len(candidates)]

    def note_start(self, replica: Replica) -> None:
        replica.inflight += 1
        replica.requests += 1
        if self.metrics is not None:
            self.metrics.set_gauge("app_tpu_replica_inflight",
                                   float(replica.inflight),
                                   replica=replica.name)

    def note_end(self, replica: Replica) -> None:
        replica.inflight = max(0, replica.inflight - 1)
        if self.metrics is not None:
            self.metrics.set_gauge("app_tpu_replica_inflight",
                                   float(replica.inflight),
                                   replica=replica.name)

    # -- observability ------------------------------------------------------
    def replicas(self) -> List[str]:
        return sorted(self._replicas)

    def roles(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {ROLE_PREFILL: [], ROLE_DECODE: []}
        for name, replica in self._replicas.items():
            for role in (ROLE_PREFILL, ROLE_DECODE):
                if replica.serves(role):
                    out[role].append(name)
        return {role: sorted(names) for role, names in out.items()}

    def stats(self) -> Dict[str, Any]:
        return {
            "replicas": {name: replica.describe()
                         for name, replica in self._replicas.items()},
            "roles": self.roles(),
        }

    def health_check(self) -> Dict[str, Any]:
        """Role-aware readiness: the cluster is UP only while every
        role has at least one routable replica — a fleet of healthy
        decode replicas with zero prefill capacity serves nothing."""
        details: Dict[str, Any] = {"replicas": {}, "roles": {}}
        for name, replica in self._replicas.items():
            health = replica.transport.health_check()
            details["replicas"][name] = {
                "role": replica.role, "state": replica.state,
                "inflight": replica.inflight,
                "transport": health.get("status", "UNKNOWN"),
            }
        status = "UP"
        for role in (ROLE_PREFILL, ROLE_DECODE):
            routable = [
                name for name, replica in self._replicas.items()
                if replica.state == STATE_READY and replica.serves(role)
                and replica.transport.available()
                and details["replicas"][name]["transport"] == "UP"]
            details["roles"][role] = routable
            if not routable:
                status = "DOWN"
        return {"status": status, "details": details}


class _RelayStream:
    """Router-side wrapper around the decode replica's token stream:
    releases the registry's in-flight count exactly once, on completion,
    error, or cancellation — the count ``drain`` waits on."""

    def __init__(self, inner, registry: ClusterRegistry,
                 replica: Replica, on_finish=None,
                 trace_id: Optional[str] = None):
        self._inner = inner
        self._registry = registry
        self._replica = replica
        self._on_finish = on_finish
        self._open = True
        # the request's stitch key: /debug/tracez/{trace_id} after this
        # stream completes returns the assembled timeline
        self.trace_id = trace_id

    def __aiter__(self) -> "_RelayStream":
        return self

    async def __anext__(self) -> int:
        try:
            return await self._inner.__anext__()
        except BaseException:
            self._finish()
            raise

    def _finish(self) -> None:
        if self._open:
            self._open = False
            self._registry.note_end(self._replica)
            if self._on_finish is not None:
                self._on_finish()

    def cancel(self) -> None:
        cancel = getattr(self._inner, "cancel", None)
        if cancel is not None:
            cancel()
        self._finish()

    async def aclose(self) -> None:
        self.cancel()


class DisaggRouter:
    """Request front-end for a disaggregated cluster: admit, prefill on
    one replica, hand the KV to another, stream tokens back. The
    transfer leg is measured (``app_tpu_kv_transfer_seconds`` /
    ``..._bytes_total``) and traced (``kv_transfer`` span carrying bytes
    shipped and both replica names)."""

    STITCH_CAPACITY = 256

    def __init__(self, registry: ClusterRegistry, logger=None,
                 metrics=None, tracer=None,
                 retry_policy: Optional[RetryPolicy] = None):
        self.registry = registry
        self.logger = logger
        self.metrics = metrics
        self.tracer = tracer
        # failure budget for the dispatch legs: prefill retries freely
        # (idempotent — a fresh handoff per call), adopts retry only
        # because every adopt carries a dedupe id the decode engine
        # honors; hedging stays off unless the policy arms it
        self.retry = retry_policy if retry_policy is not None \
            else RetryPolicy()
        self._requests = 0
        self._retries = 0
        self._hedges = 0
        self._bytes_shipped = 0
        # recent transfer-leg wall times, for the clusterz quantile rollup
        self._transfer_window: "deque[float]" = deque(maxlen=512)
        # per-request stitch entries keyed by trace_id — the router-side
        # half of /debug/tracez/{trace_id} (bounded ring, newest wins)
        self._stitches: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self.last_trace_id: Optional[str] = None

    async def generate_stream(self, prompt_ids, max_new_tokens: int,
                              eos_id: Optional[int] = None,
                              sampling=None):
        """Returns an async token iterator (TokenStream shape, ``cancel``
        / ``aclose`` supported). Routing/validation failures raise here,
        before any stream bytes are written — same contract as
        ``GenerationEngine.generate_stream``."""
        submitted_at = time.monotonic()
        prefiller = self.registry.pick(ROLE_PREFILL)
        decoder = self._pick_decode(prompt_ids)
        parent = current_span() if self.tracer is not None else None
        span = (self.tracer.start_span("kv_transfer", parent=parent)
                if self.tracer is not None else None)
        if span is not None:
            traceparent = format_traceparent(span)
            trace_id = span.trace_id
        else:
            # no tracer configured — synthesize a traceparent anyway so
            # both replicas' flight records share one trace_id and the
            # tracez stitcher still works
            trace_id = os.urandom(16).hex()
            traceparent = f"00-{trace_id}-{os.urandom(8).hex()}-01"
        t0 = time.perf_counter()
        try:
            # each leg retries under the policy's budget; a wire-damaged
            # blob (KVWireError at adopt) earns exactly ONE fresh prefill
            # round — the blob itself is bad, so replaying the adopt
            # alone can never recover
            for wire_round in range(2):
                prefiller, blob = await self._dispatch_prefill(
                    prefiller, prompt_ids, sampling, traceparent)
                t1 = time.perf_counter()
                try:
                    decoder, stream = await self._dispatch_adopt(
                        decoder, blob, max_new_tokens, eos_id, sampling,
                        traceparent, submitted_at, t1, dedupe=trace_id)
                    break
                except kv_wire.KVWireError:
                    if wire_round:
                        raise
                    self._note_retry("wire")(1, None)
        except BaseException:
            if span is not None:
                span.set_status("ERROR")
                span.finish()
            raise
        t2 = time.perf_counter()
        self._requests += 1
        self._bytes_shipped += len(blob)
        self._transfer_window.append(t2 - t1)
        if self.metrics is not None:
            self.metrics.record_histogram(
                "app_tpu_kv_transfer_seconds", t2 - t1,
                transport=decoder.transport.kind)
        if span is not None:
            span.set_attribute("bytes", len(blob))
            span.set_attribute("prefill_replica", prefiller.name)
            span.set_attribute("decode_replica", decoder.name)
            span.set_attribute("transport", decoder.transport.kind)
            span.finish()
        entry = {
            "trace_id": trace_id,
            "wall_at": time.time(),
            "submitted_at": submitted_at,
            "prefill_replica": prefiller.name,
            "decode_replica": decoder.name,
            "transport": decoder.transport.kind,
            "prefill_rpc_s": t1 - t0,
            "adopt_rpc_s": t2 - t1,
            "bytes": len(blob),
            "finished_at": None,      # set when the relay stream closes
        }
        self._remember(entry)
        relay = _RelayStream(
            stream, self.registry, decoder,
            on_finish=lambda: entry.__setitem__(
                "finished_at", time.monotonic()),
            trace_id=entry["trace_id"])
        # everything a recovery layer needs to rebuild this request from
        # scratch on another replica (tpu/fleet.py resumable decode)
        request = {
            "prompt_ids": [int(t) for t in prompt_ids],
            "max_new_tokens": int(max_new_tokens),
            "eos_id": eos_id,
            "sampling": sampling,
            "submitted_at": submitted_at,
            "trace_id": trace_id,
        }
        return self._wrap_stream(relay, decoder, stream, request)

    async def _dispatch_prefill(self, prefiller: Replica, prompt_ids,
                                sampling, traceparent: Optional[str]
                                ) -> Tuple[Replica, bytes]:
        """The prefill leg under the retry budget. Prefill is idempotent
        (every call mints a fresh handoff), so retries re-pick a replica
        freely and, when the policy arms ``hedge_after_s``, a slow
        primary is raced against a second replica — first blob wins."""
        async def leg(replica: Replica) -> Tuple[Replica, bytes]:
            self.registry.note_start(replica)
            try:
                return replica, await replica.transport.prefill(
                    prompt_ids, sampling, traceparent=traceparent)
            finally:
                self.registry.note_end(replica)

        async def attempt(n: int) -> Tuple[Replica, bytes]:
            replica = prefiller if n == 1 \
                else self._repick(ROLE_PREFILL, prefiller)
            backup = None
            if self.retry.hedge_after_s is not None:
                alt = self._pick_alternate(ROLE_PREFILL, replica)
                if alt is not None:
                    def backup(alt: Replica = alt):
                        return leg(alt)
            result, hedged = await self.retry.hedged(
                lambda: leg(replica), backup)
            if hedged:
                self._hedges += 1
                if self.metrics is not None:
                    self.metrics.increment_counter(
                        "app_tpu_disagg_hedge_total", leg="prefill")
            return result
        try:
            return await self.retry.run(
                attempt, on_retry=self._note_retry("prefill"))
        except RetryBudgetExceeded as exc:
            raise (exc.__cause__ or exc) from None

    async def _dispatch_adopt(self, decoder: Replica, blob: bytes,
                              max_new_tokens: int, eos_id: Optional[int],
                              sampling, traceparent: Optional[str],
                              submitted_at: float, t1: float, *,
                              dedupe: str):
        """The adopt leg under the retry budget. An adopt is NOT blindly
        idempotent — a replayed adopt could double-claim pages — so every
        attempt carries the request's ``dedupe`` id and the decode engine
        answers a replay with the prior stream. Deterministic payload
        rejections (:class:`KVWireError` and other ValueErrors) are not
        retried here; the caller decides whether a fresh prefill is
        worth one more round."""
        async def attempt(n: int):
            replica = decoder if n == 1 \
                else self._repick(ROLE_DECODE, decoder)
            self.registry.note_start(replica)
            try:
                # transfer_s seeds the decode record's wire figure with
                # the post-prefill leg only; the transport adds its own
                # unpack share — the prefill RPC wall must NOT be folded
                # in here
                stream = await replica.transport.adopt(
                    blob, max_new_tokens, eos_id, sampling,
                    traceparent=traceparent, submitted_at=submitted_at,
                    transfer_s=time.perf_counter() - t1, dedupe=dedupe)
            except BaseException:
                self.registry.note_end(replica)
                raise
            return replica, stream
        try:
            return await self.retry.run(
                attempt, retryable=lambda exc: not isinstance(
                    exc, ValueError),
                on_retry=self._note_retry("adopt"))
        except RetryBudgetExceeded as exc:
            raise (exc.__cause__ or exc) from None

    def _repick(self, role: str, previous: Replica) -> Replica:
        """Target for a retry attempt — prefer a different replica than
        the one that just failed, fall back to it when it is the only
        routable choice."""
        try:
            candidate = self.registry.pick(role)
        except NoReplicaAvailable:
            return previous
        if candidate is not previous:
            return candidate
        try:
            again = self.registry.pick(role)
        except NoReplicaAvailable:
            return candidate
        return again if again is not previous else candidate

    def _pick_alternate(self, role: str,
                        exclude: Replica) -> Optional[Replica]:
        """Least-loaded routable replica other than ``exclude`` — the
        hedge target. None when the fleet has no second choice."""
        candidates = [r for r in self.registry._replicas.values()
                      if r.state == STATE_READY and r.serves(role)
                      and r.transport.available() and r is not exclude]
        if not candidates:
            return None
        return min(candidates, key=lambda r: r.inflight)

    def _note_retry(self, leg: str):
        def note(attempt: int, exc: Optional[BaseException]) -> None:
            self._retries += 1
            if self.metrics is not None:
                self.metrics.increment_counter(
                    "app_tpu_disagg_retry_total", leg=leg)
            if self.logger is not None:
                self.logger.warn(
                    "disagg: %s attempt %d failed (%r); retrying",
                    leg, attempt, exc)
        return note

    def _pick_decode(self, prompt_ids) -> Replica:
        """Decode-target selection hook — the fleet router overrides this
        with prefix-affinity routing (tpu/fleet.py); the base router
        load-balances by least inflight."""
        return self.registry.pick(ROLE_DECODE)

    def _wrap_stream(self, relay: "_RelayStream", decoder: Replica,
                     stream, request: Optional[Dict[str, Any]] = None
                     ) -> Any:
        """Relay post-processing hook — the fleet router wraps the relay
        in a migratable, *resumable* session: live decode→decode
        migration can splice a new replica's stream in mid-flight, and a
        replica crash mid-stream rebuilds the request (``request`` ctx)
        on a surviving replica."""
        return relay

    def _remember(self, entry: Dict[str, Any]) -> None:
        self._stitches[entry["trace_id"]] = entry
        self._stitches.move_to_end(entry["trace_id"])
        self.last_trace_id = entry["trace_id"]
        while len(self._stitches) > self.STITCH_CAPACITY:
            self._stitches.popitem(last=False)

    def transfer_quantiles(self) -> Optional[Dict[str, float]]:
        """p50/p90/p99 over the recent KV-transfer window (seconds)."""
        if not self._transfer_window:
            return None
        ordered = sorted(self._transfer_window)
        def pick(q: float) -> float:
            idx = min(len(ordered) - 1, int(q * (len(ordered) - 1) + 0.5))
            return round(ordered[idx], 6)
        return {"count": len(ordered), "p50": pick(0.50),
                "p90": pick(0.90), "p99": pick(0.99)}

    async def trace(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Assemble the end-to-end timeline of one disagg request:
        prefill → kv_transfer → handoff_gap → decode, from the router's
        stitch entry plus both replicas' flight records.

        The handoff gap is the *residual*: end-to-end wall minus the
        measured prefill/transfer/decode phases. It appears exactly once
        and absorbs the slack neither replica's record covers (router
        scheduling, pack on the prefill side, decode admission wait) —
        so the phase durations always sum to the end-to-end figure."""
        entry = self._stitches.get(trace_id)
        if entry is None:
            return None
        prefill_records = await self._replica_records(
            entry["prefill_replica"], trace_id)
        if entry["decode_replica"] == entry["prefill_replica"]:
            decode_records = prefill_records
        else:
            decode_records = await self._replica_records(
                entry["decode_replica"], trace_id)
        prefill_rec = next(
            (r for r in prefill_records if r.get("status") == "exported"),
            None)
        decode_rec = next(
            (r for r in decode_records
             if r.get("kv_transfer_bytes") and r.get("status") != "exported"),
            None)
        finished_at = entry["finished_at"]
        e2e = ((finished_at if finished_at is not None
                else time.monotonic()) - entry["submitted_at"])
        e2e = max(e2e, 0.0)

        def _rec_duration(rec, start_key="enqueued_at") -> Optional[float]:
            timing = (rec or {}).get("timing") or {}
            start = timing.get(start_key)
            end = timing.get("finished_at")
            if start is None or end is None:
                return None
            return max(0.0, end - start)

        prefill_s = _rec_duration(prefill_rec)
        if prefill_s is None:
            prefill_s = entry["prefill_rpc_s"]
        prefill_s = min(prefill_s, e2e)
        decode_s = _rec_duration(decode_rec)
        if decode_s is None:
            decode_s = max(0.0, e2e - entry["prefill_rpc_s"]
                           - entry["adopt_rpc_s"])
        decode_s = min(decode_s, max(0.0, e2e - prefill_s))
        transfer_s = (decode_rec or {}).get("kv_transfer_s")
        if transfer_s is None:
            transfer_s = entry["adopt_rpc_s"]
        transfer_s = min(transfer_s, max(0.0, e2e - prefill_s - decode_s))
        gap_s = max(0.0, e2e - prefill_s - transfer_s - decode_s)
        phases = [
            {"name": "prefill", "replica": entry["prefill_replica"],
             "duration_s": round(prefill_s, 6)},
            {"name": "kv_transfer", "transport": entry["transport"],
             "bytes": entry["bytes"], "duration_s": round(transfer_s, 6)},
            {"name": "handoff_gap", "duration_s": round(gap_s, 6)},
            {"name": "decode", "replica": entry["decode_replica"],
             "duration_s": round(decode_s, 6)},
        ]
        return {
            "trace_id": trace_id,
            "stitched": True,
            "wall_at": entry["wall_at"],
            "in_flight": finished_at is None,
            "prefill_replica": entry["prefill_replica"],
            "decode_replica": entry["decode_replica"],
            "transport": entry["transport"],
            "bytes": entry["bytes"],
            "e2e_s": round(e2e, 6),
            "phases": phases,
            "records": {"prefill": prefill_records,
                        "decode": decode_records},
        }

    async def _replica_records(self, name: str,
                               trace_id: str) -> List[Dict[str, Any]]:
        replica = self.registry._replicas.get(name)
        if replica is None:
            return []
        tracez = getattr(replica.transport, "tracez", None)
        if tracez is None:
            return []
        try:
            return await tracez(trace_id)
        except Exception:
            return []

    async def generate(self, prompt_ids, max_new_tokens: int,
                       eos_id: Optional[int] = None,
                       sampling=None) -> List[int]:
        stream = await self.generate_stream(prompt_ids, max_new_tokens,
                                            eos_id=eos_id,
                                            sampling=sampling)
        tokens: List[int] = []
        async for token in stream:
            tokens.append(token)
        return tokens

    def stats(self) -> Dict[str, Any]:
        return {
            "requests": self._requests,
            "retries": self._retries,
            "hedges": self._hedges,
            "bytes_shipped": self._bytes_shipped,
            "kv_transfer_quantiles": self.transfer_quantiles(),
            "stitched_traces": len(self._stitches),
            "cluster": self.registry.stats(),
        }
