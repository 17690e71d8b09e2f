"""The port's outbound client (``gofr_tpu_torch/service``) against JAX's
(``gofr_tpu/service``): the cases of ``tests/test_service_error_matrix.py``
run through both clients against one local server, and one failure
sequence through both circuit breakers.

- connection refused raises ``ServiceError`` and counts ``status=error``;
  a 5xx is a response with its status, body and headers; a timeout raises
  ``ServiceError``; a non-JSON body survives and ``.json()`` raises; the
  async verbs give the sync verbs' answers; a bytes body is sent verbatim;
- the headers each client injects: the W3C ``traceparent`` of its span,
  the API key, basic auth, default headers, OAuth's bearer token from a
  local token endpoint (fetched once, then cached), the health endpoint's
  override;
- the breaker: threshold, open fast-fail, the half-open single-flight
  trial after the cooldown (``interval`` 0.05 s), close on a good trial,
  reopen on a bad one; equal states and equal
  ``app_tpu_circuit_state_total{state}`` counts.

Nothing here is numeric: every comparison is exact.
"""

import asyncio
import json
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

SIDES = ("jax", "port")
TRACEPARENT = re.compile(r"^00-[0-9a-f]{32}-[0-9a-f]{16}-01$")


def _service_mod(side):
    if side == "jax":
        import gofr_tpu.service as mod
    else:
        import gofr_tpu_torch.service as mod
    return mod


def _container(side):
    if side == "jax":
        from gofr_tpu.container import new_mock_container
        return new_mock_container()
    from gofr_tpu_torch.container import new_mock_container
    return new_mock_container(device="cpu")


def _tracer(side):
    if side == "jax":
        from gofr_tpu.trace import Tracer
    else:
        from gofr_tpu_torch.trace import Tracer
    return Tracer()


class _Upstream(BaseHTTPRequestHandler):
    """One server for every case, by path: ``ok``, ``slow`` (0.2 s),
    ``error`` (503 + Retry-After), ``not-json``, ``echo`` (the request's
    headers and body back), ``token`` (an OAuth token endpoint),
    ``flaky`` (``_Upstream.flaky_status``)."""

    seen = []
    token_calls = 0
    flaky_status = 500

    def _serve(self):
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        path = self.path.split("?")[0].strip("/")
        if path == "slow":
            time.sleep(0.2)
        if path == "error":
            self._send(503, b'{"oops": true}', {"Retry-After": "1"})
        elif path == "not-json":
            self._send(200, b"<html>not json</html>",
                       {"Content-Type": "text/plain"})
        elif path == "echo":
            _Upstream.seen.append((dict(self.headers), body))
            self._send(200, json.dumps({"path": self.path}).encode())
        elif path == "token":
            _Upstream.token_calls += 1
            self._send(200, json.dumps({
                "access_token": f"tok-{_Upstream.token_calls}",
                "expires_in": 3600}).encode())
        elif path == "flaky":
            self._send(_Upstream.flaky_status, b'{"flaky": true}')
        else:
            self._send(200, json.dumps({"ok": True}).encode())

    def _send(self, status, body, headers=None):
        self.send_response(status)
        headers = dict({"Content-Type": "application/json"}, **(headers or {}))
        for key, value in headers.items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(body)

    do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = _serve

    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def upstream():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Upstream)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()


def _free_port():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()                     # nothing listens here now
    return port


def _both(fn):
    """``fn(side)`` for each package: {side: result}."""
    return {side: fn(side) for side in SIDES}


def test_connection_refused_raises_service_error_as_jax():
    port = _free_port()

    def run(side):
        mod, container = _service_mod(side), _container(side)
        service = mod.new_http_service(f"http://127.0.0.1:{port}",
                                       container.logger, container.metrics,
                                       service_name="down")
        with pytest.raises(mod.ServiceError, match="GET") as info:
            service.get("x")
        return (type(info.value).__name__, str(info.value).split(":")[0],
                container.metrics.value("app_http_service_response",
                                        service="down", method="GET",
                                        status="error"))

    got = _both(run)
    assert got["port"] == got["jax"] == ("ServiceError", "GET http", 1.0)


def test_upstream_5xx_is_a_response_as_jax(upstream):
    def run(side):
        container = _container(side)
        service = _service_mod(side).new_http_service(
            upstream, container.logger, container.metrics, service_name="up")
        response = service.get("error")
        return (response.status_code, response.ok, response.json(),
                response.headers.get("Retry-After"),
                container.metrics.value("app_http_service_response",
                                        service="up", method="GET",
                                        status="503"))

    got = _both(run)
    assert got["port"] == got["jax"] == (503, False, {"oops": True}, "1",
                                         1.0)


def test_timeout_raises_service_error_as_jax(upstream):
    def run(side):
        mod, container = _service_mod(side), _container(side)
        service = mod.new_http_service(upstream, container.logger,
                                       container.metrics,
                                       service_name="slow", timeout=0.05)
        start = time.perf_counter()
        with pytest.raises(mod.ServiceError):
            service.get("slow")
        return time.perf_counter() - start < 0.2, container.metrics.value(
            "app_http_service_response", service="slow", method="GET",
            status="error")

    got = _both(run)
    assert got["port"] == got["jax"] == (True, 1.0)


def test_non_json_body_survives_and_json_raises_as_jax(upstream):
    def run(side):
        container = _container(side)
        service = _service_mod(side).new_http_service(
            upstream, container.logger, container.metrics, service_name="up")
        response = service.get("not-json")
        with pytest.raises(ValueError):
            response.json()
        return response.status_code, response.body

    got = _both(run)
    assert got["port"] == got["jax"] == (200, b"<html>not json</html>")


def test_async_verbs_match_sync_as_jax(upstream):
    def run(side):
        container = _container(side)
        service = _service_mod(side).new_http_service(
            upstream, container.logger, container.metrics, service_name="up")

        async def main():
            return await asyncio.gather(
                service.aget("ok"), service.apost("ok", body={"k": 1}),
                service.aput("ok", body={"k": 2}), service.apatch("ok"),
                service.adelete("ok"))

        sync = [service.get("ok"), service.post("ok", body={"k": 1}),
                service.put("ok", body={"k": 2}), service.patch("ok"),
                service.delete("ok")]
        answers = asyncio.run(main())
        assert [(r.status_code, r.json()) for r in answers] \
            == [(r.status_code, r.json()) for r in sync]
        return [(r.status_code, r.json()) for r in answers]

    got = _both(run)
    assert got["port"] == got["jax"]


def test_bytes_body_sent_verbatim_as_jax(upstream):
    payload = bytes(range(256))

    def run(side):
        container = _container(side)
        service = _service_mod(side).new_http_service(
            upstream, container.logger, container.metrics, service_name="up")
        _Upstream.seen.clear()
        service.post("echo", body=payload)
        headers, body = _Upstream.seen[-1]
        service.post("echo", params={"a": [1, 2], "b": "x"},
                     body={"json": True})
        json_headers, json_body = _Upstream.seen[-1]
        return (body, headers.get("Content-Type"), json_body,
                json_headers.get("Content-Type"))

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][0] == payload \
        and got["port"][1] != "application/json"


def _injected(side, upstream, *option_args):
    """The headers one ``GET /echo`` carries through a client with the
    given options (each ``(name, args)`` built from that side's module),
    and the client's health check."""
    mod, container = _service_mod(side), _container(side)
    options = [getattr(mod, name)(*args) for name, args in option_args]
    tracer = _tracer(side)
    service = mod.new_http_service(upstream, container.logger,
                                   container.metrics, tracer, *options,
                                   service_name="up")
    _Upstream.seen.clear()
    service.get("echo", headers={"X-Caller": "c"})
    headers = {k.lower(): v for k, v in _Upstream.seen[-1][0].items()}
    traceparent = headers.pop("traceparent")
    assert TRACEPARENT.match(traceparent), traceparent
    for key in ("host", "user-agent", "accept-encoding", "connection"):
        headers.pop(key, None)
    return headers, service.health_check()


@pytest.mark.parametrize("option_args", [
    (),
    (("APIKeyConfig", ("k-123",)),),
    (("BasicAuthConfig", ("user", "pw")),),
    (("DefaultHeaders", ({"X-Team": "a", "X-Caller": "overridden"},)),),
    (("APIKeyConfig", ("k",)), ("DefaultHeaders", ({"X-Extra": "1"},))),
    (("HealthConfig", ("/echo",)),),
], ids=["plain", "api_key", "basic_auth", "default_headers", "chained",
        "health_endpoint"])
def test_injected_headers_as_jax(upstream, option_args):
    got = _both(lambda side: _injected(side, upstream, *option_args))
    assert got["port"] == got["jax"]


def test_oauth_bearer_token_as_jax(upstream):
    """Each client fetches one token from the local endpoint, sends it as
    a bearer token, and reuses it for the next request."""
    def run(side):
        mod, container = _service_mod(side), _container(side)
        _Upstream.token_calls = 0
        option = mod.OAuthConfig("id", "secret", f"{upstream}/token",
                                 scopes="read")
        service = mod.new_http_service(upstream, container.logger,
                                       container.metrics, None, option,
                                       service_name="up")
        _Upstream.seen.clear()
        service.get("echo")
        service.get("echo")
        auths = [dict(h).get("Authorization") for h, _ in _Upstream.seen]
        broken = mod.new_http_service(
            upstream, container.logger, container.metrics, None,
            mod.OAuthConfig("id", "s", f"http://127.0.0.1:{_free_port()}/t"),
            service_name="up")
        with pytest.raises(mod.ServiceError, match="oauth token fetch"):
            broken.get("echo")
        return auths, _Upstream.token_calls

    got = _both(run)
    assert got["port"] == got["jax"] == (["Bearer tok-1", "Bearer tok-1"], 1)


def _breaker_sequence(side, upstream):
    """Threshold 2, interval 0.05 s: two 500s open the circuit; a request
    fast-fails; after the cooldown a trial (a 500) reopens it; after
    another cooldown a good trial closes it. The states, ``is_open`` and
    the errors each step, and the transition counts."""
    mod, container = _service_mod(side), _container(side)
    service = mod.new_http_service(
        upstream, container.logger, container.metrics,
        None, mod.CircuitBreakerConfig(threshold=2, interval=0.05),
        service_name="flaky")
    steps = []

    def call():
        try:
            return service.get("flaky").status_code
        except mod.CircuitOpenError:
            return "open-fast-fail"
        except mod.ServiceError:
            return "service-error"

    _Upstream.flaky_status = 500
    for _ in range(2):
        steps.append((call(), service.state, service.is_open))
    steps.append((call(), service.state, service.is_open))
    time.sleep(0.06)
    steps.append(("cooled", service.state, service.is_open))
    steps.append((call(), service.state, service.is_open))   # failed trial
    steps.append((call(), service.state, service.is_open))
    time.sleep(0.06)
    _Upstream.flaky_status = 200
    steps.append((call(), service.state, service.is_open))   # good trial
    steps.append((call(), service.state, service.is_open))
    health = service.health_check()
    counts = {state: container.metrics.value(
        "app_tpu_circuit_state_total", state=state)
        for state in ("open", "half_open", "closed")}
    return steps, health["details"]["circuit"], counts


def test_circuit_breaker_sequence_as_jax(upstream):
    got = _both(lambda side: _breaker_sequence(side, upstream))
    assert got["port"] == got["jax"]
    steps, circuit, counts = got["port"]
    assert [s[0] for s in steps] == [500, 500, "open-fast-fail", "cooled",
                                     500, "open-fast-fail", 200, 200]
    assert circuit == "closed"
    assert counts == {"open": 2.0, "half_open": 2.0, "closed": 1.0}


def test_half_open_trial_is_single_flight_as_jax(upstream):
    """While the half-open trial is in flight a concurrent request
    fast-fails; the trial's success closes the circuit."""
    def run(side):
        mod, container = _service_mod(side), _container(side)
        service = mod.new_http_service(
            upstream, container.logger, container.metrics, None,
            mod.CircuitBreakerConfig(threshold=1, interval=0.05),
            service_name="flaky")
        _Upstream.flaky_status = 500
        service.get("flaky")
        time.sleep(0.06)
        results = {}

        def trial():
            results["trial"] = service.get("slow").status_code

        thread = threading.Thread(target=trial)
        thread.start()
        time.sleep(0.05)
        try:
            service.get("ok")
            results["concurrent"] = "reached"
        except mod.CircuitOpenError as exc:
            results["concurrent"] = "half-open" in str(exc)
        thread.join()
        return results, service.state

    got = _both(run)
    assert got["port"] == got["jax"] == ({"trial": 200, "concurrent": True},
                                         "closed")


def test_app_add_http_service_as_jax(upstream):
    """``App.add_http_service`` registers a named client in the container
    with the app's metrics and tracer and the given options."""
    from gofr_tpu.app import App as JaxApp
    from gofr_tpu.config import MapConfig as JaxMapConfig
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig

    apps = {"jax": JaxApp(config=JaxMapConfig({})),
            "port": App(config=MapConfig({}), device="cpu")}

    def run(side):
        app = apps[side]
        mod = _service_mod(side)
        app.add_http_service("peer", upstream, mod.APIKeyConfig("k"),
                             timeout=5.0)
        service = app.container.get_http_service("peer")
        _Upstream.seen.clear()
        response = service.get("echo")
        headers = {k.lower(): v for k, v in _Upstream.seen[-1][0].items()}
        return (response.json(), headers.get("x-api-key"),
                "traceparent" in headers, service.timeout,
                service.service_name,
                app.container.metrics.value(
                    "app_http_service_response", service="peer",
                    method="GET", status="200"))

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][1:] == ("k", True, 5.0, "peer", 1.0)
