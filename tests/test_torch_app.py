"""The port's app framework held to the JAX package's on the same inputs:
router lookups, request binding and params, the responder's envelopes,
each middleware, the built-in handlers, the metrics text after the same
requests, cron parsing, the server's edge cases (garbage bytes,
keep-alive, oversized bodies), the tracer's Zipkin export, config,
logging, the container's refusals, and the BPE tokenizer (the port's
native and Python encoders and JAX's give equal ids over a seeded corpus
and a trained merge list). Each case runs the same thing through both
packages and compares what comes out."""

import asyncio
import base64
import hashlib
import hmac
import http.server
import importlib
import json
import threading
import time

import numpy as np
import pytest

PKGS = {"jax": "gofr_tpu", "port": "gofr_tpu_torch"}
SIDES = ("jax", "port")


def mod(side, name):
    return importlib.import_module(f"{PKGS[side]}.{name}")


def run(coro):
    return asyncio.run(coro)


# -- the router -------------------------------------------------------------

ROUTES = [("GET", "/hello"), ("GET", "/users/{id}"),
          ("POST", "/users/{id}/items/{item}"), ("DELETE", "/users/{id}"),
          ("GET", "/"), ("PUT", "/v1/{model}/generate")]
LOOKUPS = [("GET", "/hello"), ("GET", "/hello/"), ("GET", "/users/7"),
           ("POST", "/users/7"), ("POST", "/users/7/items/x"),
           ("DELETE", "/users/9"), ("GET", "/nope"), ("GET", "/"),
           ("PUT", "/v1/small/generate"), ("GET", "/v1/small/generate"),
           ("get", "/users/3"), ("GET", "/users/7/items")]


def _router(side):
    router = mod(side, "http.router").Router()
    for method, template in ROUTES:
        async def handler(request, tag=f"{method} {template}"):
            return tag
        handler.tag = f"{method} {template}"
        router.add(method, template, handler)
    return router


@pytest.mark.parametrize("method,path", LOOKUPS)
def test_router_lookup_as_jax(method, path):
    got = {}
    for side in SIDES:
        handler, params, other, template = _router(side).lookup(method, path)
        got[side] = (getattr(handler, "tag", None), params, other, template,
                     _router(side).methods_for(path))
    assert got["port"] == got["jax"]


def test_router_registered_routes_and_middleware_order_as_jax():
    got = {}
    for side in SIDES:
        router = _router(side)
        calls = []

        def mw(name):
            def middleware(nxt):
                async def handle(req):
                    calls.append(name)
                    return await nxt(req)
                return handle
            return middleware
        router.use_middleware(mw("a"), mw("b"))
        handler = router.lookup("GET", "/hello")[0]
        result = run(router.wrap(handler)(None))
        got[side] = (router.registered_routes, calls, result)
    assert got["port"] == got["jax"]


# -- the request ------------------------------------------------------------

BINDS = [
    ("application/json", b'{"a": 1, "b": [1, 2]}'),
    ("application/json", b""),
    ("", b'{"x": "y"}'),
    ("application/x-www-form-urlencoded", b"a=1&b=two&a=3"),
    ("text/plain", b"raw bytes"),
    ("multipart/form-data; boundary=XX",
     b'--XX\r\nContent-Disposition: form-data; name="f"\r\n\r\nv\r\n'
     b'--XX\r\nContent-Disposition: form-data; name="up"; filename="a.txt"'
     b'\r\nContent-Type: text/plain\r\n\r\nhello\r\n--XX--\r\n'),
]


def _bound(value):
    if isinstance(value, dict):
        return {k: _bound(v) for k, v in value.items()}
    if hasattr(value, "filename"):
        return (value.filename, value.content_type, value.content)
    return value


@pytest.mark.parametrize("ctype,body", BINDS)
def test_request_bind_as_jax(ctype, body):
    got = {}
    for side in SIDES:
        request = mod(side, "http.request").Request(
            method="POST", path="/x", query="q=1&q=2&e=&z=%20s",
            headers={"content-type": ctype} if ctype else {}, body=body)
        got[side] = (_bound(request.bind()), request.param("q"),
                     request.params("q"), request.param("e"),
                     request.param("z"), request.param("missing"),
                     request.host_name(), request.header("Content-Type"))
    assert got["port"] == got["jax"]


def test_request_bad_json_and_tensor_as_jax():
    got = {}
    for side in SIDES:
        errors = mod(side, "http.errors")
        request = mod(side, "http.request").Request(
            headers={"content-type": "application/json"}, body=b"{nope")
        with pytest.raises(errors.InvalidParam) as info:
            request.bind()
        tensor = mod(side, "http.request").Request(
            headers={"content-type": "application/x-tensor",
                     "x-tensor-dtype": "float32", "x-tensor-shape": "2,2"},
            body=np.arange(4, dtype=np.float32).tobytes()).bind()
        got[side] = (info.value.status_code, info.value.message,
                     tensor.tolist())
    assert got["port"] == got["jax"]


# -- the responder ----------------------------------------------------------

def _results(side):
    response = mod(side, "http.response")
    errors = mod(side, "http.errors")
    slo = mod(side, "slo")

    class Thing:
        def __init__(self):
            self.a, self.b, self._hidden = 1, [np.int64(2)], 3

    return {
        "dict": ({"a": 1, "b": [1, 2]}, None, "GET"),
        "post": ({"id": 7}, None, "POST"),
        "delete_none": (None, None, "DELETE"),
        "object": (Thing(), None, "GET"),
        "array": (np.arange(3), None, "GET"),
        "bytes": (b"abc", None, "GET"),
        "raw": (response.Raw({"x": 1}), None, "GET"),
        "file": (response.FileResponse(b"\x00\x01", "image/png"), None,
                 "GET"),
        "redirect": (response.Redirect("/next", 301), None, "GET"),
        "response": (response.Response({"k": 2}, 202, {"X-A": "b"}), None,
                     "GET"),
        "response_bytes": (response.Response(b"zz", 200, {},
                                             "text/plain"), None, "GET"),
        "not_found": (None, errors.EntityNotFound("id", "4"), "GET"),
        "invalid": (None, errors.InvalidParam(["a", "b"]), "GET"),
        "missing": (None, errors.MissingParam(["c"]), "GET"),
        "route": (None, errors.InvalidRoute(), "GET"),
        "timeout": (None, errors.RequestTimeout(), "GET"),
        "panic": (None, errors.PanicRecovery(), "GET"),
        "deadline": (None, slo.DeadlineExceeded(), "POST"),
        "generic": (None, ValueError("bad"), "GET"),
    }


@pytest.mark.parametrize("case", sorted(_results("jax")))
def test_responder_as_jax(case):
    got = {}
    for side in SIDES:
        result, error, method = _results(side)[case]
        got[side] = mod(side, "http.responder").Responder().respond(
            result, error, method)
    assert got["port"] == got["jax"]


def test_responder_stream_as_jax():
    got = {}
    for side in SIDES:
        response = mod(side, "http.response")
        closed = []

        async def chunks():
            yield "a"

        status, headers, body = mod(side, "http.responder").Responder() \
            .respond(response.Stream(chunks(), sse=True,
                                     on_close=lambda: closed.append(1)),
                     None)
        body.complete(True, 1)
        body.complete(True, 1)
        got[side] = (status, headers, type(body).__name__, body.sse, closed,
                     len(body))
    assert got["port"] == got["jax"]


# -- the middlewares, one at a time -----------------------------------------

def _request(side, **kw):
    return mod(side, "http.request").Request(**kw)


async def _ok(request):
    return 200, {"Content-Type": "text/plain"}, b"ok"


def _jwt(secret, claims):
    def b64(data):
        return base64.urlsafe_b64encode(data).rstrip(b"=").decode()
    head = b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    body = b64(json.dumps(claims).encode())
    sig = hmac.new(secret.encode(), f"{head}.{body}".encode(),
                   hashlib.sha256).digest()
    return f"{head}.{body}.{b64(sig)}"


AUTH = base64.b64encode(b"ada:pw").decode()
BAD_AUTH = base64.b64encode(b"ada:nope").decode()
TOKEN = _jwt("s3", {"sub": "ada", "exp": time.time() + 600})
EXPIRED = _jwt("s3", {"sub": "ada", "exp": time.time() - 5})
MIDDLEWARE_CASES = [
    ("basic", "/x", {"authorization": f"Basic {AUTH}"}),
    ("basic", "/x", {"authorization": f"Basic {BAD_AUTH}"}),
    ("basic", "/x", {}),
    ("basic", "/.well-known/alive", {}),
    ("apikey", "/x", {"x-api-key": "k1"}),
    ("apikey", "/x", {"x-api-key": "zz"}),
    ("apikey", "/.well-known/health", {}),
    ("oauth", "/x", {"authorization": f"Bearer {TOKEN}"}),
    ("oauth", "/x", {"authorization": f"Bearer {EXPIRED}"}),
    ("oauth", "/x", {"authorization": "Bearer a.b.c"}),
    ("oauth", "/x", {}),
    ("cors", "/x", {}),
    ("cors_options", "/x", {}),
]


def _middleware(side, kind):
    mw = mod(side, "http.middleware")
    if kind == "basic":
        return mw.basic_auth_middleware(users={"ada": "pw"})
    if kind == "apikey":
        return mw.api_key_auth_middleware(keys=("k1",))
    if kind == "oauth":
        return mw.oauth_middleware(secret="s3")
    router = mod(side, "http.router").Router()
    router.add("GET", "/x", _ok)
    router.add("POST", "/x", _ok)
    config = mod(side, "config").MapConfig(
        {"ACCESS_CONTROL_MAX_AGE": "600"})
    return mw.cors_middleware(config, router)


@pytest.mark.parametrize("kind,path,headers", MIDDLEWARE_CASES)
def test_middleware_as_jax(kind, path, headers):
    got = {}
    for side in SIDES:
        request = _request(side, method="OPTIONS" if kind == "cors_options"
                           else "GET", path=path, headers=dict(headers))
        status, out_headers, body = run(
            _middleware(side, kind)(_ok)(request))
        got[side] = (status, out_headers, body,
                     {k: v for k, v in request.context_values.items()})
    assert got["port"] == got["jax"]


def test_tracing_middleware_opens_a_port_span_for_the_engine():
    """The span is the port's current span while the handler runs (the
    engine's ``current_span()`` reads it), parented on an incoming
    ``traceparent``; the response carries its trace id, as JAX's."""
    from gofr_tpu_torch.http.middleware import tracing_middleware
    from gofr_tpu_torch.trace import ListExporter, Tracer, current_span

    exporter = ListExporter()
    tracer = Tracer(exporter=exporter)
    seen = []

    async def handler(request):
        seen.append(current_span())
        return 503, {}, b""

    parent = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    request = _request("port", method="GET", path="/p",
                       headers={"traceparent": parent})
    status, headers, _ = run(tracing_middleware(tracer)(handler)(request))
    tracer.shutdown()
    span = seen[0]
    assert span is not None and span.trace_id == "ab" * 16
    assert span.parent_id == "cd" * 8 and span.name == "GET /p"
    assert headers["X-Trace-Id"] == span.trace_id and status == 503
    assert exporter.spans == [span] and span.status == "ERROR"
    assert current_span() is None


def test_logging_and_metrics_middleware_as_jax():
    got = {}
    for side in SIDES:
        import io
        logging = mod(side, "logging")
        out = io.StringIO()
        logger = logging.Logger(out=out, err=out)
        metrics = mod(side, "metrics").Manager(logger=logger)
        metrics.new_updown_counter("app_http_inflight")
        metrics.new_histogram("app_http_response")
        mw = mod(side, "http.middleware")
        response = mod(side, "http.response")

        async def boom(request):
            raise RuntimeError("x")

        async def streamer(request):
            async def chunks():
                yield "a"
            body = response.StreamBody(chunks(), sse=True)
            return 200, {}, body

        results = []
        for handler, route in ((_ok, "/ok"), (boom, "/boom"),
                               (streamer, "/s")):
            request = _request(side, method="POST", path=route + "/1")
            request.route = route
            wrapped = mw.logging_middleware(logger)(
                mw.metrics_middleware(metrics)(handler))
            status, headers, body = run(wrapped(request))
            if isinstance(body, response.StreamBody):
                body.complete(False, 0)
                body = None
            results.append((status, headers, body))
        lines = [json.loads(line) for line in out.getvalue().splitlines()]
        series = {name: sorted(m.series) for name, m in
                  metrics.snapshot().items()}
        got[side] = (results, [(line["level"], line["message"],
                                line["payload"]["status"],
                                line["payload"]["uri"]) for line in lines
                               if "payload" in line], series)
    assert got["port"] == got["jax"]


# -- the app: built-in handlers, envelopes, metrics, server edges ----------

def make_app(side, config=None):
    cfg = mod(side, "config").MapConfig(dict(config or {}))
    kw = {"device": "cpu"} if side == "port" else {}
    container = mod(side, "container").Container.create(
        cfg, logger=mod(side, "logging").new_silent_logger(), **kw)
    app = mod(side, "app").App(config=cfg, container=container, **kw)
    app.http_port = app.metrics_port = app.grpc_port = 0
    errors = mod(side, "http.errors")
    response = mod(side, "http.response")
    slo = mod(side, "slo")

    async def stream(ctx):
        async def chunks():
            for item in ("a", "b", "[DONE]"):
                yield item
        return response.Stream(chunks(), sse=True)

    def boom(ctx):
        raise RuntimeError("secret detail")

    def deadline(ctx):
        raise slo.DeadlineExceeded()

    def bad(ctx):
        raise errors.InvalidParam(["q"])

    app.get("/hello", lambda ctx: {"message": f"Hello {ctx.param('name')}!"})
    app.get("/users/{id}", lambda ctx: {"id": ctx.path_param("id")})
    app.post("/echo", lambda ctx: ctx.bind())
    app.delete("/users/{id}", lambda ctx: None)
    app.get("/boom", boom)
    app.get("/deadline", deadline)
    app.get("/bad", bad)
    app.get("/raw", lambda ctx: response.Raw([1, 2]))
    app.get("/redirect", lambda ctx: response.Redirect("/hello"))
    app.get("/file", lambda ctx: response.FileResponse(b"\x01\x02",
                                                        "image/png"))
    app.post("/stream", stream)
    return app


async def _raw(port, payload, timeout=10.0, eof=False):
    """Send ``payload``, read to the server's close; ``eof`` half-closes
    first (for a request with no end the server could wait for)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(payload)
    await writer.drain()
    if eof:
        writer.write_eof()
    try:
        return await asyncio.wait_for(reader.read(), timeout)
    finally:
        writer.close()


def _http(method, path, body=b"", headers=None):
    head = f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
    for key, value in (headers or {}).items():
        head += f"{key}: {value}\r\n"
    return (head + f"Content-Length: {len(body)}\r\nConnection: close"
            f"\r\n\r\n").encode() + body


def _normal(raw):
    """Status line, headers (the random trace ids replaced), body."""
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = []
    for line in lines[1:]:
        name, _, value = line.partition(":")
        if name.lower() in ("x-trace-id", "x-correlation-id"):
            value = "<id>"
        headers.append((name, value.strip()))
    return lines[0], headers, body


APP_REQUESTS = [
    ("GET", "/hello?name=TPU", b"", None),
    ("GET", "/users/42", b"", None),
    ("POST", "/echo", b'{"a": [1, 2]}', {"Content-Type": "application/json"}),
    ("POST", "/echo", b"{bad", {"Content-Type": "application/json"}),
    ("POST", "/echo", b"k=v", {"Content-Type":
                               "application/x-www-form-urlencoded"}),
    ("DELETE", "/users/1", b"", None),
    ("GET", "/boom", b"", None),
    ("GET", "/deadline", b"", None),
    ("GET", "/bad", b"", None),
    ("GET", "/raw", b"", None),
    ("GET", "/redirect", b"", None),
    ("GET", "/file", b"", None),
    ("POST", "/stream", b"", None),
    ("GET", "/nowhere", b"", None),
    ("POST", "/hello", b"", None),
    ("OPTIONS", "/users/3", b"", None),
    ("GET", "/.well-known/alive", b"", None),
    ("GET", "/favicon.ico", b"", None),
]


@pytest.mark.parametrize("method,path,body,headers", APP_REQUESTS)
def test_app_answers_as_jax(method, path, body, headers):
    """Status line, headers and body of one request, byte for byte (the
    random trace ids aside): envelopes, errors (a handler's exception
    text is never leaked; ``DeadlineExceeded`` is a 503), 404 and 405,
    the CORS preflight, alive and the favicon."""
    async def main():
        got = {}
        for side in SIDES:
            app = make_app(side)
            await app.start()
            try:
                got[side] = _normal(await _raw(
                    app.bound_http_port, _http(method, path, body, headers)))
            finally:
                await app.stop()
        return got

    got = run(main())
    assert got["port"] == got["jax"]
    assert b"secret detail" not in got["port"][2]


def _key_tree(node):
    if isinstance(node, dict):
        return {k: _key_tree(v) for k, v in node.items()}
    return type(node).__name__


def test_health_key_tree_as_jax():
    async def main():
        got = {}
        for side in SIDES:
            app = make_app(side)
            await app.start()
            try:
                raw = await _raw(app.bound_http_port,
                                 _http("GET", "/.well-known/health"))
            finally:
                await app.stop()
            status, _, body = _normal(raw)
            got[side] = (status, _key_tree(json.loads(body)))
        return got

    got = run(main())
    assert got["port"] == got["jax"]


def _series(text):
    """(sample name, label set) of every sample line; TYPE lines."""
    samples, types = set(), set()
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            types.add(line)
        elif line and not line.startswith("#"):
            name, _, rest = line.partition("{")
            labels = rest.split("}")[0] if rest else ""
            name = name.split()[0]
            pairs = frozenset(
                p.split("=")[0] + ("" if p.split("=")[0] in ("version",)
                                   else "=" + p.split("=", 1)[1])
                for p in labels.split(",") if p)
            samples.add((name, pairs))
    return samples, types


def test_metrics_text_as_jax_after_the_same_requests():
    async def main():
        got = {}
        for side in SIDES:
            app = make_app(side)
            await app.start()
            try:
                for method, path, body, headers in APP_REQUESTS:
                    await _raw(app.bound_http_port,
                               _http(method, path, body, headers))
                raw = await _raw(app.bound_metrics_port
                                 if side == "port" else
                                 app._metrics_server.bound_port,
                                 _http("GET", "/metrics"))
                other = await _raw(app._metrics_server.bound_port,
                                   _http("GET", "/other"))
            finally:
                await app.stop()
            status, headers, body = _normal(raw)
            # the HELP lines (and so the length) are the port's own words
            got[side] = (status, [h for h in headers
                                  if h[0] != "Content-Length"],
                         _series(body.decode()), _normal(other)[0])
        return got

    got = run(main())
    samples = got["port"][2][0]
    assert ("app_http_response_count", frozenset(
        {'method="GET"', 'path="/hello"', 'status="200"'})) in samples
    assert got["port"] == got["jax"]


SERVER_EDGES = [
    b"\x00\xff\x13GARBAGE\r\n\r\n",
    b"GET /hello HTTP/1.1\r\nX-Big: " + b"a" * (65 * 1024),
    b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: 104857600\r\n\r\n",
    b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: banana\r\n\r\n",
    b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: -5\r\n\r\n",
    (b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
     b"Content-Length: 7\r\n\r\n{\"a\":1}GET /hello?name=b HTTP/1.1\r\n"
     b"Host: x\r\nContent-Length: 0\r\n\r\n"),
    b"GET /hello HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
]


@pytest.mark.parametrize("payload", SERVER_EDGES,
                         ids=["garbage", "header_too_large", "body_too_large",
                              "bad_length", "negative_length",
                              "keepalive_pipelined", "connection_close"])
def test_server_edges_as_jax(payload):
    """Hostile bytes and protocol edges over a raw socket: the same
    responses (two pipelined on one keep-alive connection), and the
    server answers a clean request after each."""
    async def main():
        got = {}
        for side in SIDES:
            app = make_app(side)
            await app.start()
            try:
                raw = await asyncio.wait_for(
                    _raw(app.bound_http_port, payload, eof=True), 10.0)
                after = await _raw(app.bound_http_port,
                                   _http("GET", "/hello?name=z"))
            finally:
                await app.stop()
            got[side] = ([_normal(b"HTTP/1.1" + r) for r in
                          raw.split(b"HTTP/1.1")[1:]], _normal(after))
        return got

    got = run(main())
    assert got["port"] == got["jax"]
    assert got["port"][1][0].endswith("200 OK")


def test_sync_handler_sees_the_request_deadline_and_span():
    """A plain ``def`` handler runs in a thread with the port's deadline
    and span contextvars (``asyncio.to_thread``), as JAX's sees its own."""
    seen = {}
    for side in SIDES:
        app = make_app(side)
        slo = mod(side, "slo")
        trace = mod(side, "trace")

        def handler(ctx, side=side, slo=slo, trace=trace):
            seen[side] = (slo.current_deadline() is not None,
                          trace.current_span() is not None)
            return {}

        app.get("/ctx", handler)

        async def main(app=app):
            await app.start()
            try:
                await _raw(app.bound_http_port, _http(
                    "GET", "/ctx", headers={"X-Request-Deadline-Ms": "5000"}))
            finally:
                await app.stop()
        run(main())
    assert seen == {"jax": (True, True), "port": (True, True)}


def test_cron_job_runs_in_a_span_and_is_counted_as_jax():
    got = {}
    for side in SIDES:
        container = mod(side, "container").new_mock_container(
            **({"device": "cpu"} if side == "port" else {}))
        crontab = mod(side, "cron").Crontab(container)
        spans = []

        def ok(ctx, side=side):
            spans.append(mod(side, "trace").current_span().name)
            return ctx.param("x")

        def bad(ctx):
            raise RuntimeError("no")

        crontab.add_job("* * * * *", "ok", ok)
        crontab.add_job("*/5 * * * *", "bad", bad)

        async def main(crontab=crontab):
            for job in crontab.jobs:
                await crontab._run_job(job)
        run(main())
        runs = container.metrics.snapshot()["app_cron_runs_total"].series
        got[side] = (spans, sorted(runs.items()),
                     sorted(container.metrics.snapshot()[
                         "app_cron_duration"].series))
    assert got["port"] == got["jax"]


# -- cron -------------------------------------------------------------------

CRON_SPECS = ["* * * * *", "*/15 9-17 1,15 * 1-5", "0-30/10 * * * *",
              "5 4 * * 0", "59 23 31 12 6", "* * * *", "61 * * * *",
              "* 25 * * *", "x * * * *", "*/0 * * * *", "5-2 * * * *",
              "1-x * * * *", "*/y * * * *", "0 0 0 * *"]


@pytest.mark.parametrize("spec", CRON_SPECS)
def test_cron_parse_as_jax(spec):
    got = {}
    for side in SIDES:
        cron = mod(side, "cron")
        try:
            sched = cron.parse_schedule(spec)
            job = cron.CronJob(spec, "j", lambda ctx: None)
            times = [time.struct_time((2026, 7, d, h, m, 0, (d + 1) % 7,
                                       200, 0))
                     for d in (1, 15, 31) for h in (4, 9, 23)
                     for m in (0, 5, 30, 59)]
            got[side] = (sched, [job.due(t) for t in times])
        except cron.CronParseError as exc:
            got[side] = ("error", str(exc))
    assert got["port"] == got["jax"]


# -- tracing, config, logging, container ------------------------------------

class _Collector(http.server.BaseHTTPRequestHandler):
    received = []

    def do_POST(self):
        length = int(self.headers["Content-Length"])
        _Collector.received.append(json.loads(self.rfile.read(length)))
        self.send_response(202)
        self.end_headers()

    def log_message(self, *args):
        pass


def test_zipkin_export_as_jax():
    """Both exporters post the same Zipkin v2 JSON for the same span to a
    listener on this host; ``new_tracer`` picks the exporter from config
    as JAX's."""
    server = http.server.HTTPServer(("127.0.0.1", 0), _Collector)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/api/v2/spans"
    _Collector.received.clear()
    try:
        for side in SIDES:
            trace = mod(side, "trace")
            tracer = trace.new_tracer(mod(side, "config").MapConfig(
                {"TRACE_EXPORTER": "zipkin", "TRACER_URL": url,
                 "APP_NAME": "svc"}))
            span = trace.Span(None, "op", trace_id="1" * 32,
                              parent_id="2" * 16)
            span.span_id, span.start, span.end = "3" * 16, 100.0, 100.5
            span.set_attribute("k", "v")
            span.add_event("ev", a=1)
            span.events[0]["t"] = 100.25
            span.add_link(trace.Span(None, "x", trace_id="4" * 32))
            span.links[0]["span_id"] = "5" * 16
            tracer._exporter.export([span])
            tracer.shutdown()
            kinds = [type(trace.new_tracer(mod(side, "config").MapConfig(
                {"TRACE_EXPORTER": kind}))._exporter).__name__
                for kind in ("none", "console", "gofr")]
            _Collector.received.append(kinds)
    finally:
        server.shutdown()
    jax_body, jax_kinds, port_body, port_kinds = _Collector.received
    assert port_body == jax_body and port_kinds == jax_kinds
    assert port_body[0]["traceId"] == "1" * 32


def test_zipkin_failure_is_kept_and_logged_at_close():
    """A post that fails is the tracer's ``export_error``; the container's
    close logs it (JAX's exporter drops it)."""
    import io

    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.logging import Logger

    out = io.StringIO()
    container = Container.create(
        MapConfig({"TRACE_EXPORTER": "zipkin",
                   "TRACER_URL": "http://127.0.0.1:9/none"}),
        logger=Logger(out=out, err=out), device="cpu")
    with container.tracer.start_span("op"):
        pass
    run(container.close())
    assert container.tracer.export_error is not None
    assert "trace export failed" in out.getvalue()


def test_config_layers_as_jax(tmp_path, monkeypatch):
    (tmp_path / ".env").write_text(
        "A=1\nexport B='two words'\nC=x # note\n#D=4\nE=\"q\"\nAPP_ENV=stage\n"
        "BAD LINE\nN=7\nF=1.5\nT=yes\n")
    (tmp_path / ".stage.env").write_text("A=staged\n")
    monkeypatch.setenv("B", "from env")
    got = {}
    for side in SIDES:
        config = mod(side, "config").EnvConfig(str(tmp_path))
        got[side] = ([config.get(k) for k in "ABCDE"],
                     config.get_int("N", 0), config.get_int("A", 3),
                     config.get_float("F", 0.0), config.get_bool("T"),
                     config.get_or_default("Z", "dflt"))
    assert got["port"] == got["jax"]


def test_logger_lines_as_jax():
    import io
    got = {}
    for side in SIDES:
        logging = mod(side, "logging")
        out, err = io.StringIO(), io.StringIO()
        logger = logging.Logger(level=logging.Level.INFO, out=out, err=err)
        logger.debug("hidden")
        logger.info("n=%d", 3, extra="x")
        logger.warn("w %s", "a")
        logger.error("e", payload={"k": 1})
        with mod(side, "trace").Tracer().start_span("s"):
            logger.notice("traced")
        lines = [json.loads(x) for x in
                 out.getvalue().splitlines() + err.getvalue().splitlines()]
        got[side] = [(sorted(line), line["level"], line["message"])
                     for line in lines]
    assert got["port"] == got["jax"]


class LevelServer:
    """A local HTTP server answering ``{"level": "DEBUG"}``."""

    def __init__(self):
        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                body = b'{"level": "DEBUG"}'
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/lvl"
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def local_endpoints(key, value):
    """In-process servers for the configuration ``key=value`` and the
    settings that point both containers at them, so no case dials a host
    outside this one: (settings, servers)."""
    from tests.test_pubsub_wire import FakeKafkaBroker, FakeMQTTBroker
    from tests.test_wire_fuzz import FakeRESPServer

    if key == "REDIS_HOST":
        servers = {side: FakeRESPServer() for side in SIDES}
        for server in servers.values():
            server.replies = ["PONG"]               # health()'s PING
        return ({side: {"REDIS_PORT": str(s.port)}
                 for side, s in servers.items()}, list(servers.values()))
    if key == "REMOTE_LOG_URL":
        server = LevelServer()
        settings = {key: server.url, "REMOTE_LOG_FETCH_INTERVAL": "3600"}
        return {side: settings for side in SIDES}, [server]
    if value == "KAFKA":
        server = FakeKafkaBroker()
        settings = {"KAFKA_BROKER": f"127.0.0.1:{server.port}"}
        return {side: settings for side in SIDES}, [server]
    if value == "MQTT":
        server = FakeMQTTBroker()
        settings = {"MQTT_HOST": "127.0.0.1", "MQTT_PORT": str(server.port)}
        return {side: settings for side in SIDES}, [server]
    return {side: {} for side in SIDES}, []


@pytest.mark.parametrize("key,value", [
    ("DB_DIALECT", "mysql"), ("REDIS_HOST", "localhost"),
    ("MONGO_URI", "mongodb://x"), ("CASSANDRA_HOSTS", "h"),
    ("CLICKHOUSE_HOST", "h"), ("REMOTE_LOG_URL", "local level server"),
    ("PUBSUB_BACKEND", "KAFKA"), ("PUBSUB_BACKEND", "MQTT"),
    ("PUBSUB_BACKEND", "GOOGLE")])
def test_container_builds_each_datasource_as_jax(key, value):
    settings, servers = local_endpoints(key, value)
    got = {}
    try:
        for side in SIDES:
            values = dict({key: value}, **settings[side])
            kwargs = {} if side == "jax" else {"device": "cpu"}
            logger = mod(side, "logging").new_silent_logger()
            try:
                container = mod(side, "container").Container.create(
                    mod(side, "config").MapConfig(values), logger=logger,
                    **kwargs)
            except Exception as exc:                      # noqa: BLE001
                got[side] = (type(exc).__name__, str(exc))
                continue
            deadline = time.monotonic() + 5.0
            while key == "REMOTE_LOG_URL" and logger.level.name != "DEBUG" \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
            got[side] = ({name: type(getattr(container, name)).__name__
                          for name in ("sql", "redis", "pubsub", "mongo",
                                       "cassandra", "clickhouse", "file",
                                       "tpu")},
                         logger.level.name,
                         sorted(container.health()))
            run(container.close())
    finally:
        for server in servers:
            (getattr(server, "stop", None) or server.close)()
    assert got["port"] == got["jax"]


def test_container_builds_the_ported_datasources():
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.container import Container
    from gofr_tpu_torch.datasource.pubsub import InMemoryBroker
    from gofr_tpu_torch.logging import new_silent_logger
    from gofr_tpu_torch.tpu import Executor

    container = Container.create(
        MapConfig({"PUBSUB_BACKEND": "INMEM", "TPU_ENABLED": "1"}),
        logger=new_silent_logger(), device="cpu")
    assert isinstance(container.pubsub, InMemoryBroker)
    assert isinstance(container.tpu, Executor)
    assert container.tpu.device.type == "cpu"
    health = container.health()
    assert health["status"] == "UP" and "pubsub" in health
    run(container.close())


def test_file_datasource_as_jax(tmp_path):
    got = {}
    for side in SIDES:
        fs = mod(side, "datasource.file").LocalFileSystem(root=str(tmp_path))
        fs.mkdir(side)
        fs.create(f"{side}/a.jsonl", b'{"x": 1}\n\n{"x": 2}\n')
        fs.create(f"{side}/b.csv", b"a,b\n1,2\n")
        fs.append(f"{side}/b.csv", b"3,4\n")
        fs.create(f"{side}/c.json", b'[{"y": 1}]')
        with pytest.raises(PermissionError):
            fs.read("../outside")
        got[side] = ([list(fs.read_all(f"{side}/{n}"))
                      for n in ("a.jsonl", "b.csv", "c.json")],
                     fs.list(side), fs.health_check()["status"])
    assert got["port"] == got["jax"]


# -- the tokenizer ----------------------------------------------------------

def _corpus(seed, n=60):
    rng = np.random.default_rng(seed)
    words = ["".join(chr(c) for c in rng.integers(97, 105, k))
             for k in rng.integers(1, 7, 40)]
    texts = [" ".join(words[i] for i in rng.integers(0, len(words), 12))
             for _ in range(n)]
    return texts + ["unicode: héllo ☃ ünïcödé", "", "a", "digits 0123456789"]


@pytest.mark.parametrize("seed,vocab", [(0, 256), (1, 300), (2, 420)])
def test_tokenizer_encoders_as_jax(seed, vocab):
    """JAX's trainer and the port's learn the same merges; the port's
    native encoder, its Python encoder and JAX's give the same ids, and
    the same text back."""
    from gofr_tpu.tokenizer import Tokenizer as JaxTokenizer

    from gofr_tpu_torch.tokenizer import Tokenizer

    corpus = _corpus(seed)
    jax_tok = JaxTokenizer.train(corpus, vocab_size=vocab)
    port_tok = Tokenizer.train(corpus, vocab_size=vocab)
    assert port_tok.merges == jax_tok.merges
    python = Tokenizer(port_tok.merges, native=False)
    assert port_tok.encoder == "native" and python.encoder == "python"
    for text in _corpus(seed + 100, 20):
        ids = jax_tok.encode(text)
        assert port_tok.encode(text) == ids
        assert python.encode(text) == ids
        assert port_tok.decode(ids) == python.decode(ids) \
            == jax_tok.decode(ids) == text


def test_tokenizer_builds_into_the_build_dir_and_logs_its_encoder(tmp_path):
    import io

    from gofr_tpu_torch import native
    from gofr_tpu_torch.logging import Logger
    from gofr_tpu_torch.tokenizer import Tokenizer

    assert native.load_tokenizer_lib() is not None
    assert native.build_error() is None
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "gofr_tpu_torch")
    assert not (native.SOURCE.parent / "_tokenizer.so").exists()
    out = io.StringIO()
    tok = Tokenizer.train(_corpus(3), vocab_size=280)
    tok.save(str(tmp_path / "t.json"))
    loaded = Tokenizer.load(str(tmp_path / "t.json"),
                            logger=Logger(out=out, err=out))
    assert loaded.merges == tok.merges
    assert "native BPE encoder (24 merges)" in out.getvalue()
    Tokenizer(logger=Logger(out=out, err=out), native=False)
    assert "Python BPE encoder" in out.getvalue()


def test_tokenizer_python_encoder_serves_without_a_library(monkeypatch):
    from gofr_tpu_torch import native
    from gofr_tpu_torch.tokenizer import Tokenizer

    monkeypatch.setattr(native, "_CACHE", {"lib": None,
                                           "error": "g++ not found"})
    tok = Tokenizer.train(_corpus(4), vocab_size=290)
    assert tok.encoder == "python"
    ids = tok.encode("abc abc abc")
    assert tok.decode(ids) == "abc abc abc"
    assert native.build_error() == "g++ not found"


# -- the app's device ------------------------------------------------------

def test_app_executor_defaults_to_the_card_and_add_model_uses_it():
    import torch

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.container import new_mock_container

    app = App(config=MapConfig({}), container=new_mock_container())
    assert app.container.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            app.add_model("m", lambda p, x: x, {})
    cpu = App(config=MapConfig({}), container=new_mock_container(),
              device="cpu")
    cpu.add_model("m", lambda p, x: {"y": x * 2}, {})
    assert cpu.container.tpu.device.type == "cpu"
    out = cpu.container.tpu.predict("m", np.ones((3, 2), np.float32))
    assert np.asarray(out["y"]).tolist() == [[2.0, 2.0]] * 3


def test_context_predict_without_a_batcher_as_jax():
    """``ctx.predict`` with no batcher runs one direct predict of a batch
    of one through the port's tree map, as JAX's does through
    ``jax.tree.map``."""
    import jax.numpy as jnp

    from gofr_tpu.context import Context as JaxContext
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu.tpu import new_executor as jax_executor
    from gofr_tpu_torch.context import Context
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.tpu import Executor

    w = np.arange(6, dtype=np.float32).reshape(3, 2)
    example = {"x": np.array([1.0, 2.0, 3.0], np.float32),
               "s": np.array(0.5, np.float32)}
    jc = jax_container()
    jc.tpu = jax_executor(jc.config, jc.logger, jc.metrics)
    jc.tpu.register("m", lambda p, b: {"y": (b["x"] @ p["w"])
                                       * b["s"][:, None]},
                    {"w": jnp.asarray(w)}, buckets=(1,))
    pc = new_mock_container(device="cpu")
    pc.tpu = Executor(pc.logger, pc.metrics, device="cpu")
    pc.tpu.register("m", lambda p, b: {"y": (b["x"] @ p["w"])
                                       * b["s"][:, None]},
                    {"w": w}, buckets=(1,))

    async def main():
        return (await JaxContext(None, jc).predict("m", example),
                await Context(None, pc).predict("m", example))

    jax_out, port_out = run(main())
    np.testing.assert_allclose(np.asarray(port_out["y"]),
                               np.asarray(jax_out["y"]), rtol=1e-6)
    assert np.asarray(port_out["y"]).shape == (2,)
