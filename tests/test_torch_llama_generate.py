"""The JAX example (``examples/llama-generate/main.py``) and the port's
(``gofr_tpu_torch/examples/llama_generate.py``) side by side on the CPU
at ``LLAMA_PRESET=tiny``, ``GENERATE_SLOTS=2``, both at float32 (the
test patches the preset's dtype in both packages) on the same weights
(the port's weight source is JAX's ``llama.init`` through
``convert.from_jax_llama``). Each app runs on an event loop of its own
thread for the module; each case sends the same requests to both.

- greedy and fixed-seed sampled ``POST /generate``: equal tokens and
  completions; the SSE frames are JAX's and end with ``[DONE]``; the gRPC
  stream gives JAX's tokens;
- ``/v1/{model}/generate`` over ``MODELS=a=tiny>b,b=tiny`` routes as
  JAX's; bad bodies, unknown models and routes give JAX's status codes
  and envelopes; ``/.well-known/health`` has JAX's key tree;
- the deadline bridge: ``X-Request-Deadline-Ms: 1`` behind two busy
  slots is shed with 503 and counted ``expired``, as JAX's app does;
- one trace: the engine's flight record of an HTTP request carries the
  request span's trace id;
- a client that disconnects mid-SSE frees its slot;
- ``app.add_model`` + ``ctx.predict`` through ``App.start``'s batcher
  give JAX's results.
"""

import asyncio
import dataclasses
import importlib.util
import json
import os
import threading
import time

import numpy as np
import pytest

ENV = {"LLAMA_PRESET": "tiny", "GENERATE_SLOTS": "2", "STEPS_PER_TICK": "4",
       "LOG_LEVEL": "FATAL"}
# knobs the examples read, and datasources another test's example may
# have left in the environment (the port refuses those it lacks)
UNSET = ("MODELS", "GENERATE_DRAFT_MODEL", "LLAMA_KV_INT8",
         "GENERATE_PAGED_KV", "CLUSTER_PEERS", "MESH", "TPU_MESH",
         "BATCH_LANE_TOPIC", "PUBSUB_BACKEND", "FAULT_PLAN", "FLEET_ROUTING",
         "GENERATE_PREFIX_CACHE", "TRACE_EXPORTER", "CLUSTER_ROLE",
         "DB_DIALECT", "REDIS_HOST", "MONGO_URI", "CASSANDRA_HOSTS",
         "CLICKHOUSE_HOST", "REMOTE_LOG_URL", "TPU_ENABLED")
ROOT = os.path.join(os.path.dirname(__file__), "..")


class LoopThread:
    """An event loop on a thread of its own: an app started there keeps
    serving between the test's calls."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout=300):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        assert not self.thread.is_alive()
        self.loop.close()


def _load_jax_example():
    path = os.path.join(ROOT, "examples", "llama-generate", "main.py")
    spec = importlib.util.spec_from_file_location(
        "jax_llama_generate_example", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_weights(module, cfg, seed):
    """The port's weight source: JAX's ``init`` of the same config."""
    import jax
    import jax.numpy as jnp

    from gofr_tpu.models import llama as jax_llama
    from gofr_tpu_torch.models import llama as pt_llama
    from gofr_tpu_torch.models.convert import from_jax_llama

    assert module is pt_llama, "the cases serve llama presets only"
    jcfg = jax_llama.LlamaConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name != "dtype"}, dtype=jnp.float32)
    params = jax.tree.map(np.asarray,
                          jax_llama.init(jcfg, jax.random.PRNGKey(seed)))
    return from_jax_llama(params, device="cpu")


def _build_pair(env):
    """Both apps built under ``env`` at float32, ports 0."""
    import jax.numpy as jnp
    import torch

    from gofr_tpu.models import llama as jax_llama
    from gofr_tpu_torch.examples import llama_generate
    from gofr_tpu_torch.models import llama as pt_llama

    with pytest.MonkeyPatch.context() as mp:
        for key in UNSET:
            mp.delenv(key, raising=False)
        for key, value in env.items():
            mp.setenv(key, value)
        mp.setitem(jax_llama.PRESETS, "tiny", dataclasses.replace(
            jax_llama.PRESETS["tiny"], dtype=jnp.float32))
        mp.setitem(pt_llama.PRESETS, "tiny", dataclasses.replace(
            pt_llama.PRESETS["tiny"], dtype=torch.float32))
        apps = {"jax": _load_jax_example().build_app(),
                "port": llama_generate.build_app(device="cpu",
                                                 params_fn=_jax_weights)}
    for app in apps.values():
        app.http_port = app.metrics_port = app.grpc_port = 0
    return apps


@pytest.fixture(scope="module")
def served():
    loop = LoopThread()
    apps = _build_pair(ENV)
    try:
        for app in apps.values():
            loop.run(app.start())
        yield loop, apps
    finally:
        for app in apps.values():
            loop.run(app.stop())
        loop.close()


# -- a small HTTP client ----------------------------------------------------

async def _request(port, method, path, body=None, headers=None):
    data = json.dumps(body).encode() if isinstance(body, dict) else (
        body or b"")
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    head = f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
    for key, value in {"Content-Type": "application/json",
                       **(headers or {})}.items():
        head += f"{key}: {value}\r\n"
    writer.write((head + f"Content-Length: {len(data)}\r\nConnection: close"
                  f"\r\n\r\n").encode() + data)
    raw = await reader.read()
    writer.close()
    blob, _, payload = raw.partition(b"\r\n\r\n")
    lines = blob.decode("latin-1").split("\r\n")
    out_headers = {k.strip().lower(): v.strip() for k, _, v in
                   (line.partition(":") for line in lines[1:])}
    if out_headers.get("transfer-encoding") == "chunked":
        chunks, rest = [], payload
        while rest:
            size_line, _, rest = rest.partition(b"\r\n")
            size = int(size_line, 16)
            if size == 0:
                break
            chunks.append(rest[:size].decode())
            rest = rest[size + 2:]
        payload = [c[len("data: "):].rstrip("\n") for c in chunks]
    return int(lines[0].split()[1]), out_headers, payload


def _both(served, method, path, body=None, headers=None):
    loop, apps = served
    return {side: loop.run(_request(app.bound_http_port, method, path, body,
                                    headers))
            for side, app in apps.items()}


def _data(result):
    return json.loads(result[2])["data"]


# -- generation ---------------------------------------------------------------

@pytest.mark.parametrize("body", [
    {"prompt": "hi", "max_new_tokens": 6},
    {"prompt": "the quick brown fox jumps", "max_new_tokens": 12},
    {"prompt": "x" * 100, "max_new_tokens": 3},
    {"prompt": "sampled", "max_new_tokens": 10, "temperature": 0.8,
     "top_k": 40, "top_p": 0.95, "seed": 7},
    {"prompt": "sampled hot", "max_new_tokens": 8, "temperature": 1.3,
     "seed": 11},
], ids=["greedy_short", "greedy", "greedy_long_prompt", "sampled",
        "sampled_hot"])
def test_generate_as_jax(served, body):
    got = _both(served, "POST", "/generate", body)
    assert got["port"][0] == got["jax"][0] == 201
    port, jax = _data(got["port"]), _data(got["jax"])
    assert port["tokens"] == jax["tokens"]
    assert len(port["tokens"]) == body["max_new_tokens"]
    assert port["completion"] == jax["completion"]
    assert port["model"] == jax["model"] == "generate"
    assert set(jax["engine"]) <= set(port["engine"])


@pytest.mark.parametrize("body", [
    {"prompt": "stream me", "max_new_tokens": 7},
    {"prompt": "stream sampled", "max_new_tokens": 6, "temperature": 0.7,
     "seed": 3}], ids=["greedy", "sampled"])
def test_sse_frames_as_jax(served, body):
    got = _both(served, "POST", "/generate/stream", body)
    for side in ("jax", "port"):
        status, headers, frames = got[side]
        assert status == 200
        assert headers["content-type"] == "text/event-stream"
        assert frames[-1] == "[DONE]"
    assert got["port"][2] == got["jax"][2]
    unary = _data(_both(served, "POST", "/generate", body)["port"])
    assert [json.loads(f)["token"] for f in got["port"][2][:-1]] \
        == unary["tokens"]


def test_grpc_stream_as_jax(served):
    import grpc

    loop, apps = served

    async def call(port, body):
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as channel:
            method = channel.unary_stream("/gofr.Llama/generate")
            return [json.loads(raw)["data"] async for raw in
                    method(json.dumps(body).encode())]

    body = {"prompt": "abc", "max_new_tokens": 5}
    got = {side: loop.run(call(app._grpc_server.bound_port, body))
           for side, app in apps.items()}
    assert got["port"] == got["jax"] and len(got["port"]) == 5

    async def refused(port):
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as channel:
            method = channel.unary_stream("/gofr.Llama/generate")
            with pytest.raises(grpc.aio.AioRpcError) as info:
                async for _ in method(json.dumps(
                        {"prompt": "x" * 600, "max_new_tokens": 200})
                        .encode()):
                    pass
            return info.value.code()

    codes = {side: loop.run(refused(app._grpc_server.bound_port))
             for side, app in apps.items()}
    assert codes["port"] == codes["jax"] == grpc.StatusCode.INVALID_ARGUMENT
    for app in apps.values():
        series = app.container.metrics.snapshot()[
            "app_http_service_response"].series
        assert {dict(k)["status"] for k in series
                if dict(k).get("method") == "/gofr.Llama/generate"} \
            == {"OK", "ERROR"}


ERROR_PROBES = [
    ("POST", "/generate", b"{not json"),
    ("POST", "/generate", {"max_new_tokens": 3}),
    ("POST", "/generate", {"prompt": "x", "max_new_tokens": "many"}),
    ("POST", "/generate", {"prompt": "x", "response_format": "json"}),
    ("POST", "/generate", {"prompt": "x", "max_new_tokens": 500}),
    ("POST", "/generate/stream", {"prompt": "x" * 600}),
    ("POST", "/v1/other/generate", {"prompt": "x", "max_new_tokens": 2}),
    ("GET", "/generate", None),
    ("POST", "/no/such/route", {"prompt": "x"}),
    ("GET", "/.well-known/alive", None),
    ("POST", "/disagg/drain", {"replica": "nope"}),
    ("GET", "/disagg/fetch?handoff=missing", None),
]


@pytest.mark.parametrize("method,path,body", ERROR_PROBES)
def test_error_probes_as_jax(served, method, path, body):
    got = _both(served, method, path, body)
    assert got["port"][0] == got["jax"][0]
    assert got["port"][2] == got["jax"][2]


@pytest.mark.parametrize("path", ["/generate", "/generate/stream"])
@pytest.mark.parametrize("body", [{"prompt": "x", "max_new_tokens": 0},
                                  {"prompt": "", "max_new_tokens": 2}],
                         ids=["no_tokens", "empty_prompt"])
def test_engine_refusals_are_400s_where_jax_serves(served, path, body):
    """A recorded divergence (ROADMAP.md §3): the port's engine refuses a
    budget under 1 and an empty prompt (``ValueError``, a 400 through the
    app) where JAX's admits them."""
    got = _both(served, "POST", path, body)
    assert got["port"][0] == 400
    assert got["jax"][0] in (200, 201)
    assert "error" in json.loads(got["port"][2])


def _key_tree(node):
    if isinstance(node, dict):
        return {k: _key_tree(v) for k, v in node.items()}
    return type(node).__name__


def test_health_key_tree_as_jax(served):
    got = _both(served, "GET", "/.well-known/health")
    trees = {side: _key_tree(json.loads(r[2])) for side, r in got.items()}
    assert got["port"][0] == got["jax"][0] == 200
    # the engine's health details are the engines' own (their stats trees
    # are held in tests/test_torch_telemetry.py); the rest is JAX's
    for tree in trees.values():
        tree["tpu"].pop("details", None)
    assert trees["port"] == trees["jax"]
    assert json.loads(got["port"][2])["status"] == "UP"


def test_metric_names_as_jax_after_the_requests(served):
    loop, apps = served
    names = {}
    for side, app in apps.items():
        port = app._metrics_server.bound_port
        status, _, text = loop.run(_request(port, "GET", "/metrics"))
        assert status == 200
        names[side] = {line.split()[2] for line in text.decode().splitlines()
                       if line.startswith("# TYPE")}
    assert names["port"] == names["jax"]


# -- the deadline bridge, one trace, a disconnect ----------------------------

async def _sse_first_frame(port, body):
    """Open an SSE stream and read up to its first frame; returns the
    streams (to read the rest or drop)."""
    data = json.dumps(body).encode()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write((f"POST /generate/stream HTTP/1.1\r\nHost: x\r\n"
                  f"Content-Type: application/json\r\nContent-Length: "
                  f"{len(data)}\r\nConnection: close\r\n\r\n").encode()
                 + data)
    await reader.readuntil(b"\r\n\r\n")
    size = int((await reader.readuntil(b"\r\n")).strip(), 16)
    await reader.readexactly(size + 2)
    return reader, writer


def test_deadline_bridge_sheds_with_503_as_jax(served):
    """Both slots busy with long streams, a request with a 1 ms budget
    waits for a slot and is shed before prefill: 503 with JAX's body,
    ``app_tpu_slo_total{outcome="expired"}`` one more, and the streams
    finish whole."""
    loop, apps = served

    async def probe(app):
        port = app.bound_http_port
        metrics = app.container.metrics
        expired0 = metrics.value("app_tpu_slo_total", outcome="expired") or 0
        busy = await asyncio.gather(*[
            _sse_first_frame(port, {"prompt": f"busy {i}",
                                    "max_new_tokens": 110})
            for i in range(2)])
        shed = await _request(port, "POST", "/generate",
                              {"prompt": "late", "max_new_tokens": 4},
                              headers={"X-Request-Deadline-Ms": "1"})
        rest = [await reader.read() for reader, _ in busy]
        for _, writer in busy:
            writer.close()
        expired = metrics.value("app_tpu_slo_total", outcome="expired") or 0
        return shed[0], shed[2], expired - expired0, [
            r.count(b"data: ") for r in rest]

    got = {side: loop.run(probe(app)) for side, app in apps.items()}
    assert got["port"] == got["jax"]
    status, body, expired, frames = got["port"]
    assert status == 503 and "deadline" in json.loads(body)["error"][
        "message"]
    assert expired == 1 and frames == [110, 110]  # 109 tokens + [DONE]


def test_one_trace_id_spans_the_request_and_the_engine(served):
    loop, apps = served
    for side, app in apps.items():
        status, headers, _ = loop.run(_request(
            app.bound_http_port, "POST", "/generate",
            {"prompt": "traced", "max_new_tokens": 3}))
        assert status == 201
        trace_id = headers["x-trace-id"]
        assert headers["x-correlation-id"] == trace_id
        records = app.engine.recorder.find(trace_id) if side == "port" \
            else app.container.tpu.recorder.find(trace_id)
        assert len(records) == 1, side
        assert records[0]["trace_id"] == trace_id
        assert records[0]["status"] == "done"


def test_disconnect_mid_stream_frees_the_slot(served):
    loop, apps = served

    async def drop(app, engine):
        reader, writer = await _sse_first_frame(
            app.bound_http_port, {"prompt": "bye", "max_new_tokens": 100})
        writer.close()
        t0 = time.monotonic()
        while time.monotonic() - t0 < 30:
            stats = engine.stats()
            if stats["free_slots"] == engine.max_slots \
                    and stats["active_slots"] == 0:
                return time.monotonic() - t0, engine.recorder.snapshot()[
                    "recent"][0]["status"]
            await asyncio.sleep(0.02)
        raise AssertionError("the slot was not freed")

    for side, app in apps.items():
        engine = app.engine if side == "port" else app.container.tpu
        freed_s, status = loop.run(drop(app, engine))
        assert status == "cancelled", side


# -- MODELS= routing -----------------------------------------------------------

def test_models_registry_routes_as_jax():
    """``MODELS=a=tiny>b,b=tiny``: each route's tokens, the default, the
    unknown model and the DEGRADED fallback as JAX's."""
    loop = LoopThread()
    apps = _build_pair(dict(ENV, MODELS="a=tiny>b,b=tiny"))
    try:
        for app in apps.values():
            loop.run(app.start())
        served = (loop, apps)
        body = {"prompt": "route me", "max_new_tokens": 5}
        for path in ("/generate", "/v1/a/generate", "/v1/b/generate",
                     "/v1/zz/generate"):
            got = _both(served, "POST", path, body)
            assert got["port"][0] == got["jax"][0], path
            if got["port"][0] == 201:
                port, jax = _data(got["port"]), _data(got["jax"])
                assert (port["tokens"], port["model"]) \
                    == (jax["tokens"], jax["model"]), path
            else:
                assert got["port"][2] == got["jax"][2], path
        stream = _both(served, "POST", "/v1/b/generate/stream", body)
        assert stream["port"][2] == stream["jax"][2]
        for app in apps.values():
            app.container.tpu.watchdog = type(
                "W", (), {"state": "DEGRADED"})()
        got = _both(served, "POST", "/v1/a/generate", body)
        assert _data(got["port"])["model"] == _data(got["jax"])["model"] \
            == "b"
    finally:
        for app in apps.values():
            loop.run(app.stop())
        loop.close()


# -- add_model + ctx.predict through the batcher --------------------------

def test_add_model_predict_through_the_batcher_as_jax():
    import jax.numpy as jnp

    from gofr_tpu.app import App as JaxApp
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.container import new_mock_container

    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    xs = rng.standard_normal((5, 4)).astype(np.float32)
    apps = {"jax": JaxApp(container=jax_container()),
            "port": App(container=new_mock_container(), device="cpu")}
    apps["jax"].add_model("lin", lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
                          {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                          buckets=(1, 4, 8))
    import torch
    apps["port"].add_model("lin", lambda p, x: torch.tanh(x @ p["w"]
                                                          + p["b"]),
                           {"w": w, "b": b}, buckets=(1, 4, 8))
    for app in apps.values():
        app.http_port = app.metrics_port = 0

        async def predict(ctx):
            x = np.asarray(ctx.bind()["x"], np.float32)
            return {"y": np.asarray(await ctx.predict("lin", x)).tolist()}
        app.post("/predict", predict)

    async def main(app):
        await app.start()
        try:
            return await asyncio.gather(*[
                _request(app.bound_http_port, "POST", "/predict",
                         {"x": x.tolist()}) for x in xs])
        finally:
            await app.stop()

    got = {side: asyncio.run(main(app)) for side, app in apps.items()}
    ys = {side: np.array([json.loads(r[2])["data"]["y"] for r in results])
          for side, results in got.items()}
    assert all(r[0] == 201 for r in got["port"])
    np.testing.assert_allclose(ys["port"], ys["jax"], rtol=1e-5, atol=1e-6)
    flushes = apps["port"].container.metrics.snapshot()[
        "app_tpu_flush_total"].series
    assert sum(flushes.values()) >= 1
