"""The port's examples (``gofr_tpu_torch/examples``) on the CPU, each case
of JAX's ``tests/test_examples.py`` run against the port's example.
Where JAX's example needs no model, the same requests go to JAX's
example too and the responses must be equal (status line, headers with
the random trace ids replaced, body). The model examples run at their
``tiny`` presets on weights made in JAX's layout (seeded numpy leaves of
``jax.eval_shape`` of JAX's ``init``; no JAX model is compiled) and
converted by ``models/convert.py``: each answer equals the port's model
on the same weights and input, which ``tests/test_torch_vision_text.py``
holds to JAX's."""

import asyncio
import base64
import importlib
import importlib.util
import io
import json
import os
import struct
import sys
import zipfile

import numpy as np
import pytest
import torch

from tests.test_torch_framework_rest import http, mock_app, normal, raw_call

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JSON = {"Content-Type": "application/json"}


def run(coro):
    return asyncio.run(coro)


def _warm_torch_cpu():
    """The process's one-time costs of the port's CPU path (oneDNN's
    first bfloat16 convolution, ``FlopCounterMode``'s first use, about 3 s
    together), paid once at collection as the torch import is."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False):
        torch.nn.functional.conv2d(torch.ones((1, 3, 4, 4), dtype=torch.bfloat16),
                                   torch.ones((2, 3, 3, 3), dtype=torch.bfloat16))


_warm_torch_cpu()


def jax_example(name):
    """JAX's ``examples/<name>/main.py`` as a fresh module."""
    path = os.path.join(ROOT, "examples", name, "main.py")
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name.replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def port_example(name):
    """The port's example module, imported anew (module-level apps are
    built again)."""
    full = f"gofr_tpu_torch.examples.{name}"
    sys.modules.pop(full, None)
    return importlib.import_module(full)


def zero_ports(app):
    app.http_port = app.metrics_port = app.grpc_port = 0
    return app


async def calls(app, requests):
    """Start ``app``, send each (method, path, body) with
    ``Connection: close``, stop; the normalized responses."""
    await app.start()
    try:
        out = []
        for method, path, body in requests:
            data = body if isinstance(body, bytes) else (
                json.dumps(body).encode() if body is not None else b"")
            out.append(normal(await raw_call(
                app.bound_http_port, http(method, path, data, JSON))))
        return out
    finally:
        await app.stop()


def jax_layout(init, cfg, seed):
    """Seeded numpy leaves in the tree ``init(cfg, key)`` returns (its
    shapes and dtypes from ``jax.eval_shape``): weights scaled by their
    fan-in, scales near 1."""
    import jax
    import jax.numpy as jnp

    # an abstract key: nothing runs on a JAX device
    shapes = jax.eval_shape(lambda key: init(cfg, key),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        name = str(path[-1])
        x = rng.standard_normal(spec.shape).astype(np.float32)
        if len(spec.shape) >= 2 and "emb" not in name:
            x /= np.sqrt(np.prod(spec.shape[:-1]) / (
                spec.shape[0] if "layers" in str(path[0]) else 1))
        else:
            x *= 0.1
        if "scale" in name or "norm_w" in name:
            x += 1.0
        return np.asarray(x, dtype=spec.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def resnet_params(seed=5):
    from gofr_tpu.models import resnet as jax_resnet
    from gofr_tpu_torch.models.convert import from_jax_resnet
    return from_jax_resnet(jax_layout(jax_resnet.init,
                                      jax_resnet.config("tiny"), seed), "cpu")


def bert_params(seed=6):
    from gofr_tpu.models import bert as jax_bert
    from gofr_tpu_torch.models.convert import from_jax_bert
    return from_jax_bert(jax_layout(jax_bert.init, jax_bert.config(
        "tiny", max_len=64), seed), "cpu")


def image(seed, size=32):
    return np.random.default_rng(seed).standard_normal(
        (size, size, 3)).astype(np.float32)


def resnet_logits(params, x):
    from gofr_tpu_torch.models import resnet
    return resnet.apply(params, resnet.config("tiny"),
                        torch.from_numpy(x[None]))[0].numpy()


# -- the model examples ------------------------------------------------------------

HTTP_SERVER_REQUESTS = [
    ("GET", "/hello?name=TPU", None), ("GET", "/hello", None),
    ("GET", "/user/1", None), ("GET", "/user/2", None),
    ("POST", "/user", {"name": "ada", "age": 36}),
    ("POST", "/user", b"{bad"), ("GET", "/nowhere", None),
    ("POST", "/hello", None), ("GET", "/.well-known/alive", None),
]


def test_http_server_example_hello_and_classify(monkeypatch):
    """Its routes answer as JAX's handlers do; ``/classify`` (201) gives
    the label and score of the port's ResNet on the same weights and
    image."""
    monkeypatch.setenv("RESNET_PRESET", "tiny")
    jm = jax_example("http-server")
    jax_app = mock_app("jax")
    jax_app.get("/hello", jm.hello)
    jax_app.get("/user/{id}", jm.get_user)
    jax_app.post("/user", jm.create_user)
    params = resnet_params()
    pm = port_example("http_server")
    seen = []

    def params_fn(module, cfg, seed):
        seen.append((module.__name__, cfg.image_size, seed))
        return params

    app = zero_ports(pm.build_app(device="cpu", params_fn=params_fn))
    assert seen == [("gofr_tpu_torch.models.resnet", 32, 0)]
    assert app.config.get("APP_NAME") == "http-server-example"
    x = image(11)
    want = resnet_logits(params, x)
    got = run(calls(app, HTTP_SERVER_REQUESTS + [
        ("POST", "/classify", {"image": x.tolist()})]))
    assert got[:-1] == run(calls(jax_app, HTTP_SERVER_REQUESTS))
    status, _, body = got[-1]
    data = json.loads(body)["data"]
    assert status == "HTTP/1.1 201 Created"
    assert data["label"] == int(np.argmax(want))
    assert data["score"] == pytest.approx(float(want.max()), rel=1e-6)
    assert app.container.tpu.ledger.total("warmup") == 4
    assert app.container.tpu.ledger.total() == 4


def test_grpc_server_example_embeddings(monkeypatch):
    """``/gofr.Embeddings/embed`` gives the port's BERT mean embedding of
    the same weights and tokens (64 values at ``tiny``)."""
    import grpc

    from gofr_tpu_torch.models import bert

    monkeypatch.setenv("BERT_PRESET", "tiny")
    params = bert_params()
    pm = port_example("grpc_server")
    app = zero_ports(pm.build_app(device="cpu",
                                  params_fn=lambda m, c, s: params))
    tokens = [1, 2, 3, 200, 7]
    ids = np.zeros((1, 64), np.int32)
    mask = np.zeros((1, 64), np.int32)
    ids[0, :5], mask[0, :5] = tokens, 1
    want = bert.apply(params, bert.config("tiny", max_len=64),
                      torch.from_numpy(ids), torch.from_numpy(mask))["mean"]

    async def main():
        await app.start()
        try:
            port = app.bound_grpc_port
            async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
                raw = await ch.unary_unary("/gofr.Embeddings/embed")(
                    json.dumps({"token_ids": tokens}).encode())
            return json.loads(raw)["data"]["embedding"]
        finally:
            await app.stop()

    embedding = run(main())
    assert len(embedding) == 64
    np.testing.assert_allclose(embedding, want[0].numpy(), rtol=1e-6,
                               atol=1e-6)


def test_grpc_server_example_without_grpcio(monkeypatch, capsys):
    """Where ``grpcio`` is missing the route is not registered, and the
    app says so."""
    monkeypatch.setenv("BERT_PRESET", "tiny")
    pm = port_example("grpc_server")
    params = bert_params()
    monkeypatch.setattr(pm, "grpc_available", lambda: False)
    app = pm.build_app(device="cpu", params_fn=lambda m, c, s: params)
    assert app._grpc_services == []
    assert "gRPC is off" in capsys.readouterr().out
    monkeypatch.setattr(pm, "grpc_available", lambda: True)
    app = pm.build_app(device="cpu", params_fn=lambda m, c, s: params)
    assert [spec for spec, _ in app._grpc_services] == [
        ("dynamic", "Embeddings", "embed")]


def test_subscriber_example_classifies_and_publishes(monkeypatch):
    monkeypatch.setenv("RESNET_PRESET", "tiny")
    monkeypatch.setenv("PUBSUB_BACKEND", "INMEM")
    params = resnet_params()
    pm = port_example("using_subscriber")
    app = zero_ports(pm.build_app(device="cpu",
                                  params_fn=lambda m, c, s: params))
    assert "images" in app._subscriptions
    x = image(12)

    async def main():
        await app.start()
        try:
            app.container.pubsub.publish("images", json.dumps(
                {"id": "a", "image": x.tolist()}).encode())
            result = await asyncio.wait_for(
                app.container.pubsub.subscribe("labels"), 10.0)
            return json.loads(result.value)
        finally:
            await app.stop()

    got = run(main())
    assert got == {"id": "a", "label": int(np.argmax(resnet_logits(params,
                                                                   x)))}
    assert app.container.tpu.ledger.total() == 3


def test_cmd_example_hello_classify_and_unknown():
    """``hello`` and an unknown command print and return as JAX's
    example does; ``classify`` on the CPU gives the tiny ResNet's label
    of its seeded image."""
    from gofr_tpu.cli import run_cli as jax_run_cli
    from gofr_tpu_torch.cli import run_cli
    from gofr_tpu_torch.models import resnet

    jm = jax_example("cmd")
    pm = port_example("cmd")
    assert pm.app.container.device == "cuda"
    for argv in (["hello", "-name=cli"], ["hello"], ["nosuch"], ["-h"]):
        got = {}
        for side, fn, app in (("jax", jax_run_cli, jm.app),
                              ("port", run_cli, pm.app)):
            out, err = io.StringIO(), io.StringIO()
            got[side] = (fn(app, argv, stdout=out, stderr=err),
                         out.getvalue(), err.getvalue())
        assert got["port"] == got["jax"]
    assert "Hello cli!" in got["port"][1] or argv == ["-h"]
    out = io.StringIO()
    assert run_cli(pm.build_app(device="cpu"), ["classify"], stdout=out) == 0
    cfg = resnet.config("tiny")
    x = np.random.default_rng(0).standard_normal(
        (cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    want = resnet_logits(resnet.init(cfg, 0, device="cpu"), x)
    assert json.loads(out.getvalue()) == {"label": int(want.argmax())}


# -- the framework examples ----------------------------------------------------------

async def ws_connect(port, key):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write((
        "GET /chat HTTP/1.1\r\nHost: x\r\n"
        "Upgrade: websocket\r\nConnection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\n"
        "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    return normal(head), reader, writer


async def ws_frame(reader, decode):
    buffer = b""
    while True:
        frame = decode(buffer)
        if frame is not None:
            return frame[:3]
        buffer += await asyncio.wait_for(reader.read(4096), 10.0)


def test_websocket_chat_example_broadcast():
    """Two clients each get the welcome; a message from one reaches both
    through the hub; the frames are JAX's bytes; shutdown reaps both
    live connections."""
    keys = [base64.b64encode(bytes([i]) * 16).decode() for i in (1, 2)]

    async def main(side, app, frames):
        zero_ports(app)
        await app.start()
        try:
            port = app.bound_http_port
            c1 = await ws_connect(port, keys[0])
            c2 = await ws_connect(port, keys[1])
            got = [c1[0], c2[0], await ws_frame(c1[1], frames.decode_frame),
                   await ws_frame(c2[1], frames.decode_frame)]
            c1[2].write(frames.encode_frame(frames.OP_TEXT, b"hi all",
                                            mask=True))
            await c1[2].drain()
            got += [await ws_frame(c1[1], frames.decode_frame),
                    await ws_frame(c2[1], frames.decode_frame)]
        finally:
            await asyncio.wait_for(app.stop(), 15.0)
        got.append([await asyncio.wait_for(c[1].read(), 10) for c in
                    (c1, c2)])
        return got

    import gofr_tpu.websocket.frames as jax_frames
    import gofr_tpu_torch.websocket.frames as frames
    got = {"jax": run(main("jax", jax_example("websocket-chat").app,
                           jax_frames)),
           "port": run(main("port", port_example("websocket_chat").app,
                            frames))}
    assert got["port"] == got["jax"]
    assert json.loads(got["port"][2][2]) == {"system": "welcome"}
    assert json.loads(got["port"][5][2]) == {"message": "hi all"}


def _zip(members):
    buffer = io.BytesIO()
    with zipfile.ZipFile(buffer, "w") as archive:
        for name, content in members:
            archive.writestr(name, content)
    return buffer.getvalue()


def multipart(boundary, fields, files):
    body = b""
    for name, value in fields:
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="{name}"\r\n\r\n{value}\r\n').encode()
    for name, filename, ctype, blob in files:
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="{name}"; filename="{filename}"\r\n'
                 f"Content-Type: {ctype}\r\n\r\n").encode() + blob + b"\r\n"
    return body + f"--{boundary}--\r\n".encode()


def declared_bomb():
    """A stored one-member zip whose headers declare 200 MB."""
    buffer = io.BytesIO()
    with zipfile.ZipFile(buffer, "w", zipfile.ZIP_STORED) as archive:
        archive.writestr("x", b"y" * 64)
    data = bytearray(buffer.getvalue())
    size = 200 * 1024 * 1024
    struct.pack_into("<II", data, data.index(b"PK\x03\x04") + 18, size, size)
    struct.pack_into("<II", data, data.index(b"PK\x01\x02") + 20, size, size)
    return bytes(data)


def test_file_bind_example_uploads_multipart():
    """A zip upload lists its members; a text file is sized; a declared
    bomb is refused; a form without the file is a 400 — JAX's bodies."""
    blob = _zip([("a.txt", "alpha"), ("b/b.txt", "beta")])
    boundary = "bnd123"
    ctype = f"multipart/form-data; boundary={boundary}"
    bodies = [
        multipart(boundary, [("name", "hello")],
                  [("upload", "data.zip", "application/zip", blob)]),
        multipart(boundary, [("name", "t")],
                  [("upload", "notes.txt", "text/plain", b"plain text")]),
        multipart(boundary, [], [("upload", "bomb.zip", "application/zip",
                                  declared_bomb())]),
        multipart(boundary, [("name", "x")], []),
    ]

    async def main(app):
        zero_ports(app)
        await app.start()
        try:
            return [normal(await raw_call(app.bound_http_port, http(
                "POST", "/upload", body, {"Content-Type": ctype})))
                for body in bodies]
        finally:
            await app.stop()

    got = {"jax": run(main(jax_example("using-file-bind").build_app())),
           "port": run(main(port_example("using_file_bind").build_app(
               device="cpu")))}
    assert got["port"] == got["jax"]
    data = json.loads(got["port"][0][2])["data"]
    assert data == {"name": "hello", "filename": "data.zip",
                    "bytes": len(blob), "zip_members": ["a.txt", "b/b.txt"]}
    assert [r[0].split()[1] for r in got["port"]] == ["201", "201", "500",
                                                      "400"]


CRUD_ROUNDTRIP = [
    ("POST", "/user", {"id": 1, "name": "ada", "age": 36,
                       "is_employed": True}),
    ("GET", "/user", None), ("GET", "/user/1", None),
    ("PUT", "/user/1", {"id": 1, "name": "ada", "age": 37,
                        "is_employed": True}),
    ("GET", "/user/1", None), ("DELETE", "/user/1", None),
    ("GET", "/user/1", None),
]


def test_add_rest_handlers_example_crud_roundtrip(monkeypatch):
    monkeypatch.setenv("DB_DIALECT", "sqlite")
    monkeypatch.setenv("DB_NAME", ":memory:")
    got = {"jax": run(calls(zero_ports(jax_example(
        "using-add-rest-handlers").build_app()), CRUD_ROUNDTRIP)),
           "port": run(calls(zero_ports(port_example(
               "using_add_rest_handlers").build_app(device="cpu")),
               CRUD_ROUNDTRIP))}
    assert got["port"] == got["jax"]
    assert [r[0].split()[1] for r in got["port"]] == [
        "201", "200", "200", "200", "200", "204", "404"]
    assert json.loads(got["port"][4][2])["data"]["age"] == 37


def test_add_rest_handlers_example_reads_its_own_env(monkeypatch):
    """With nothing in the environment the port's example takes sqlite
    ``:memory:`` from its ``configs/.env``."""
    for key in ("DB_DIALECT", "DB_NAME", "DB_HOST"):
        monkeypatch.delenv(key, raising=False)
    app = port_example("using_add_rest_handlers").build_app(device="cpu")
    assert (app.container.sql.dialect, app.config.get("DB_NAME")) == \
        ("sqlite", ":memory:")


MIGRATION_REQUESTS = [
    ("GET", "/employee", None), ("GET", "/employee/1", None),
    ("POST", "/employee", {"id": 2, "name": "bo", "department": "ops"}),
    ("GET", "/employee", None),
]


def test_migrations_example_boots(monkeypatch):
    """The migrations ran (the seeded row, the Redis key) and the CRUD
    routes over them answer as JAX's."""
    for key, value in (("DB_DIALECT", "sqlite"), ("DB_NAME", ":memory:"),
                       ("REDIS_HOST", "memory")):
        monkeypatch.setenv(key, value)
    jax_app = jax_example("using-migrations").app
    app = port_example("using_migrations").build_app(device="cpu")
    rows = app.container.sql.select("SELECT * FROM employee")
    assert rows[0]["name"] == "ada"
    assert app.container.redis.get("employee:seeded") == "true"
    assert run(calls(zero_ports(app), MIGRATION_REQUESTS)) == \
        run(calls(zero_ports(jax_app), MIGRATION_REQUESTS))


REDIS_REQUESTS = [
    ("POST", "/redis", {"greeting": "hello", "count": "2"}),
    ("GET", "/redis/greeting", None), ("GET", "/redis/nope", None),
    ("GET", "/redis-pipeline", None),
]


def test_http_server_using_redis_example(monkeypatch):
    monkeypatch.delenv("REDIS_HOST", raising=False)
    apps = {"jax": jax_example("http-server-using-redis").build_app(),
            "port": port_example("http_server_using_redis").build_app(
                device="cpu")}
    got = {side: run(calls(zero_ports(app), REDIS_REQUESTS))
           for side, app in apps.items()}
    assert got["port"] == got["jax"]
    assert [r[0].split()[1] for r in got["port"]] == ["201", "200", "404",
                                                      "200"]
    assert json.loads(got["port"][3][2])["data"] == {
        "testKey1": "testValue1"}
    assert 0 < apps["port"].container.redis.ttl("greeting") <= 300


def test_http_service_example_proxies_and_degrades(monkeypatch):
    """``/fact`` through ``cat-facts`` against a local upstream; health
    shows ``fact-checker``'s wrong endpoint; with the upstream stopped
    ``/fact`` fails and health degrades — as JAX's."""
    async def main():
        upstream = mock_app("port")
        upstream.get("/fact", lambda ctx: {"fact": "cats nap a lot",
                                           "length": 14})
        upstream.get("/breeds", lambda ctx: {"ok": True})
        await upstream.start()
        monkeypatch.setenv("FACTS_URL",
                           f"http://127.0.0.1:{upstream.bound_http_port}")
        apps = {"jax": jax_example("using-http-service").build_app(),
                "port": port_example("using_http_service").build_app(
                    device="cpu")}
        got = {}
        for side, app in apps.items():
            zero_ports(app)
            await app.start()
            port = app.bound_http_port
            fact = normal(await raw_call(port, http("GET", "/fact")))
            health = json.loads(normal(await raw_call(
                port, http("GET", "/.well-known/health")))[2])
            got[side] = [fact, {k: v["status"] for k, v in
                                health["services"].items()},
                         health["status"]]
        await upstream.stop()
        for side, app in apps.items():
            port = app.bound_http_port
            fact = normal(await raw_call(port, http("GET", "/fact")))
            health = json.loads(normal(await raw_call(
                port, http("GET", "/.well-known/health")))[2])
            got[side] += [fact[0],
                          health["services"]["cat-facts"]["status"],
                          health["status"]]
            await app.stop()
        return got

    got = run(main())
    assert got["port"] == got["jax"]
    assert json.loads(got["port"][0][2])["data"] == {
        "fact": "cats nap a lot", "length": 14}
    assert got["port"][1] == {"cat-facts": "UP", "fact-checker": "DOWN"}
    assert got["port"][3].split()[1] != "200"


PUBLISH_REQUESTS = [
    ("POST", "/publish-order", {"orderId": "o1", "status": "pending"}),
    ("POST", "/publish-product", {"productId": "p1", "price": "9"}),
    ("POST", "/publish-product", {"productId": "p1"}),
]


def test_publisher_example_publishes_to_topics(monkeypatch):
    monkeypatch.setenv("PUBSUB_BACKEND", "INMEM")

    async def main(app):
        zero_ports(app)
        await app.start()
        try:
            out = [normal(await raw_call(app.bound_http_port, http(
                method, path, json.dumps(body).encode(), JSON)))
                for method, path, body in PUBLISH_REQUESTS]
            for topic in ("order-logs", "products"):
                message = await asyncio.wait_for(
                    app.container.pubsub.subscribe(topic), 10.0)
                out.append(json.loads(message.value))
            return out
        finally:
            await app.stop()

    got = {"jax": run(main(jax_example("using-publisher").build_app())),
           "port": run(main(port_example("using_publisher").build_app(
               device="cpu")))}
    assert got["port"] == got["jax"]
    assert [r[0].split()[1] for r in got["port"][:3]] == ["201", "201",
                                                          "400"]
    assert got["port"][3]["orderId"] == "o1"


def custom_series(text):
    """The example's own series from the exposition: every line of the
    counter, up-down counter and gauge, the histogram's count."""
    keep = []
    for line in text.splitlines():
        name = line.split("{")[0].split(" ")[0]
        if name in ("transaction_success", "total_credit_day_sale",
                    "product_stock", "transaction_time_count") \
                or (line.startswith("# ") and "transaction" in line):
            keep.append(line)
    return keep


def test_custom_metrics_example_lands_on_prometheus():
    async def main(app):
        zero_ports(app)
        await app.start()
        try:
            port = app.bound_http_port
            out = []
            for amount in (120, 80):
                out.append(normal(await raw_call(port, http(
                    "POST", "/transaction", json.dumps(
                        {"amount": amount, "stock_left": 7}).encode(),
                    JSON))))
            out.append(normal(await raw_call(port, http(
                "POST", "/return", b'{"amount": 50}', JSON))))
            out.append(normal(await raw_call(port, http(
                "POST", "/transaction", b"{}", JSON))))
            text = (await raw_call(app._metrics_server.bound_port,
                                   http("GET", "/metrics"))).decode()
            return out, custom_series(text.partition("\r\n\r\n")[2])
        finally:
            await app.stop()

    got = {"jax": run(main(jax_example("using-custom-metrics").build_app())),
           "port": run(main(port_example("using_custom_metrics").build_app(
               device="cpu")))}
    assert got["port"] == got["jax"]
    series = "\n".join(got["port"][1])
    assert "transaction_success 2" in series.replace(
        "transaction_success{} 2", "transaction_success 2")
    assert "product_stock 7" in series.replace("product_stock{} 7",
                                               "product_stock 7")
    assert "total_credit_day_sale" in series and "transaction_time" in series


def test_using_cron_example_jobs_fire():
    """Both jobs parse and register; each is due when JAX's is; a due
    firing runs through the real ``_run_job`` and counts a success."""
    import time as _time

    at = [_time.struct_time((2026, 1, 1, 12, m, 0, 3, 1, -1))
          for m in (7, 10, 0, 59)]

    def fire(app):
        async def main():
            for job in app.crontab.jobs:
                await app.crontab._run_job(job)
        run(main())
        metric = app.container.metrics._metrics["app_cron_runs_total"]
        return sorted((dict(k)["job"], dict(k)["result"], v)
                      for k, v in metric.series.items())

    got = {}
    for side, app in (("jax", jax_example("using-cron").app),
                      ("port", port_example("using_cron").app)):
        jobs = app.crontab.jobs
        got[side] = ([job.name for job in jobs],
                     [[job.due(t) for t in at] for job in jobs], fire(app))
    assert got["port"] == got["jax"]
    assert got["port"][2] == [("heartbeat", "success", 1.0),
                              ("tpu-health", "success", 1.0)]


def test_every_jax_example_has_its_counterpart():
    """Each of JAX's examples has a module of the port's (``-`` written
    as ``_``) with ``build_app``, named in the package's docstring, and
    JAX's ``configs/.env`` as its own."""
    from gofr_tpu_torch import examples

    names = sorted(n for n in os.listdir(os.path.join(ROOT, "examples"))
                   if os.path.isdir(os.path.join(ROOT, "examples", n)))
    assert len(names) == 14
    for jax_name in names:
        name = jax_name.replace("-", "_")
        module = importlib.import_module(f"gofr_tpu_torch.examples.{name}")
        assert callable(module.build_app)
        assert f"``{name}``" in examples.__doc__
        env = os.path.join(ROOT, "examples", jax_name, "configs", ".env")
        if os.path.exists(env):
            with open(env) as jax_env, open(os.path.join(
                    examples.config_dir(name), ".env")) as port_env:
                assert port_env.read() == jax_env.read()


# -- chip_smoke.py's phase 42 ---------------------------------------------------------

import chip_smoke  # noqa: E402


def _jax_answers(app, table):
    got = run(calls(zero_ports(app), [(m, p, b) for m, p, b, _, _ in table]))
    return [(int(status.split()[1]), json.loads(body) if body else None)
            for status, _, body in got]


def _jax_http_server():
    jm = jax_example("http-server")
    app = mock_app("jax")
    app.get("/hello", jm.hello)
    app.get("/user/{id}", jm.get_user)
    app.post("/user", jm.create_user)
    return app


PHASE42_TABLES = {
    "EX_HTTP_SERVER": _jax_http_server,
    "EX_CRUD": lambda: jax_example("using-add-rest-handlers").build_app(),
    "EX_MIGRATIONS": lambda: jax_example("using-migrations").app,
    "EX_REDIS": lambda: jax_example("http-server-using-redis").build_app(),
    "EX_PUBLISHER": lambda: jax_example("using-publisher").build_app(),
    "EX_TRANSACTIONS": lambda: jax_example(
        "using-custom-metrics").build_app(),
}


@pytest.mark.parametrize("table", sorted(PHASE42_TABLES))
def test_phase42_answers_are_jax_answers(table, monkeypatch):
    """Each answer phase 42 holds the port's examples to on the card is
    what JAX's example answers on the CPU."""
    for key, value in (("DB_DIALECT", "sqlite"), ("DB_NAME", ":memory:"),
                       ("REDIS_HOST", "memory"), ("PUBSUB_BACKEND", "INMEM")):
        monkeypatch.setenv(key, value)
    rows = getattr(chip_smoke, table)
    assert _jax_answers(PHASE42_TABLES[table](), rows) == [
        (status, want) for _, _, _, status, want in rows]


def test_phase42_upload_and_series_are_jax_answers():
    """The zip upload's members, the declared bomb's answer and the custom
    series phase 42 expects are JAX's examples' on the CPU."""
    async def uploads(app):
        zero_ports(app)
        await app.start()
        try:
            return [await chip_smoke.http_call(
                app.bound_http_port, "POST", "/upload",
                chip_smoke.upload_body(name, blob), {
                    "Content-Type": "multipart/form-data; boundary="
                                    f"{chip_smoke.BOUNDARY}"})
                for name, blob in (("data.zip", _zip(
                    chip_smoke.EX_ZIP_MEMBERS)), (
                        "bomb.zip", chip_smoke.declared_bomb_zip()))]
        finally:
            await app.stop()

    (s1, _, b1), (s2, _, b2) = run(uploads(
        jax_example("using-file-bind").build_app()))
    assert (s1, json.loads(b1)["data"]["zip_members"]) == (
        201, [name for name, _ in chip_smoke.EX_ZIP_MEMBERS])
    assert (s2, json.loads(b2)) == chip_smoke.EX_BOMB

    async def series(app):
        zero_ports(app)
        await app.start()
        try:
            for method, path, body, _, _ in chip_smoke.EX_TRANSACTIONS:
                await chip_smoke.http_call(app.bound_http_port, method,
                                           path, body)
            _, _, text = await chip_smoke.http_call(
                app._metrics_server.bound_port, "GET", "/metrics")
        finally:
            await app.stop()
        out = {}
        for line in text.decode().splitlines():
            name, _, value = line.replace("{}", "").partition(" ")
            if name in chip_smoke.EX_SERIES:
                out[name] = float(value)
        return out

    assert run(series(jax_example("using-custom-metrics").build_app())) \
        == chip_smoke.EX_SERIES


@pytest.mark.parametrize("step", [name for name, _ in
                                  chip_smoke.EXAMPLE_STEPS])
def test_phase42_rehearsal_on_cpu(step, tmp_path):
    """Each step of phase 42 on the CPU at the tiny presets and small
    request sets (the ``cmd`` example's ``classify`` in process)."""
    kit = chip_smoke.example_kit(torch, 0, str(tmp_path), device="cpu",
                                 tiny=True)
    row = dict(chip_smoke.EXAMPLE_STEPS)[step](kit)
    assert kit.out[step] is row
    if step == "http_server":
        assert [t["kind"] for t in row["turns"]] == list(
            chip_smoke.EXAMPLE_TURNS)
        assert sorted(row["captures_s"]) == [1, 4, 16, 32]
    if step == "cmd":
        assert (row["hello"]["rc"], row["nosuch"]["rc"]) == (0, 2)
