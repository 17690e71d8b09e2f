"""Two port example apps on localhost (``device="cpu"``, the ``tiny``
preset at f32 on JAX's ``llama.init`` weights): a prefill replica
(``CLUSTER_ROLE=prefill``) and decode replicas (``CLUSTER_ROLE=decode``,
``GENERATE_PAGED_KV=1``, as JAX's ``adopt_kv`` needs) whose
``CLUSTER_PEERS`` names the prefill replica, behind the cluster's
``HTTPTransport``. Every app serves on one event loop of its own thread
for the module.

- ``POST /disagg/generate`` gives JAX's monolithic engine's greedy tokens
  token for token, with the handoff fetched over gRPC
  (``#grpc`` in the peer entry), over HTTP (no ``#grpc``), and over HTTP
  after an unreachable gRPC target (a ``warn``, then the fallback); the
  decode replica runs no prefill for them;
- ``/debug/clusterz`` on the decode replica shows the peer fresh, probed
  over HTTP; ``/debug/tracez/{id}`` stitches prefill → kv_transfer →
  handoff_gap → decode across the HTTP hop, the phases summing to the
  end-to-end time within 10% (``tests/test_clusterz.py``'s bound);
- after the peer's server stops, its circuit opens, ``/debug/clusterz``
  still answers 200 with the peer stale for the breaker's reason, and
  ``/disagg/generate`` answers 503 as with no prefill replica;
- JAX's transport reads the framework's ``{"data": ...}`` envelope as
  the payload (ROADMAP.md §3): against the same prefill replica its
  prefill leg raises ``KeyError``.

Greedy tokens at f32 are compared exactly.
"""

import asyncio
import dataclasses
import json
import socket
import threading

import numpy as np
import pytest

ENV = {"LLAMA_PRESET": "tiny", "GENERATE_SLOTS": "2", "STEPS_PER_TICK": "4",
       "LOG_LEVEL": "FATAL", "HTTP_PORT": "0", "METRICS_PORT": "0",
       "GRPC_PORT": "0"}
UNSET = ("MODELS", "GENERATE_DRAFT_MODEL", "LLAMA_KV_INT8",
         "GENERATE_PAGED_KV", "CLUSTER_PEERS", "MESH", "TPU_MESH",
         "BATCH_LANE_TOPIC", "PUBSUB_BACKEND", "FAULT_PLAN", "FLEET_ROUTING",
         "GENERATE_PREFIX_CACHE", "TRACE_EXPORTER", "CLUSTER_ROLE",
         "DB_DIALECT", "REDIS_HOST", "MONGO_URI", "CASSANDRA_HOSTS",
         "CLICKHOUSE_HOST", "REMOTE_LOG_URL", "TPU_ENABLED")
PROMPTS = ["hello world", "the quick brown fox", "ab"]
BUDGET = 6
FETCHES = ("grpc", "http", "grpc_down")


class LoopThread:
    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


async def _request(port, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else b""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write((f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                      f"Content-Type: application/json\r\nContent-Length: "
                      f"{len(data)}\r\nConnection: close\r\n\r\n").encode()
                     + data)
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {k.strip().lower(): v.strip() for k, _, v in
               (line.partition(":") for line in lines[1:])}
    return int(lines[0].split()[1]), headers, json.loads(payload or b"null")


def _closed_port():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _jax_weights():
    import jax
    import jax.numpy as jnp

    from gofr_tpu.models import llama as jax_llama

    jcfg = jax_llama.config("tiny", vocab_size=256, dtype=jnp.float32,
                            use_flash=True)
    return jcfg, jax.tree.map(np.asarray,
                              jax_llama.init(jcfg, jax.random.PRNGKey(0)))


def _jax_monolithic(jcfg, weights, prompts):
    """JAX's engine, one greedy request at a time."""
    from gofr_tpu.tpu.generate import GenerationEngine

    engine = GenerationEngine(jcfg, weights, max_slots=2, max_len=1024,
                              steps_per_tick=4)

    async def main():
        await engine.start()
        try:
            return [await engine.generate(p, BUDGET) for p in prompts]
        finally:
            await engine.stop()
    return asyncio.run(main())


class _Warnings:
    """A logger that keeps the transport's ``warn`` lines."""

    def __init__(self, inner):
        self.inner = inner
        self.warnings = []

    def warn(self, message, *args, **fields):
        self.warnings.append(message % args)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _build(env, weights):
    import torch

    from gofr_tpu_torch.examples import llama_generate
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.models.convert import from_jax_llama

    def params_fn(module, cfg, seed):
        assert module is llama and seed == 0
        return from_jax_llama(weights, device="cpu")

    with pytest.MonkeyPatch.context() as mp:
        for key in UNSET:
            mp.delenv(key, raising=False)
        for key, value in dict(ENV, **env).items():
            mp.setenv(key, value)
        mp.setitem(llama.PRESETS, "tiny", dataclasses.replace(
            llama.PRESETS["tiny"], dtype=torch.float32))
        return llama_generate.build_app(device="cpu", params_fn=params_fn)


def _fetch_counts(app):
    """The prefill replica's handoff fetches served: (gRPC, HTTP)."""
    snapshot = app.container.metrics.snapshot()
    grpc = sum(s["count"] for labels, s in
               snapshot["app_http_service_response"].series.items()
               if ("service", "grpc") in labels
               and any("Disagg/fetch" in str(v) for _, v in labels))
    http = app.container.metrics.value(
        "app_http_response", path="/disagg/fetch", method="GET",
        status="200") or 0.0
    return grpc, http


@pytest.fixture(scope="module")
def cluster():
    loop = LoopThread()
    jcfg, weights = _jax_weights()
    prefill = _build({"CLUSTER_ROLE": "prefill"}, weights)
    apps = {"prefill": prefill}
    out = {"loop": loop, "apps": apps, "weights": weights}
    try:
        loop.run(prefill.start())
        url = f"http://127.0.0.1:{prefill.bound_http_port}"
        grpc = f"127.0.0.1:{prefill.bound_grpc_port}"
        peers = {"grpc": f"pf=prefill@{url}#{grpc}",
                 "http": f"pf=prefill@{url}",
                 "grpc_down": f"pf=prefill@{url}#127.0.0.1:{_closed_port()}"}
        for fetch in FETCHES:
            app = _build({"CLUSTER_ROLE": "decode", "GENERATE_PAGED_KV": "1",
                          "CLUSTER_PEERS": peers[fetch]}, weights)
            transport = app.container.cluster._replicas["pf"].transport
            transport.logger = _Warnings(transport.logger)
            loop.run(app.start())
            apps[fetch] = app
        ids = [prefill.tokenizer.encode(p)[-512:] for p in PROMPTS]
        out["jax"] = _jax_monolithic(jcfg, weights, ids)
        out["runs"] = {}
        for fetch in FETCHES:
            app = apps[fetch]
            before = dict(app.engine.stats())
            fetches0 = _fetch_counts(prefill)
            got = [loop.run(_request(app.bound_http_port, "POST",
                                     "/disagg/generate",
                                     {"prompt": p, "max_new_tokens": BUDGET}))
                   for p in PROMPTS]
            fetches1 = _fetch_counts(prefill)
            out["runs"][fetch] = dict(
                answers=got, before=before, after=dict(app.engine.stats()),
                fetches=(fetches1[0] - fetches0[0],
                         fetches1[1] - fetches0[1]),
                warnings=list(app.container.cluster._replicas["pf"]
                              .transport.logger.warnings))
        decode = apps["grpc"]
        tid = out["runs"]["grpc"]["answers"][0][1]["x-trace-id"]
        out["tracez"] = loop.run(_request(decode.bound_http_port, "GET",
                                          f"/debug/tracez/{tid}"))
        out["clusterz"] = loop.run(_request(decode.bound_http_port, "GET",
                                            "/debug/clusterz"))
        yield out
    finally:
        for app in apps.values():
            loop.run(app.stop())
        loop.close()


@pytest.mark.parametrize("fetch", FETCHES)
def test_disagg_tokens_equal_jax_monolithic(cluster, fetch):
    run = cluster["runs"][fetch]
    assert [a[0] for a in run["answers"]] == [201] * len(PROMPTS)
    tokens = [a[2]["data"]["tokens"] for a in run["answers"]]
    assert tokens == cluster["jax"]
    assert all(len(t) == BUDGET for t in tokens)


@pytest.mark.parametrize("fetch", FETCHES)
def test_decode_replica_runs_no_prefill(cluster, fetch):
    run = cluster["runs"][fetch]
    for key in ("prefill_bucket_tokens", "prefill_batches"):
        assert run["after"][key] == run["before"][key], key
    assert run["after"]["kv_adoptions"] - run["before"]["kv_adoptions"] \
        == len(PROMPTS)


def test_handoff_travels_over_the_route_asked_for(cluster):
    """gRPC with ``#grpc``; HTTP without; HTTP after a warning when the
    gRPC target is unreachable."""
    runs = cluster["runs"]
    n = float(len(PROMPTS))
    assert runs["grpc"]["fetches"] == (n, 0.0)
    assert runs["http"]["fetches"] == (0.0, n)
    assert runs["grpc_down"]["fetches"] == (0.0, n)
    assert runs["grpc"]["warnings"] == runs["http"]["warnings"] == []
    warnings = runs["grpc_down"]["warnings"]
    assert len(warnings) == len(PROMPTS)
    assert all("grpc KV fetch" in w and "falling back to HTTP" in w
               for w in warnings)


def test_clusterz_shows_the_peer_fresh_over_http(cluster):
    status, _, body = cluster["clusterz"]
    assert status == 200
    page = body["data"]
    peer = page["replicas"]["pf"]
    assert (peer["role"], peer["transport"], peer["stale"],
            peer["health"]) == ("prefill", "http", False, "UP")
    assert "goodput_tokens_per_s" in peer
    assert peer["watchdog"] == {"state": "READY", "reason": None}
    assert page["replicas"]["local"]["transport"] == "inproc"
    assert page["router"]["requests"] == len(PROMPTS)
    assert page["roles"]["prefill"]["replicas"] == ["pf"]


def test_tracez_stitches_across_the_http_hop(cluster):
    status, _, body = cluster["tracez"]
    assert status == 200
    timeline = body["data"]
    assert timeline["stitched"]
    names = [p["name"] for p in timeline["phases"]]
    assert names.count("handoff_gap") == 1
    for phase in ("prefill", "kv_transfer", "decode"):
        assert names.count(phase) == 1, names
    e2e = timeline["e2e_s"]
    total = sum(p["duration_s"] for p in timeline["phases"])
    assert e2e > 0 and abs(total - e2e) <= 0.10 * e2e, (total, e2e)
    assert timeline["records"]["prefill"] and timeline["records"]["decode"]
    assert (timeline["prefill_replica"], timeline["decode_replica"]) \
        == ("pf", "local")


def test_jax_transport_reads_the_envelope_as_the_payload(cluster):
    """JAX's ``HTTPTransport`` against the same prefill replica: the
    prefill leg reads ``{"data": {...}}`` as the answer and raises
    ``KeyError('handoff')``; the port's takes the payload out."""
    from gofr_tpu.tpu.cluster import HTTPTransport as JaxTransport
    from gofr_tpu_torch.tpu.cluster import HTTPTransport

    prefill = cluster["apps"]["prefill"]
    url = f"http://127.0.0.1:{prefill.bound_http_port}"
    ids = prefill.tokenizer.encode(PROMPTS[0])
    with pytest.raises(KeyError, match="handoff"):
        cluster["loop"].run(JaxTransport(url).prefill(ids, None))
    blob = cluster["loop"].run(HTTPTransport(url).prefill(ids, None))
    assert len(blob) > 0


def test_a_stopped_peer_reads_stale_and_its_circuit_opens(cluster):
    """Stop the prefill replica's servers: the router's prefill legs fail
    until the peer's circuit opens (5 failures); then clusterz answers
    200 with the peer stale for the breaker's reason, and
    ``/disagg/generate`` answers 503: no prefill replica."""
    loop = cluster["loop"]
    decode = cluster["apps"]["grpc"]
    loop.run(cluster["apps"].pop("prefill").stop())
    transport = decode.container.cluster._replicas["pf"].transport
    answers = []
    for _ in range(6):
        answers.append(loop.run(_request(
            decode.bound_http_port, "POST", "/disagg/generate",
            {"prompt": PROMPTS[0], "max_new_tokens": BUDGET}))[0])
        if not transport.available():
            break
    assert not transport.available()
    assert transport.service.state == "open"
    status, _, body = loop.run(_request(decode.bound_http_port, "GET",
                                        "/debug/clusterz"))
    assert status == 200
    peer = body["data"]["replicas"]["pf"]
    assert peer["stale"] and peer["stale_reason"] == "circuit open"
    assert body["data"]["roles"]["prefill"]["stale"] == ["pf"]
    status, _, body = loop.run(_request(
        decode.bound_http_port, "POST", "/disagg/generate",
        {"prompt": PROMPTS[0], "max_new_tokens": BUDGET}))
    assert status == 503
    assert "prefill" in body["error"]["message"]
    assert all(a >= 500 for a in answers)
