"""The port's example app serving on the card. Marked ``cuda``: each test
skips itself on a host without a CUDA device. Run them on the GPU host
with ``python -m pytest tests/test_torch_cuda_app.py -q --noconftest``
(HTTP through the standard library: nothing here imports the JAX
package).

- ``build_app()`` at its default device serves ``small`` (vocab 256) on
  the card: greedy tokens over HTTP (unary and SSE) equal the same
  engine's direct ``generate`` of the tokenizer's ids; every tick and
  prefill of the requests replays a graph captured before the bind.
"""

import asyncio
import json

import pytest
import torch

pytestmark = pytest.mark.cuda

ENV = {"LLAMA_PRESET": "small", "GENERATE_SLOTS": "2",
       "STEPS_PER_TICK": "4", "INFLIGHT_TICKS": "2", "HTTP_PORT": "0",
       "METRICS_PORT": "0", "GRPC_PORT": "0", "LOG_LEVEL": "WARN"}
UNSET = ("MODELS", "GENERATE_DRAFT_MODEL", "LLAMA_KV_INT8",
         "GENERATE_PAGED_KV", "CLUSTER_PEERS", "MESH", "TPU_MESH",
         "BATCH_LANE_TOPIC", "PUBSUB_BACKEND", "FAULT_PLAN", "DB_DIALECT",
         "REDIS_HOST", "MONGO_URI", "CASSANDRA_HOSTS", "CLICKHOUSE_HOST",
         "REMOTE_LOG_URL", "TPU_ENABLED")


@pytest.fixture()
def app_env(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for key in UNSET:
        monkeypatch.delenv(key, raising=False)
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)


async def _post(port, path, body):
    data = json.dumps(body).encode()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write((f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Type: "
                  f"application/json\r\nContent-Length: {len(data)}\r\n"
                  f"Connection: close\r\n\r\n").encode() + data)
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), payload


def _chunks(payload):
    out, rest = [], payload
    while rest:
        size_line, _, rest = rest.partition(b"\r\n")
        size = int(size_line, 16)
        if size == 0:
            break
        out.append(rest[:size])
        rest = rest[size + 2:]
    return out


def test_app_serves_on_the_card_as_the_engine(app_env):
    from gofr_tpu_torch.examples import llama_generate

    app = llama_generate.build_app()
    engine = app.engine
    assert engine.device.type == "cuda"
    prompts = ["hello there", "the quick brown fox " * 10]

    async def main():
        await app.start()
        try:
            port = app.bound_http_port
            before = engine.stats()["graphs"]
            unary = []
            for prompt in prompts:
                status, body = await _post(port, "/generate",
                                           {"prompt": prompt,
                                            "max_new_tokens": 12})
                assert status == 201
                unary.append(json.loads(body)["data"]["tokens"])
            status, body = await _post(port, "/generate/stream",
                                       {"prompt": prompts[1],
                                        "max_new_tokens": 12})
            assert status == 200
            frames = [c.decode()[len("data: "):].strip()
                      for c in _chunks(body)]
            assert frames[-1] == "[DONE]"
            streamed = [json.loads(f)["token"] for f in frames[:-1]]
            direct = [await engine.generate(
                app.tokenizer.encode(p)[-512:], 12) for p in prompts]
            after = engine.stats()["graphs"]
            return unary, streamed, direct, before, after
        finally:
            await app.stop()

    unary, streamed, direct, before, after = asyncio.run(main())
    assert unary == direct
    assert streamed == direct[1]
    assert after["lazy_captures"] == before["lazy_captures"]
    assert after["prefill"]["lazy_captures"] \
        == before["prefill"]["lazy_captures"]
    assert after["replays"] > before["replays"]
