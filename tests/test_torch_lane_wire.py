"""The example's batch lane over the wire, on the CPU at ``tiny``: the
port's ``examples/llama_generate`` with ``PUBSUB_BACKEND=KAFKA`` against
the JAX tests' ``FakeKafkaBroker`` serves jobs whose tokens equal direct
generation, and a rehearsal of ``chip_smoke.py``'s phase 41 (the
datasources, the lane over Kafka beside an HTTP burst, then over MQTT)
against ``scripts/wire_brokers.py``, with the launch checks stubbed."""

import asyncio
import json
import os

import chip_smoke
from tests.test_pubsub_wire import FakeKafkaBroker

TINY = {"LLAMA_PRESET": "tiny", "GENERATE_SLOTS": "1"}


def test_example_lane_over_fake_kafka_equals_direct():
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.datasource.pubsub.kafka import KafkaClient
    from gofr_tpu_torch.examples import llama_generate
    from gofr_tpu_torch.logging import new_silent_logger
    from gofr_tpu_torch.metrics import Manager

    broker = FakeKafkaBroker()
    env = dict(TINY, PUBSUB_BACKEND="KAFKA", BATCH_LANE_TOPIC="jobs",
               KAFKA_BROKER=f"127.0.0.1:{broker.port}",
               KAFKA_FETCH_MAX_WAIT_MS="20", CONSUMER_ID="lane")
    jobs = [{"id": f"j{i}", "prompt_ids": list(range(3 + i, 13 + 2 * i)),
             "max_new_tokens": 6} for i in range(3)]
    jobs.append({"id": "text", "prompt": "hello lane", "max_new_tokens": 5})
    producer = KafkaClient(MapConfig({
        "KAFKA_BROKER": f"127.0.0.1:{broker.port}", "CONSUMER_ID": "reader",
        "KAFKA_FETCH_MAX_WAIT_MS": "20"}), new_silent_logger(), Manager())
    try:
        with chip_smoke.app_environment(env):
            app = llama_generate.build_app(device="cpu")

            async def main():
                await app.start()
                try:
                    for job in jobs:
                        producer.publish("jobs", json.dumps(job).encode())
                    got = await chip_smoke.read_topic(producer,
                                                      "jobs.results",
                                                      len(jobs), 60.0)
                    direct = [await app.engine.generate(
                        job.get("prompt_ids")
                        or app.tokenizer.encode(job["prompt"]),
                        job["max_new_tokens"]) for job in jobs]
                    return got, direct
                finally:
                    await app.stop()

            got, direct = asyncio.run(main())
    finally:
        producer.close()
        broker.stop()
    by_id = {r["id"]: r for r in got}
    assert [by_id[j["id"]]["tokens"] for j in jobs] == direct
    assert by_id["text"]["text"] == app.tokenizer.decode(direct[-1])
    assert broker.offsets[("lane", "jobs", 0)] in range(1, len(jobs) + 1)
    assert len(broker.logs[("jobs.results", 0)]) == len(jobs)


def test_phase41_rehearsal_on_cpu(monkeypatch):
    import torch

    from gofr_tpu_torch.ops.cuda import decode_attention as decode_mod
    from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod
    from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod
    from gofr_tpu_torch.tpu import generate

    monkeypatch.setattr(chip_smoke, "check_launches", lambda *args: None)
    before = dict(os.environ)
    results = {}
    by_path = chip_smoke.phase_lane_wire(
        torch, generate, (flash_mod, ragged_mod, decode_mod), 0, results,
        device="cpu", env=TINY,
        sizes=(5, 10, 20, 30), n_jobs=6, n_mqtt=2,
        prompt_range=(8, 41), new_tokens=8, budget=8)
    row = results["lane_wire"]
    assert set(by_path) == {"phase41_lane_kafka", "phase41_lane_mqtt"}
    assert row["committed"] == 7 and row["paused_total"] >= 1
    assert row["restarted"]["ok"] == row["restarted"]["dead"] == 0
    assert row["migrations"]["calls"] == [1, 2]
    assert row["kafka_wire_bytes_per_job"] > 0
    assert row["mqtt_wire_bytes_per_job"] > 0
    assert dict(os.environ) == before
