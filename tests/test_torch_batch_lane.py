"""Port parity for the batch lane on the CPU: the scenarios of
``tests/test_batch_lane.py`` run against ``gofr_tpu.tpu.batch_lane`` and
``gofr_tpu_torch.tpu.batch_lane`` alike (the ``pkg`` parameter), each
lane with its own package's metrics and the JAX package's in-memory
broker (the port's broker in the traced end-to-end case, the JAX one's
elsewhere), with the JAX tests' results, dead letters and pause / resume
sequence.

The end-to-end cases serve jobs on a real ``tiny`` float32 engine of each
package (the same weights): every greedy result equals JAX's and a direct
``engine.generate`` of the same job, the jobs land in the WFQ ``batch``
class (the port's lane submits with no deadline in the port's own
contextvar), and the result publish is a child of the job's consume span
in the producer's trace.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.container import new_mock_container
from gofr_tpu.datasource.pubsub.inmem import InMemoryBroker as JaxBroker
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.tpu import batch_lane as jax_lane
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu.trace import ListExporter as JaxListExporter
from gofr_tpu.trace import Tracer as JaxTracer
from gofr_tpu_torch.datasource.pubsub import InMemoryBroker
from gofr_tpu_torch.metrics import Manager, register_engine_metrics
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.tpu import batch_lane as port_lane
from gofr_tpu_torch.tpu.generate import GenerationEngine
from gofr_tpu_torch.tpu.sched import CLASS_BATCH
from gofr_tpu_torch.trace import ListExporter, Tracer

TOPIC = "gen-jobs"
PKGS = ["jax", "port"]
LANES = {"jax": jax_lane, "port": port_lane}


def _metrics(pkg):
    if pkg == "jax":
        return new_mock_container().metrics
    return register_engine_metrics(Manager())


async def _drain_results(broker, topic, count, timeout=30.0):
    out = []
    for _ in range(count):
        message = await asyncio.wait_for(broker.subscribe(topic), timeout)
        out.append(json.loads(message.value.decode()))
    return out


async def _wait_for(predicate, timeout=10.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not predicate():
        assert asyncio.get_running_loop().time() < deadline, \
            "condition never became true"
        await asyncio.sleep(0.01)


class StubEngine:
    """Duck-types the slice of the engine the lane touches."""

    model_name = "stub"

    def __init__(self):
        self.depth = 0
        self.headroom = None
        self.calls = []
        self.gate = None

    def admission_depth(self):
        return self.depth

    def kv_free_headroom(self):
        return self.headroom

    async def generate(self, prompt_ids, max_new_tokens, eos_id=None,
                       sampling=None, response_format=None):
        self.calls.append(list(prompt_ids))
        if self.gate is not None:
            await self.gate.wait()
        return [7] * max_new_tokens


def _lane(pkg, engine, broker, topic=TOPIC, **kwargs):
    metrics = _metrics(pkg)
    kwargs.setdefault("poll_s", 0.01)
    return LANES[pkg].BatchLane(engine, broker, topic, metrics=metrics,
                                **kwargs), metrics


def _job(**fields):
    job = {"id": "j1", "prompt_ids": [1, 2, 3], "max_new_tokens": 4}
    job.update(fields)
    return json.dumps(job).encode()


# -- end to end on real engines -----------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32)
    return jcfg, jax.tree.map(np.asarray,
                              jax_llama.init(jcfg, jax.random.PRNGKey(0)))


ENGINE_KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16))


def _engine(pkg, weights):
    jcfg, jparams = weights
    if pkg == "jax":
        container = new_mock_container()
        return JaxEngine(jcfg, jparams, logger=container.logger,
                         metrics=container.metrics, **ENGINE_KW)
    tcfg = pt_llama.config("tiny", dtype=torch.float32)
    return GenerationEngine(tcfg, from_jax_llama(jparams, "cpu"),
                            device="cpu", **ENGINE_KW)


E2E_JOBS = [dict(id="a"),
            dict(id="b", prompt_ids=[4, 5], max_new_tokens=3,
                 sampling={"temperature": 0.0}),
            dict(id="c", prompt_ids=list(range(20, 32)), max_new_tokens=6)]


def _e2e(pkg, weights):
    if pkg == "jax":
        exporter = JaxListExporter()
        tracer = JaxTracer(exporter=exporter)
        broker = JaxBroker(tracer=tracer)
    else:
        exporter = ListExporter()
        tracer = Tracer(exporter=exporter)
        broker = InMemoryBroker(tracer=tracer)
    engine = _engine(pkg, weights)
    lane, _ = _lane(pkg, engine, broker, tracer=tracer)

    async def main():
        await engine.start()
        await lane.start()
        try:
            for job in E2E_JOBS:
                broker.publish(TOPIC, _job(**job))
            results = await _drain_results(broker, lane.result_topic,
                                           len(E2E_JOBS))
            direct = [await engine.generate(
                job.get("prompt_ids", [1, 2, 3]),
                job.get("max_new_tokens", 4)) for job in E2E_JOBS]
        finally:
            await lane.stop()
            await engine.stop()
        return results, direct

    results, direct = asyncio.run(main())
    tracer.shutdown()
    return engine, lane, exporter, results, direct


def test_e2e_greedy_results_equal_jax_and_direct_generation(weights):
    runs = {pkg: _e2e(pkg, weights) for pkg in PKGS}
    by_pkg = {pkg: {r["id"]: r for r in runs[pkg][3]} for pkg in PKGS}
    assert by_pkg["port"] == by_pkg["jax"]
    port_engine, lane, exporter, results, direct = runs["port"]
    for job, tokens in zip(E2E_JOBS, direct):
        assert by_pkg["port"][job["id"]]["tokens"] == tokens
    assert by_pkg["port"]["a"]["usage"] == {
        "prompt_tokens": 3, "completion_tokens": 4, "total_tokens": 7}
    # no deadline on the lane's task: the WFQ batch class
    served = port_engine.stats()["classes"]["served"]
    assert served.get(CLASS_BATCH, 0) >= len(E2E_JOBS)
    assert lane.jobs_ok == len(E2E_JOBS) and lane.jobs_dead_lettered == 0
    # trace continuity: producer publish -> consume -> result publish
    job_pubs = [s for s in exporter.find("pubsub.publish")
                if s.attributes.get("topic") == TOPIC]
    result_pubs = [s for s in exporter.find("pubsub.publish")
                   if s.attributes.get("topic") == lane.result_topic]
    consumes = exporter.find("pubsub.consume")
    assert len(job_pubs) == len(result_pubs) == len(consumes) == 3
    by_trace = {s.trace_id: s for s in job_pubs}
    for consume in consumes:
        assert consume.parent_id == by_trace[consume.trace_id].span_id
        assert [s for s in result_pubs if s.trace_id == consume.trace_id
                and s.parent_id == consume.span_id]


@pytest.mark.parametrize("pkg", PKGS)
def test_constrained_job_and_poison_pills_as_jax(weights, pkg):
    """A grammar job yields a grammar-valid result; malformed JSON, bad
    fields and a grammar that does not compile are dead-lettered while
    the consumer keeps running."""
    broker = JaxBroker()
    engine = _engine(pkg, weights)
    lane, metrics = _lane(pkg, engine, broker)

    async def main():
        await engine.start()
        await lane.start()
        try:
            broker.publish(TOPIC, b"not json at all \xff")
            broker.publish(TOPIC, _job(id="bad-ids", prompt_ids="nope"))
            broker.publish(TOPIC, _job(
                id="bad-grammar",
                response_format={"type": "regex", "pattern": "("}))
            broker.publish(TOPIC, _job(
                id="c", max_new_tokens=8,
                response_format={"type": "regex", "pattern": "(yes|no)!"}))
            dead = await _drain_results(broker, lane.dead_letter_topic, 3)
            results = await _drain_results(broker, lane.result_topic, 1)
        finally:
            await lane.stop()
            await engine.stop()
        return dead, results

    dead, [result] = asyncio.run(main())
    assert bytes(result["tokens"]).decode() in ("yes!", "no!")
    assert result["finish_reason"] == "stop"
    kinds = {d["id"]: d["error"]["type"] for d in dead}
    assert kinds == {None: "JobError", "bad-ids": "JobError",
                     "bad-grammar": "GrammarError"}
    assert all(d["error"]["message"] and "job" in d for d in dead)
    assert lane.jobs_dead_lettered == 3 and lane.jobs_ok == 1
    assert metrics.value("app_tpu_batch_lane_jobs_total",
                         outcome="dead_letter") == 3.0
    assert metrics.value("app_tpu_batch_lane_jobs_total", outcome="ok") == 1.0


# -- backpressure -------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_full_admission_queue_pauses_and_resumes_as_jax(pkg):
    broker = JaxBroker()
    engine = StubEngine()
    lane, metrics = _lane(pkg, engine, broker, pause_depth=4,
                          resume_depth=1)
    steps = []

    async def main():
        engine.depth = 10
        await lane.start()
        try:
            broker.publish(TOPIC, _job(id="queued"))
            await _wait_for(lambda: lane.paused)
            await asyncio.sleep(0.05)
            steps.append(("paused", engine.calls == [],
                          metrics.value("app_pubsub_consumer_paused_total",
                                        topic=TOPIC,
                                        reason=LANES[pkg].PAUSE_ADMISSION),
                          metrics.value("app_tpu_batch_lane_paused",
                                        topic=TOPIC)))
            engine.depth = 3       # below pause_depth, above resume_depth
            await asyncio.sleep(0.05)
            steps.append(("hysteresis", lane.paused))
            engine.depth = 0
            await _wait_for(lambda: not lane.paused)
            await _wait_for(lambda: engine.calls == [[1, 2, 3]])
            steps.append(("resumed", metrics.value(
                "app_tpu_batch_lane_paused", topic=TOPIC)))
        finally:
            await lane.stop()

    asyncio.run(main())
    assert steps == [("paused", True, 1.0, 1.0), ("hysteresis", True),
                     ("resumed", 0.0)]
    assert lane.pauses == 1 and lane.resumes == 1
    assert LANES[pkg].PAUSE_ADMISSION == jax_lane.PAUSE_ADMISSION


@pytest.mark.parametrize("pkg", PKGS)
def test_degraded_watchdog_and_kv_headroom_pause_as_jax(pkg):
    class FakeWatchdog:
        state = "DEGRADED"

    broker = JaxBroker()
    engine = StubEngine()
    watchdog = FakeWatchdog()
    lane, metrics = _lane(pkg, engine, broker, watchdog=watchdog,
                          page_low_watermark=2)

    async def main():
        await lane.start()
        try:
            await _wait_for(lambda: lane.paused)
            degraded = metrics.value("app_pubsub_consumer_paused_total",
                                     topic=TOPIC,
                                     reason=LANES[pkg].PAUSE_DEGRADED)
            engine.headroom = 1    # at or under the watermark
            watchdog.state = "READY"
            await asyncio.sleep(0.05)
            still = lane.paused
            engine.headroom = 8
            broker.publish(TOPIC, _job())
            await _wait_for(lambda: engine.calls)
            return degraded, still
        finally:
            await lane.stop()

    assert asyncio.run(main()) == (1.0, True)
    assert lane.pauses == 1 and lane.resumes == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_broker_pause_hook_owns_the_counter_as_jax(pkg):
    class PausableBroker(JaxBroker):
        def __init__(self):
            super().__init__()
            self.pause_calls, self.resume_calls = [], []

        def pause(self, topic, reason="backpressure"):
            self.pause_calls.append((topic, reason))

        def resume(self, topic):
            self.resume_calls.append(topic)

    broker = PausableBroker()
    engine = StubEngine()
    lane, metrics = _lane(pkg, engine, broker, pause_depth=2,
                          resume_depth=0)

    async def main():
        engine.depth = 5
        await lane.start()
        try:
            await _wait_for(lambda: lane.paused)
            engine.depth = 0
            await _wait_for(lambda: not lane.paused)
        finally:
            await lane.stop()

    asyncio.run(main())
    assert broker.pause_calls == [(TOPIC, "admission_depth")]
    assert broker.resume_calls == [TOPIC]
    assert metrics.value("app_pubsub_consumer_paused_total", topic=TOPIC,
                         reason="admission_depth") is None


@pytest.mark.parametrize("pkg", PKGS)
def test_inflight_bound_and_drain_as_jax(pkg):
    broker = JaxBroker()
    engine = StubEngine()
    lane, _ = _lane(pkg, engine, broker, max_inflight=2)

    async def main():
        engine.gate = asyncio.Event()
        await lane.start()
        for n in range(6):
            broker.publish(TOPIC, _job(id=f"j{n}"))
        await _wait_for(lambda: len(engine.calls) >= 2)
        await asyncio.sleep(0.05)
        bounded = (len(engine.calls), lane.stats()["inflight"])
        gated = await lane.drain(0.05)        # jobs still gated
        engine.gate.set()
        landed = await lane.drain(5.0)
        results = await _drain_results(broker, lane.result_topic, 2)
        return bounded, gated, landed, sorted(r["id"] for r in results)

    assert asyncio.run(main()) == ((2, 2), False, True, ["j0", "j1"])
    assert lane.jobs_ok == 2


# -- parsing, topics, the factory ---------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_text_prompts_and_result_topic_override_as_jax(pkg):
    broker = JaxBroker()
    engine = StubEngine()
    plain, _ = _lane(pkg, engine, broker)
    tok, _ = _lane(pkg, engine, broker, topic="tok-jobs",
                   encode=lambda text: [ord(c) for c in text],
                   decode=lambda ids: "".join(chr(i) for i in ids))

    async def main():
        await plain.start()
        await tok.start()
        try:
            broker.publish(TOPIC, json.dumps(
                {"id": "t", "prompt": "hi", "max_new_tokens": 2}).encode())
            [dead] = await _drain_results(broker, plain.dead_letter_topic, 1)
            broker.publish("tok-jobs", json.dumps(
                {"id": "t2", "prompt": "hi", "max_new_tokens": 2}).encode())
            [result] = await _drain_results(broker, tok.result_topic, 1)
            broker.publish(TOPIC, _job(result_topic="elsewhere"))
            [moved] = await _drain_results(broker, "elsewhere", 1)
            return dead["error"]["type"], result, moved["id"]
        finally:
            await plain.stop()
            await tok.stop()

    kind, result, moved = asyncio.run(main())
    assert (kind, result["id"], result["text"], moved) == (
        "JobError", "t2", chr(7) * 2, "j1")
    assert engine.calls[0] == [ord("h"), ord("i")]


class MapConfig(dict):
    def get_int(self, key, default):
        return int(self.get(key, default))

    def get_float(self, key, default):
        return float(self.get(key, default))


@pytest.mark.parametrize("pkg", PKGS)
def test_new_batch_lane_as_jax(pkg):
    class Container:
        pubsub = JaxBroker()
        watchdog = None
        logger = None
        metrics = _metrics(pkg)
        tracer = None

    new = LANES[pkg].new_batch_lane
    engine = StubEngine()
    assert new(MapConfig(), engine, Container) is None
    lane = new(MapConfig(BATCH_LANE_TOPIC="jobs",
                         BATCH_LANE_RESULT_TOPIC="done",
                         BATCH_LANE_MAX_INFLIGHT="3",
                         BATCH_LANE_PAUSE_DEPTH="9",
                         BATCH_LANE_RESUME_DEPTH="2"), engine, Container)
    assert (lane.topic, lane.result_topic, lane.dead_letter_topic,
            lane.max_inflight, lane.pause_depth, lane.resume_depth) == (
        "jobs", "done", "jobs.dead-letter", 3, 9, 2)
    with pytest.raises(ValueError):
        LANES[pkg].BatchLane(engine, Container.pubsub, "jobs",
                             pause_depth=4, resume_depth=4)
    assert set(lane.stats()) == set(jax_lane.BatchLane(
        engine, Container.pubsub, "x").stats())
