"""Port parity for the dynamic batcher on the CPU:
``gofr_tpu_torch.tpu.DynamicBatcher`` over the port's executor against
``gofr_tpu.tpu.DynamicBatcher`` over JAX's, on the same model (a float32
affine map) and the same arrival patterns.

Both flush on a full batch and on the timer with the same causes, batch
sizes and results; an expired request is shed at flush as
``DeadlineExceeded`` (outcome ``expired``) while its batch-mates are
served; an executor error reaches every request of the batch (outcome
``error``); ``apply_operating_point`` validates then swaps; the warm path
(``dispatch_rows`` + ``fetch``) serves a bucket once it is built, and a
cold one goes through ``predict``; the traffic recorder's
``note_enqueue`` sees every example, and the spans are JAX's
(``queue.wait`` a request, one ``tpu.batch`` a flush, linked).
"""

import asyncio
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import slo as jax_slo
from gofr_tpu.container import new_mock_container
from gofr_tpu.tpu import DynamicBatcher as JaxBatcher
from gofr_tpu.tpu import Executor as JaxExecutor
from gofr_tpu.trace import ListExporter as JaxListExporter
from gofr_tpu.trace import Tracer as JaxTracer
from gofr_tpu_torch import slo
from gofr_tpu_torch.metrics import Manager, register_engine_metrics
from gofr_tpu_torch.tpu import DynamicBatcher, Executor
from gofr_tpu_torch.trace import ListExporter, Tracer

W = np.arange(3, dtype=np.float32)


def _stack(package, buckets=(1, 2, 4)):
    if package == "jax":
        container = new_mock_container()
        executor = JaxExecutor(container.logger, container.metrics)
        executor.register("m", lambda p, x: x * 2.0 + p["w"],
                          {"w": jnp.asarray(W)}, buckets=buckets)
        tracker = jax_slo.SLOTracker(container.metrics)
        return JaxBatcher, executor, tracker, container.metrics
    metrics = register_engine_metrics(Manager())
    executor = Executor(None, metrics, device="cpu")
    executor.register("m", lambda p, x: x * 2.0 + p["w"],
                      {"w": torch.from_numpy(W)}, buckets=buckets)
    return DynamicBatcher, executor, slo.SLOTracker(metrics), metrics


def _run(package, pattern, max_batch=4, max_delay_ms=20.0, **kw):
    """Submit ``pattern`` (a list of waves: examples submitted together,
    then a pause) and return the results, the flush causes and the batch
    sizes the executor saw."""
    cls, executor, tracker, metrics = _stack(package)
    sizes = []
    for method in ("predict", "dispatch_rows"):
        real = getattr(executor, method)

        def spy(name, batch, _real=real, _method=method):
            sizes.append(len(batch) if _method == "dispatch_rows"
                         else batch.shape[0])
            return _real(name, batch)
        setattr(executor, method, spy)
    batcher = cls(executor, max_batch=max_batch, max_delay_ms=max_delay_ms,
                  slo=tracker, metrics=metrics, **kw)

    async def scenario():
        out, value = [], 0.0
        for wave in pattern:
            futures = []
            for _ in range(wave):
                futures.append(asyncio.ensure_future(
                    batcher.predict("m", np.full((3,), value, np.float32))))
                value += 1.0
            out.extend(await asyncio.gather(*futures))
        return out

    results = asyncio.run(scenario())
    return results, dict(batcher.flush_causes), sizes, batcher, tracker


@pytest.mark.parametrize("pattern", [[6], [4, 4], [1, 3, 2], [9]])
def test_flushes_as_jax(pattern):
    runs = {pkg: _run(pkg, pattern) for pkg in ("jax", "port")}
    (jres, jcauses, jsizes, _, _), (pres, pcauses, psizes, _, ptrack) = \
        runs["jax"], runs["port"]
    assert pcauses == jcauses and psizes == jsizes
    for i, (got, want) in enumerate(zip(pres, jres)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
        np.testing.assert_allclose(got, 2.0 * i + W)
    assert ptrack.outcomes["ok"].total() == sum(pattern)


def test_warm_buckets_dispatch_rows_and_cold_ones_predict():
    _, _, sizes, batcher, _ = _run("port", [4, 4, 2])
    executor = batcher.executor
    # bucket 4's first batch was cold (a build), the second warm
    assert sizes == [4, 4, 2] and executor.is_warm("m", 4)
    assert sorted(executor._models["m"].compiled) == [2, 4]
    # every batch is one staged upload: the warm one's rows went
    # straight into its slab (path rows), the cold ones' through predict
    assert executor.data_plane()["staging"]["uploads"] == 3
    metrics = batcher.metrics
    assert metrics.value("app_tpu_h2d_bytes_total", path="rows") == 4 * 12
    assert metrics.value("app_tpu_h2d_bytes_total",
                         path="dispatch") == (4 + 2) * 12


def test_expired_request_is_shed_as_jax():
    async def scenario(cls, executor, tracker, deadline_mod):
        batcher = cls(executor, max_batch=8, max_delay_ms=5.0, slo=tracker)

        async def late():
            deadline_mod.set_request_deadline(1.0)   # 1 ms
            return await batcher.predict("m", np.zeros((3,), np.float32))

        on_time = asyncio.ensure_future(
            batcher.predict("m", np.ones((3,), np.float32)))
        doomed = asyncio.ensure_future(late())
        time.sleep(0.01)                  # the loop is blocked past 1 ms
        return await asyncio.gather(on_time, doomed, return_exceptions=True)

    for package, deadline_mod in (("jax", jax_slo), ("port", slo)):
        cls, executor, tracker, _ = _stack(package)
        ok, shed = asyncio.run(scenario(cls, executor, tracker,
                                        deadline_mod))
        np.testing.assert_allclose(np.asarray(ok), 2.0 + W)
        assert type(shed).__name__ == "DeadlineExceeded", package
        assert tracker.outcomes["expired"].total() == 1
        assert tracker.outcomes["ok"].total() == 1


def test_errors_reach_every_request():
    for package in ("jax", "port"):
        cls, executor, tracker, _ = _stack(package)
        batcher = cls(executor, max_batch=4, max_delay_ms=1.0, slo=tracker)

        async def scenario():
            return await asyncio.gather(
                batcher.predict("unregistered", np.zeros((1,))),
                batcher.predict("unregistered", np.zeros((1,))),
                return_exceptions=True)

        errors = asyncio.run(scenario())
        assert all(isinstance(e, KeyError) for e in errors), package
        assert tracker.outcomes["error"].total() == 2


def test_apply_operating_point_as_jax():
    for package in ("jax", "port"):
        cls, executor, _, _ = _stack(package)
        batcher = cls(executor, max_batch=8, max_delay_ms=2.0)
        assert batcher.apply_operating_point(max_batch=16) == {
            "max_batch": 16, "max_delay_ms": 2.0}
        assert batcher.apply_operating_point(max_delay_ms=0.5) == {
            "max_batch": 16, "max_delay_ms": 0.5}
        with pytest.raises(ValueError, match="max_batch"):
            batcher.apply_operating_point(max_batch=0)
        with pytest.raises(ValueError, match="max_delay_ms"):
            batcher.apply_operating_point(max_delay_ms=-1)
        assert batcher.max_batch == 16


def test_enqueue_hook_queue_depths_and_spans_as_jax():
    class Recorder:
        def __init__(self):
            self.models = []

        def note_enqueue(self, model):
            self.models.append(model)

    seen = {}
    for package, tracer_cls, exporter_cls in (
            ("jax", JaxTracer, JaxListExporter),
            ("port", Tracer, ListExporter)):
        cls, executor, _, _ = _stack(package)
        exporter = exporter_cls()
        tracer = tracer_cls(exporter=exporter)
        recorder = Recorder()
        batcher = cls(executor, max_batch=4, max_delay_ms=10.0,
                      tracer=tracer, workload=recorder)

        async def scenario():
            futures = [asyncio.ensure_future(
                batcher.predict("m", np.zeros((3,), np.float32)))
                for _ in range(3)]
            await asyncio.sleep(0)
            depths = batcher.queue_depths()
            await asyncio.gather(*futures)
            return depths

        depths = asyncio.run(scenario())
        tracer.shutdown()
        names = sorted(s.name for s in exporter.spans)
        links = [len(s.links) for s in exporter.spans
                 if s.name == "tpu.batch"]
        seen[package] = (depths, recorder.models, names, links)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == {"m": 3} and seen["port"][3] == [3]
