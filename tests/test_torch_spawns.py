"""The port's long-lived tasks spawn as JAX's do: through ``spawn_logged``.

A failure that escapes the generation engine's loop, or the watchdog's
timer, is logged under the task's name (``generate.engine_loop``,
``slo.watchdog``) and counted in ``app_async_task_failures_total{task}``
as it happens, not first seen at ``stop()``. Each case drives the JAX
package's object and the port's the same way (``tiny``, on the CPU) and
holds the port's log and count to JAX's. The watchdog keeps the port's
recorded divergence: an evaluation that raises ends its timer, and
``stop()`` re-raises it (ROADMAP §3, "Failing seams raise").
"""

import asyncio

import jax
import jax.numpy as jnp
import pytest
import torch

from gofr_tpu import slo as jax_slo
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu_torch import slo as pt_slo
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.tpu.generate import GenerationEngine

FAILURES = "app_async_task_failures_total"


class _Log:
    """A logger that keeps every ``error`` line."""

    def __init__(self):
        self.errors = []

    def error(self, fmt, *args, **_):
        self.errors.append(fmt % args if args else fmt)

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


class _Metrics:
    """A metrics sink that keeps every counter increment."""

    def __init__(self):
        self.counted = []

    def increment_counter(self, name, *args, **labels):
        self.counted.append((name, labels))

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


async def _until_done(task, seconds=5.0):
    """Wait for ``task`` to end and for its done-callbacks (which the
    loop runs one turn after the task ends) to have run."""
    for _ in range(int(seconds / 0.01)):
        if task.done():
            await asyncio.sleep(0)
            return
        await asyncio.sleep(0.01)
    raise AssertionError("the task did not end")


def _engines(log, metrics):
    kw = dict(max_slots=2, max_len=64, prompt_buckets=(8,),
              logger=log, metrics=metrics)
    jcfg = jax_llama.config("tiny", dtype=jnp.float32)
    tcfg = pt_llama.config("tiny", dtype=torch.float32)
    return [JaxEngine(jcfg, jax_llama.init(jcfg, jax.random.PRNGKey(0)),
                      **kw),
            GenerationEngine(tcfg, pt_llama.init(tcfg, device="cpu"),
                             device="cpu", **kw)]


def test_engine_loop_failure_is_logged_and_counted_as_in_jax():
    """The loop catches a failing tick; a failure of its own handler (an
    injected ``_fail_outstanding`` that raises) escapes it and ends the
    task: logged under ``generate.engine_loop`` and counted, then raised
    again by ``stop()``, by both engines alike."""

    async def drive(engine, log, metrics):
        async def failing_body(loop):
            raise RuntimeError("tick failed")

        def failing_handler(exc):
            raise RuntimeError("handler failed")

        engine._loop_body = failing_body
        engine._fail_outstanding = failing_handler
        await engine.start()
        await _until_done(engine._task)
        seen = (list(log.errors), list(metrics.counted))
        with pytest.raises(RuntimeError, match="handler failed"):
            await engine.stop()
        engine._task = None
        await engine.stop()
        return seen

    results = []
    for index in range(2):
        log, metrics = _Log(), _Metrics()
        engine = _engines(log, metrics)[index]
        results.append(asyncio.run(drive(engine, log, metrics)))
    for errors, counted in results:
        assert any("background task generate.engine_loop died" in line
                   and "handler failed" in line for line in errors), errors
        assert (FAILURES, {"task": "generate.engine_loop"}) in counted
    assert results[1] == results[0]


@pytest.mark.parametrize("mod", [jax_slo, pt_slo], ids=["jax", "port"])
def test_watchdog_task_death_is_logged_and_counted(mod):
    """A failure that escapes the watchdog's timer loop is logged under
    ``slo.watchdog`` and counted, in JAX and in the port."""

    async def main():
        log, metrics = _Log(), _Metrics()
        dog = mod.Watchdog(mod.SLOTracker(), logger=log, metrics=metrics,
                           interval_s=0.005)

        async def dying():
            raise RuntimeError("timer died")
        dog._run = dying
        dog.start()
        await _until_done(dog._task)
        assert any("background task slo.watchdog died" in line
                   for line in log.errors), log.errors
        assert (FAILURES, {"task": "slo.watchdog"}) in metrics.counted
        dog._task = None

    asyncio.run(main())


def test_port_watchdog_failed_evaluation_is_seen_before_stop():
    """The port's divergence kept: an evaluation that raises ends the
    timer and ``stop()`` re-raises it; and since the timer spawns as
    JAX's does, the death is logged and counted when it happens."""

    async def main():
        log, metrics = _Log(), _Metrics()
        dog = pt_slo.Watchdog(pt_slo.SLOTracker(), logger=log,
                              metrics=metrics, interval_s=0.005)

        def broken(now=None):
            raise ValueError("accounting bug")
        dog.evaluate = broken
        dog.start()
        await _until_done(dog._task)
        assert (FAILURES, {"task": "slo.watchdog"}) in metrics.counted
        assert any("accounting bug" in line for line in log.errors)
        with pytest.raises(ValueError, match="accounting bug"):
            await dog.stop()

    asyncio.run(main())
