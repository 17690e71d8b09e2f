"""Port parity for admission (``tpu/sched.py``, ``slo.py``'s deadlines and
the engine's class queues, overflow, brownout, deadline shed and
quarantine) against the JAX package on the CPU.

- ``ClassQueues`` pops what JAX's pops, in the same order, over seeded
  sequences of 200 arrivals with pops and idle gaps between them (the
  re-anchor of an idle class), under the default, role and custom
  weights; ``deadline_class``, ``parse_class_weights``,
  ``role_class_weights``, ``brownout_shed_classes`` and the deadline
  helpers agree.
- The engine: the overflow sheds the deepest class's newest entry as
  JAX's does; a paged pass short of pages defers to the overflow and
  serves it later; ``set_brownout`` clamps to 0..3 and refuses
  batch-class submissions from level 1 (``BrownoutShed``, 503), caps γ
  at rung 1 at level 2 and dispatches no spec tick at level 3; a request
  whose deadline passed in the queue raises ``DeadlineExceeded`` with no
  prefill dispatched; a raising walker and an out-of-range token each
  quarantine their slot alone; mixed classes are served to completion;
  with one slot the engine admits a mixed-class backlog in the JAX
  engine's order.
"""

import asyncio
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import slo as jax_slo
from gofr_tpu.container import new_mock_container
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.tpu import sched as jax_sched
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu_torch import slo as pt_slo
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.tpu import constrain as pt_constrain
from gofr_tpu_torch.tpu import generate as generate_mod
from gofr_tpu_torch.tpu import sched as pt_sched
from gofr_tpu_torch.tpu.generate import (BrownoutShed, GenerationEngine,
                                         Sampling, _Request)

CLASSES = ("interactive", "standard", "batch", "migrated")


# -- the queues ----------------------------------------------------------------

def _script(seed, arrivals=200):
    """A seeded sequence of ("put", class) and ("pop",) with idle gaps:
    now and then the queue drains before arrivals resume."""
    rng = np.random.default_rng(seed)
    ops, queued, made = [], 0, 0
    while made < arrivals:
        if rng.random() < 0.06:
            ops += [("pop",)] * queued      # idle gap: drain everything
            queued = 0
            continue
        if queued and rng.random() < 0.45:
            ops.append(("pop",))
            queued -= 1
            continue
        cls = CLASSES[int(rng.choice(4, p=[0.3, 0.2, 0.4, 0.1]))]
        ops.append(("put", cls))
        queued += 1
        made += 1
    return ops + [("pop",)] * queued


def _run(queues, ops):
    popped = []
    for n, op in enumerate(ops):
        if op[0] == "put":
            queues.put_nowait((op[1], n), op[1])
        else:
            popped.append(queues.get_nowait())
    return popped


@pytest.mark.parametrize("weights", [None, "prefill", "decode",
                                     "interactive:3,batch:0.5,migrated:6"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_class_queues_pop_in_jax_order(seed, weights):
    ops = _script(seed)
    assert sum(op[0] == "put" for op in ops) == 200
    if weights in ("prefill", "decode"):
        w = [impl.role_class_weights(weights) for impl in (jax_sched,
                                                           pt_sched)]
    else:
        w = [impl.parse_class_weights(weights) if weights else None
             for impl in (jax_sched, pt_sched)]
    jq, pq = jax_sched.ClassQueues(w[0]), pt_sched.ClassQueues(w[1])
    assert _run(pq, ops) == _run(jq, ops)
    assert pq.served() == jq.served() and pq.weights() == jq.weights()
    assert pq.depths() == jq.depths() and pq.empty()


def test_class_queues_depths_drain_and_set_weights_as_jax():
    for impl in (jax_sched, pt_sched):
        queues = impl.ClassQueues()
        queues.put_nowait("a", "batch")
        queues.put_nowait("b", "tenant-x")
        assert queues.qsize() == 2
        assert queues.depths() == {"interactive": 0, "standard": 0,
                                   "batch": 1, "tenant-x": 1}
        with pytest.raises(ValueError):
            queues.set_weights({"batch": 0})
        queues.set_weights({"batch": 2.0})
        assert queues.weights() == {"batch": 2.0}
        assert list(queues.drain()) == [("batch", "a"), ("tenant-x", "b")]
        with pytest.raises(IndexError):
            queues.get_nowait()


def test_deadline_class_and_weights_as_jax():
    now = 100.0
    for delta in (None, -1.0, 0.0, 0.5, 1.999, 2.0, 2.0001, 2.001, 5.0,
                  1e6):
        deadline = None if delta is None else now + delta
        for budget in (2.0, 10.0, 0.1):
            assert pt_sched.deadline_class(deadline, now, budget) == \
                jax_sched.deadline_class(deadline, now, budget)
    assert pt_sched.deadline_class(now + 2.0, now=now) == "interactive"
    assert pt_sched.deadline_class(now + 2.001, now=now) == "standard"
    assert pt_sched.deadline_class(None) == "batch"
    for spec in (None, "", "interactive:8,batch:0.5",
                 "junk,interactive:abc,standard:-3,a:b:c", "tenant-x:7"):
        assert pt_sched.parse_class_weights(spec) == \
            jax_sched.parse_class_weights(spec)
        for role in ("prefill", "decode", "both", "other"):
            assert pt_sched.role_class_weights(role, spec) == \
                jax_sched.role_class_weights(role, spec)
    for level in range(-2, 7):
        assert pt_sched.brownout_shed_classes(level) == \
            jax_sched.brownout_shed_classes(level)
    assert pt_sched.DEFAULT_CLASS_WEIGHTS == jax_sched.DEFAULT_CLASS_WEIGHTS
    assert pt_sched.ROLE_CLASS_WEIGHTS == jax_sched.ROLE_CLASS_WEIGHTS
    assert pt_sched.CLASS_MIGRATED == jax_sched.CLASS_MIGRATED


def test_deadline_helpers_as_jax_with_their_own_contextvar():
    for raw in ("", "250", "0", "-5", "abc", "1.5e3", None):
        assert pt_slo.parse_deadline_header(raw) == \
            jax_slo.parse_deadline_header(raw)
    assert pt_slo.set_request_deadline(500.0, now=10.0) == \
        jax_slo.set_request_deadline(500.0, now=10.0) == 10.5
    assert pt_slo.current_deadline() == 10.5
    # the two packages' contextvars are apart: the JAX app's setting does
    # not reach the port
    jax_slo.set_request_deadline(None)
    assert pt_slo.current_deadline() == 10.5
    pt_slo.set_request_deadline(-1)
    assert pt_slo.current_deadline() is None
    assert pt_slo.DeadlineExceeded.status_code == 503 == \
        jax_slo.DeadlineExceeded.status_code
    assert str(pt_slo.DeadlineExceeded()) == str(jax_slo.DeadlineExceeded())


# -- the engine ----------------------------------------------------------------

ENGINE_KW = dict(max_len=64, prompt_buckets=(8, 16))


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    return jax.tree.map(np.asarray,
                        jax_llama.init(jcfg, jax.random.PRNGKey(0)))


def _cfg(**over):
    return pt_llama.config("tiny", dtype=torch.float32, use_flash=True,
                           **over)


def _engine(weights, max_slots=4, **kw):
    return GenerationEngine(_cfg(), from_jax_llama(weights, "cpu"),
                            device="cpu", max_slots=max_slots,
                            **{**ENGINE_KW, **kw})


def _jax_engine(weights, max_slots=4, **kw):
    container = new_mock_container()
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    return JaxEngine(jcfg, weights, logger=container.logger,
                     metrics=container.metrics, max_slots=max_slots,
                     **{**ENGINE_KW, **kw})


def test_overflow_sheds_deepest_class_newest_as_jax(weights):
    """The same overflow in both engines (cap 4: three batch, then two
    interactive, then a batch): each shed takes the deepest class's
    newest entry; the other class's entries survive."""
    classes = ["batch", "batch", "interactive", "batch", "interactive",
               "batch"]
    jax_engine, engine = _jax_engine(weights), _engine(weights)

    async def main():
        loop = asyncio.get_running_loop()
        jax_entries, entries = [], []
        for cls in classes:
            flight = jax_engine._new_flight([1, 2, 3], budget=4)
            jax_entries.append(([1, 2, 3], 8, 4, None, None,
                                loop.create_future(), None, 0.0, flight,
                                cls, None))
            entries.append(_Request([1, 2, 3], 8, 4, None, Sampling(),
                                    loop.create_future(), None, cls, None,
                                    None))
        jax_engine._overflow_cap = engine._overflow_cap = 3
        jax_engine._overflow.extend(jax_entries)
        engine._overflow.extend(entries)
        jax_engine._shed_overflow()
        engine._shed_overflow()
        shed = [i for i, e in enumerate(entries) if e.future.done()]
        assert shed == [i for i, e in enumerate(jax_entries) if e[5].done()]
        assert shed == [1, 3, 5]
        assert [e.cls for e in engine._overflow] == \
            [e[9] for e in jax_engine._overflow]
        assert engine.stats()["classes"]["shed"] == jax_engine._shed_by_class
        with pytest.raises(RuntimeError, match="admission overflow"):
            entries[shed[0]].future.result()
        for e in jax_entries + entries:
            fut = e[5] if isinstance(e, tuple) else e.future
            if not fut.done():
                fut.cancel()

    asyncio.run(main())
    assert engine.stats()["classes"]["shed"] == {"batch": 3}


def test_paged_pass_short_of_pages_defers_to_overflow(weights):
    """A pool that holds one prompt's pages at a time: the second request
    waits in the overflow (not the queues) and is served once the first
    slot returns its pages; both equal their solo runs."""
    kw = dict(paged_kv=True, kv_page=4, kv_pages=6, kv_page_reserve=1)
    first, second = list(range(1, 15)), list(range(30, 44))

    async def main(engine, prompts):
        await engine.start()
        try:
            tasks = [asyncio.ensure_future(engine.generate(p, 4))
                     for p in prompts]
            deferred = 0
            while not all(t.done() for t in tasks):
                deferred = max(deferred, len(engine._overflow))
                await asyncio.sleep(0)
            return [t.result() for t in tasks], deferred
        finally:
            await engine.stop()

    engine = _engine(weights, **kw)
    outs, deferred = asyncio.run(main(engine, [first, second]))
    assert deferred == 1 and not engine._overflow
    assert engine.stats()["kv_pool"]["used_pages"] == 0
    solo = [asyncio.run(main(_engine(weights), [p]))[0][0]
            for p in (first, second)]
    assert outs == solo


def test_brownout_gate_and_level_clamp(weights):
    engine, jax_engine = _engine(weights), _jax_engine(weights)
    for level in (-3, 0, 1, 2, 3, 9, 2):
        engine.set_brownout(level)
        jax_engine.set_brownout(level)
        assert engine._brownout == jax_engine._brownout
    assert engine.stats()["resilience"] == jax_engine.stats()["resilience"] \
        == {"brownout_level": 2, "quarantined": {}, "adopt_dedup_hits": 0,
            "adopt_ledger_entries": 0}

    async def main():
        await engine.start()
        try:
            with pytest.raises(BrownoutShed) as shed:
                await engine.generate([1, 2, 3], 4)
            assert shed.value.status_code == 503
            with pytest.raises(BrownoutShed):
                await engine.generate_stream([1, 2, 3], 4)
            assert engine._pending.empty()
            pt_slo.set_request_deadline(500.0)
            interactive = await engine.generate([1, 2, 3], 4)
            pt_slo.set_request_deadline(60_000.0)
            standard = await engine.generate([1, 2, 3], 4)
            pt_slo.set_request_deadline(None)
            engine.set_brownout(0)
            batch = await engine.generate([1, 2, 3], 4)
            return interactive, standard, batch
        finally:
            pt_slo.set_request_deadline(None)
            await engine.stop()

    interactive, standard, batch = asyncio.run(main())
    assert interactive == standard == batch
    classes = engine.stats()["classes"]
    assert classes["shed"] == {"batch": 2}
    assert classes["served"] == {"interactive": 1, "standard": 1,
                                 "batch": 1}
    assert "resilience" not in engine.stats()


@pytest.mark.parametrize("paged", [False, True])
def test_brownout_caps_and_stops_speculation(weights, paged):
    """A spec engine (γ 4, rungs 1, 2, 4): level 2 dispatches rung 1
    only, level 3 no spec tick, both with the greedy tokens of level 0."""
    tcfg = _cfg()
    draft = dict(draft_cfg=dataclasses.replace(tcfg, n_layers=1),
                 draft_params=from_jax_llama(weights, "cpu"),
                 spec_gamma=4, steps_per_tick=4)
    if paged:
        draft.update(paged_kv=True, kv_page=4)
    prompts = [[1, 2, 3], list(range(5, 15))]

    def run(level):
        engine = _engine(weights, **draft)
        engine.set_brownout(level)

        async def main():
            await engine.start()
            try:
                pt_slo.set_request_deadline(30_000.0)   # standard class
                return await asyncio.gather(*[engine.generate(p, 20)
                                              for p in prompts])
            finally:
                pt_slo.set_request_deadline(None)
                await engine.stop()
        return asyncio.run(main()), engine.stats()["speculative"]

    free, spec0 = run(0)
    capped, spec2 = run(2)
    off, spec3 = run(3)
    assert free == capped == off
    assert max(spec0["ticks_by_gamma"]) > 1
    assert set(spec2["ticks_by_gamma"]) == {1}
    assert spec3["spec_ticks"] == 0 and spec3["ticks_by_gamma"] == {}


def test_expired_deadline_is_shed_before_prefill(weights):
    engine = _engine(weights)

    async def main():
        await engine.start()
        try:
            pt_slo.set_request_deadline(1.0, now=time.monotonic() - 1.0)
            with pytest.raises(pt_slo.DeadlineExceeded) as exc:
                await engine.generate([1, 2, 3], 4)
            stream = await engine.generate_stream([1, 2, 3], 4)
            with pytest.raises(pt_slo.DeadlineExceeded):
                async for _ in stream:
                    pass
            pt_slo.set_request_deadline(None)
            return exc.value, await engine.generate([1, 2, 3], 4)
        finally:
            pt_slo.set_request_deadline(None)
            await engine.stop()

    exc, out = asyncio.run(main())
    assert exc.status_code == 503 and len(out) == 4
    stats = engine.stats()
    assert stats["prefill_dispatches"] == 1
    # shed as interactive (an expired deadline classes as interactive)
    assert stats["classes"]["served"] == {"interactive": 2, "batch": 1}


REGEX_RF = {"type": "regex", "pattern": "(yes|no)!"}


VICTIM_RF = {"type": "regex", "pattern": "[a-z0-9]+"}


class _RaisingWalker(pt_constrain.GrammarWalker):
    """A walker whose advance raises for the victim's grammar."""

    def advance(self, token_id):
        if self.grammar.pattern == VICTIM_RF["pattern"]:
            raise KeyError("walker state lost")
        return super().advance(token_id)


@pytest.mark.parametrize("fault", ["grammar", "nan_logits"])
def test_quarantine_fails_one_slot_and_the_others_finish(weights, fault,
                                                         monkeypatch):
    """A walker that raises on its first advance, or an out-of-range token
    in one slot's fetched tokens: that request fails alone, counted under
    its reason; its neighbours give their solo tokens."""
    victim = [9, 9, 9]
    others = [([1, 2, 3], REGEX_RF), ([5, 6, 7], None)]
    solo = [asyncio.run(_serve_one(_engine(weights), p, rf))
            for p, rf in [(victim, None)] + others]
    engine = _engine(weights, steps_per_tick=2)
    if fault == "grammar":
        monkeypatch.setattr(generate_mod, "GrammarWalker", _RaisingWalker)
    else:
        publish = engine._publish

        def poisoned(entry, host):
            # the victim's slot: the one whose first token is the
            # victim's solo first token (the others' differ)
            if entry.kind == "tick":
                host = host.copy()
                for slot_idx, gen in entry.payload:
                    slot = engine._slots[slot_idx]
                    if slot.gen == gen and slot.tokens[:1] == solo[0][:1]:
                        host[:, slot_idx] = engine.cfg.vocab_size + 5
            publish(entry, host)
        engine._publish = poisoned

    async def main():
        await engine.start()
        try:
            rf = VICTIM_RF if fault == "grammar" else None
            return await asyncio.gather(
                engine.generate(victim, 8, response_format=rf),
                *[engine.generate(p, 8, response_format=rf)
                  for p, rf in others], return_exceptions=True)
        finally:
            await engine.stop()

    done = asyncio.run(main())
    assert isinstance(done[0], KeyError if fault == "grammar"
                      else RuntimeError), done
    if fault == "nan_logits":
        assert "out-of-range token" in str(done[0])
        assert len({s[0] for s in solo}) == 3
    assert engine.stats()["resilience"]["quarantined"] == {fault: 1}
    assert done[1:] == solo[1:]
    assert engine.active_slots == 0 and len(engine._free) == 4


async def _serve_one(engine, prompt, rf, budget=8):
    await engine.start()
    try:
        return await engine.generate(prompt, budget, response_format=rf)
    finally:
        await engine.stop()


def test_engine_serves_mixed_classes_to_completion(weights):
    engine = _engine(weights, max_slots=2)

    async def main():
        await engine.start()
        try:
            await engine.generate([9, 9], 4)

            async def with_deadline(budget_ms, prompt):
                pt_slo.set_request_deadline(budget_ms)
                try:
                    return await engine.generate(prompt, 4)
                finally:
                    pt_slo.set_request_deadline(None)

            return await asyncio.gather(
                with_deadline(1500.0, [1, 2]), with_deadline(60_000.0, [3]),
                engine.generate([1, 2], 4), engine.generate([3, 4], 4),
                engine.generate([5], 4, response_format=REGEX_RF))
        finally:
            await engine.stop()

    outs = asyncio.run(main())
    assert all(len(o) == 4 for o in outs[:4])
    assert bytes(outs[4]).decode() in ("yes!", "no!")
    assert outs[0] == outs[2]
    classes = engine.stats()["classes"]
    assert classes["served"] == {"batch": 4, "interactive": 1,
                                 "standard": 1}
    assert classes["weights"] == pt_sched.DEFAULT_CLASS_WEIGHTS
    assert classes["depths"] == {"interactive": 0, "standard": 0,
                                 "batch": 0}


# a backlog queued before the loop starts: (prompt, deadline budget ms)
BACKLOG = [([1, 2], None), ([3, 4], 1900.0), ([5, 6], 60_000.0),
           ([7, 8], None), ([9, 10], 1900.0), ([11, 12], 1900.0),
           ([13, 14], 60_000.0), ([15, 16], None), ([17, 18], 1900.0),
           ([19, 20], None)]


def _admission_order(engine, slo_mod):
    """Warm the engine up with one request, stop its loop, queue the
    backlog (each request under its own deadline), start the loop again
    and serve it. With one slot, requests finish in the order they were
    admitted: returns the prompts in that order."""
    order = []

    async def one(prompt):
        await engine.generate(prompt, 3)
        order.append(tuple(prompt))

    async def main():
        await engine.start()
        try:
            await engine.generate([21, 22], 3)
            await engine.stop()
            tasks = []
            for prompt, budget in BACKLOG:
                slo_mod.set_request_deadline(budget)
                tasks.append(asyncio.ensure_future(one(prompt)))
            slo_mod.set_request_deadline(None)
            await asyncio.sleep(0)
            assert engine._pending.qsize() == len(BACKLOG)
            await engine.start()
            await asyncio.wait_for(asyncio.gather(*tasks), 120.0)
        finally:
            slo_mod.set_request_deadline(None)
            await engine.stop()

    asyncio.run(main())
    return order


def test_single_slot_admits_in_jax_order(weights):
    """With one slot, each admission pass takes one request: the engine
    serves a mixed-class backlog in the order the JAX engine does, which
    is ``ClassQueues``' order for the same arrivals."""
    got = _admission_order(_engine(weights, max_slots=1), pt_slo)
    want = _admission_order(_jax_engine(weights, max_slots=1), jax_slo)
    assert got == want
    queues = pt_sched.ClassQueues()
    for prompt, budget in BACKLOG:
        cls = pt_sched.deadline_class(
            None if budget is None else time.monotonic() + budget / 1000)
        queues.put_nowait(tuple(prompt), cls)
    assert got == [queues.get_nowait() for _ in BACKLOG]
    assert got != [tuple(prompt) for prompt, _ in BACKLOG]
