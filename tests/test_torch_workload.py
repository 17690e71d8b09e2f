"""Port parity for the workload plane (``tpu/workload.py``, the engine's
``attach_workload`` and the flight recorder's workload attachment)
against the JAX package on the CPU.

- The recorder against JAX's on the same scripted records and clock: the
  ring bound, the one-shot finish, ``snapshot()``, the class-mix
  cardinality gate, the batcher's enqueue pulse and the prompt-length
  distribution.
- ``export_trace`` equals JAX's apart from ``created_unix``; the trace
  round-trips through JSON and ``load_trace``, and ``load_trace``
  refuses schema skew with JAX's errors and messages.
- ``_synth_prompt`` and ``_request_seed`` are JAX's.
- ``replay_trace`` (time scale 0) on the port engine twice gives one
  digest, equal to JAX's replay of the same trace on the JAX engine
  (``tiny``, float32, dense then paged); with a recorder attached to
  each engine, both record the replayed admissions alike, and ``xlaz()``
  suggests its ladder from them (``ladder_source="workload_trace"``),
  as JAX's does.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jax_llama
from gofr_tpu.tpu import workload as jax_wl
from gofr_tpu.tpu.flightrecorder import RequestRecord as JaxRecord
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.tpu import workload as pt_wl
from gofr_tpu_torch.tpu.flightrecorder import RequestRecord
from gofr_tpu_torch.tpu.generate import GenerationEngine

ENGINE_KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16),
                 steps_per_tick=4)
CASES = {"dense": {}, "paged": dict(paged_kv=True, kv_page=4)}
PACKAGES = {"jax": (jax_wl, JaxRecord), "port": (pt_wl, RequestRecord)}


class Calls:
    def __init__(self):
        self.calls = []

    def increment_counter(self, name, **labels):
        self.calls.append((name, tuple(sorted(labels.items()))))


def _script(seed=11, n=40):
    """(now, model, cls, prompt_len, budget, deadline offset or None,
    tokens, cached, status or None) rows."""
    rng = np.random.default_rng(seed)
    rows, now = [], 500.0
    for i in range(n):
        now += float(rng.exponential(0.05))
        rows.append((now, "generate" if i % 5 else "draft",
                     ("interactive", "standard", "batch")[i % 3],
                     int(rng.integers(1, 3000)), int(rng.integers(1, 64)),
                     None if i % 4 else float(rng.uniform(0.1, 3.0)),
                     int(rng.integers(0, 64)), int(rng.integers(0, 2)) * 32,
                     None if i % 7 == 6 else ("done", "cancelled",
                                              "error")[i % 3]))
    return rows


def _record_script(package, capacity=16):
    mod, record_cls = PACKAGES[package]
    calls = Calls()
    rec = mod.TrafficRecorder(capacity=capacity, metrics=calls)
    for (now, model, cls, plen, budget, dl, tokens, cached,
         status) in _script():
        record = record_cls(model=model, prompt_len=plen, budget=budget)
        rec.admit(record, cls, None if dl is None else now + dl, now=now)
        assert record.wevent is not None
        if status is not None:
            record.tokens, record.cached_prefix_len = tokens, cached
            record.status = status
            rec.finish(record)
            rec.finish(record)        # one-shot: a second finish is a no-op
            assert record.wevent is None
        rec.note_enqueue(model, now=now)
    # the class-mix cardinality gate: past 64 keys, "_other"
    for i in range(70):
        rec.admit(record_cls(prompt_len=3, budget=2), f"tenant-{i}",
                  now=600.0 + i)
    return rec, calls.calls


@pytest.fixture(scope="module")
def recorders():
    return {pkg: _record_script(pkg) for pkg in PACKAGES}


def test_recorder_snapshot_and_ring_as_jax(recorders):
    port, jax_ = recorders["port"][0], recorders["jax"][0]
    snap = port.snapshot()
    assert snap == jax_.snapshot()
    assert snap["window_events"] == 16 and snap["admitted_total"] == 110
    # 64 keys, then every newcomer saturates into one "_other" key
    assert "_other" in snap["class_mix"] and len(snap["class_mix"]) == 65
    assert port.prompt_length_distribution() \
        == jax_.prompt_length_distribution()
    assert port.prompt_length_distribution("generate") \
        == jax_.prompt_length_distribution("generate")
    assert recorders["port"][1] == recorders["jax"][1]


def test_export_trace_and_load_as_jax(recorders):
    port, jax_ = recorders["port"][0], recorders["jax"][0]
    trace, jax_trace = port.export_trace(), jax_.export_trace()
    for doc in (trace, jax_trace):
        doc.pop("created_unix")
    assert trace == jax_trace
    loaded = pt_wl.load_trace(json.dumps(port.export_trace()))
    jax_loaded = jax_wl.load_trace(json.dumps(jax_.export_trace()))
    fields = pt_wl.TrafficEvent.__slots__
    assert [[getattr(e, f) for f in fields] for e in loaded.events] \
        == [[getattr(e, f) for f in fields] for e in jax_loaded.events]
    assert loaded.version == pt_wl.TRACE_VERSION == jax_wl.TRACE_VERSION


@pytest.mark.parametrize("payload", [
    {"kind": "other", "version": 1}, {"kind": jax_wl.TRACE_KIND, "version": 2},
    [1, 2, 3], '{"kind": "gofr-workload-trace", "version": null}'])
def test_load_trace_refuses_skew_as_jax(payload):
    messages = []
    for mod in (jax_wl, pt_wl):
        with pytest.raises(mod.TraceVersionError) as info:
            mod.load_trace(payload)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    assert issubclass(pt_wl.TraceVersionError, ValueError)


def test_synth_prompt_and_request_seed_as_jax():
    for index, length, vocab, seed in ((0, 1, 256, 0), (3, 17, 256, 0x5EED),
                                       (91, 512, 32000, 12345),
                                       (7, 0, 2, 1)):
        assert pt_wl._synth_prompt(index, length, vocab, seed) \
            == jax_wl._synth_prompt(index, length, vocab, seed)
        assert pt_wl._request_seed(index, seed) \
            == jax_wl._request_seed(index, seed)


# -- replay through the engines -------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    return jax.tree.map(np.asarray,
                        jax_llama.init(jcfg, jax.random.PRNGKey(0)))


def _trace():
    """A shape-only trace the tiny engines serve: 8 requests, prompts of
    1-16 tokens, 2-10 tokens out, three classes, one still in flight."""
    rec = pt_wl.TrafficRecorder()
    rows = [(3, 8, "interactive"), (16, 6, "standard"), (9, 10, "batch"),
            (1, 2, "standard"), (12, 7, "interactive"), (5, 9, "batch"),
            (14, 4, "standard"), (7, 10, "interactive")]
    for i, (plen, out, cls) in enumerate(rows):
        record = RequestRecord(prompt_len=plen, budget=out + 2)
        rec.admit(record, cls, now=100.0 + 0.01 * i)
        if i != 5:
            record.tokens, record.status = out, "done"
            rec.finish(record)
    return rec.export_trace()


def _replay(package, weights, case):
    mod = PACKAGES[package][0]
    if package == "jax":
        jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
        engine = JaxEngine(jcfg, weights, **ENGINE_KW, **CASES[case])
    else:
        tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
        engine = GenerationEngine(tcfg, from_jax_llama(weights, "cpu"),
                                  device="cpu", **ENGINE_KW, **CASES[case])
    recorder = mod.TrafficRecorder()
    engine.attach_workload(recorder)
    assert engine.recorder.workload is recorder
    trace = mod.load_trace(_trace())

    async def run():
        await engine.start()
        try:
            return [await asyncio.wait_for(
                mod.replay_trace(engine, trace, time_scale=0.0), 120.0)
                for _ in range(2)]
        finally:
            await engine.stop()
    results = asyncio.run(run())
    return results, recorder.snapshot(), engine.xlaz()


@pytest.fixture(scope="module")
def replays(weights):
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = {pkg: _replay(pkg, weights, case)
                           for pkg in PACKAGES}
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_replay_digest_is_stable_and_jax(replays, case):
    runs = replays(case)
    (first, second), _, _ = runs["port"]
    assert first["digest"] == second["digest"]
    assert first == runs["jax"][0][0] == runs["jax"][0][1]
    assert first["requests"] == 8 and first["errors"] == 0
    # each request's recorded output length; the one in flight its budget
    assert first["admitted_tokens"] == 8 + 6 + 10 + 2 + 7 + 11 + 4 + 10


@pytest.mark.parametrize("case", list(CASES))
def test_attached_recorder_and_ladder_as_jax(replays, case):
    runs = replays(case)
    port_snap, jax_snap = runs["port"][1], runs["jax"][1]
    for key in ("admitted_total", "finished_total", "class_mix",
                "finish_mix", "prompt_len", "output_len", "prefix_reuse"):
        assert port_snap[key] == jax_snap[key], key
    assert port_snap["admitted_total"] == port_snap["finished_total"] == 16
    prompt = runs["port"][2]["models"]["prompt"]
    assert prompt["ladder_source"] == "workload_trace"
    assert prompt == runs["jax"][2]["models"]["prompt"]
