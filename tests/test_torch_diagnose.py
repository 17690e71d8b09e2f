"""Port parity for slow-request diagnosis (``tpu/diagnose.py``) and the
flight recorder's offender attachment against the JAX package on the
CPU.

- ``diagnose`` over the same records and window contexts gives JSON
  byte-identical to JAX's, over cases that fire every rule of the table.
- ``WorstOffenders``: the same bound (k a window, ``keep_windows``
  windows), order, worst and lookups as JAX's ring over the same
  records.
- ``build_window_context`` over the port engine equals JAX's over the JAX
  engine (``tiny``, float32, dense then paged) after the same burst with
  one ``nan_logits`` fault fired; a ring attached to each engine's
  flight recorder holds every request, each with a diagnosis whose
  dominant phase is one of ``PHASES``.
"""

import asyncio
import copy
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jax_llama
from gofr_tpu.tpu import diagnose as jax_diag
from gofr_tpu.tpu import faults as jax_faults
from gofr_tpu.tpu.flightrecorder import RequestRecord as JaxRecord
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.tpu import diagnose as pt_diag
from gofr_tpu_torch.tpu import faults as pt_faults
from gofr_tpu_torch.tpu.flightrecorder import RequestRecord
from gofr_tpu_torch.tpu.generate import GenerationEngine

PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [3, 3, 3, 3, 3, 3, 3, 1],
           [5, 6, 7, 8, 9, 10, 11, 12, 13, 14], [2] * 12, [7, 7],
           [4, 4, 4], [1] * 15]
BUDGET = 10
ENGINE_KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16),
                 steps_per_tick=4)
CASES = {"dense": {}, "paged": dict(paged_kv=True, kv_page=4)}
PACKAGES = {"jax": (jax_diag, jax_faults, JaxRecord),
            "port": (pt_diag, pt_faults, RequestRecord)}


def _record(queue=2.5, ttft=2.9, finished=104.9, status="done",
            cached=0, kv_s=0.0, kv_bytes=0, rate=8.0, duration=4.9):
    return {
        "trace_id": "t-1", "span_id": None, "model": "llama",
        "status": status, "prompt_len": 64, "cached_prefix_len": cached,
        "pages_held": 0, "budget": 16, "tokens": 16,
        "queue_wait_s": queue, "ttft_s": ttft, "tokens_per_s": rate,
        "kv_transfer_s": kv_s, "kv_transfer_bytes": kv_bytes,
        "timing": {"enqueued_at": 100.0, "admitted_at": 100.0 + queue,
                   "first_token_at": 100.0 + (ttft or 0.0),
                   "finished_at": finished, "duration_s": duration},
    }


FULL_CTX = {
    "faults": {"nan_logits": 3, "tick_exception": 1},
    "anomalies": {"queue_depth": {"direction": "up", "z": 8.1},
                  "batch_fill": {"direction": "down", "z": -7.0}},
    "serving_compiles_60s": 2.0,
    "recent_compiles": [{"model": "llama", "bucket": 8, "cause": "first",
                         "duration_s": 0.4}],
    "queue_depth": 7,
    "admission_depths": {"batch": 3, "interactive": 4},
    "brownout_level": 1,
    "quarantined": {"nan_logits": 2},
}

# (record, context): together they fire every rule of the table
DIAGNOSES = {
    "backlog_everything": (_record(), FULL_CTX),
    "error_quarantine": (_record(status="error"), FULL_CTX),
    "cancelled_fault": (_record(status="cancelled"),
                        {"faults": {"tick_exception": 1}}),
    "backlog_empty_queue": (_record(), {"queue_depth": 0}),
    "cold_prefill_compile": (_record(queue=0.1, ttft=3.0, finished=103.5,
                                     duration=3.5),
                             {"serving_compiles_60s": 1.0}),
    "warm_prefill": (_record(queue=0.1, ttft=3.0, finished=103.5,
                             cached=32, duration=3.5), {}),
    "long_decode": (_record(queue=0.1, ttft=0.3, finished=110.0,
                            duration=10.0), {"brownout_level": 2}),
    "long_decode_no_rate": (_record(queue=0.1, ttft=0.3, finished=110.0,
                                    rate=None, duration=None), {}),
    "kv_transfer": (_record(queue=0.1, ttft=0.3, finished=101.0, kv_s=2.0,
                            kv_bytes=1 << 20, duration=3.0), {}),
    "no_first_token": (_record(ttft=None, finished=None, duration=None,
                               status="cancelled"), {"queue_depth": 2}),
    "empty": ({}, {}),
}


@pytest.mark.parametrize("case", list(DIAGNOSES))
def test_diagnose_json_is_jax_byte_for_byte(case):
    record, ctx = DIAGNOSES[case]
    port = json.dumps(pt_diag.diagnose(copy.deepcopy(record),
                                       copy.deepcopy(ctx)), sort_keys=True)
    jax_ = json.dumps(jax_diag.diagnose(copy.deepcopy(record),
                                        copy.deepcopy(ctx)), sort_keys=True)
    assert port == jax_


def test_every_rule_fires_and_the_table_is_jax():
    assert pt_diag.PHASES == jax_diag.PHASES
    assert [rule.__name__ for rule in pt_diag.RULES] \
        == [rule.__name__ for rule in jax_diag.RULES]
    fired = {verdict["rule"] for record, ctx in DIAGNOSES.values()
             for verdict in pt_diag.diagnose(copy.deepcopy(record),
                                             copy.deepcopy(ctx))}
    assert fired == {rule.__name__[len("_rule_"):] for rule in pt_diag.RULES
                     } - {"anomalies"} | {"telemetry_anomaly"}


def _finished(record_cls, trace, t0, e2e):
    record = record_cls(model="llama", prompt_len=4, trace_id=trace)
    record.enqueued_at = t0
    record.admitted_at = t0 + 0.5 * e2e
    record.first_token_at = t0 + 0.8 * e2e
    record.finished_at = t0 + e2e
    record.status = "done"
    record.tokens = 3
    return record


def _ring(package):
    mod, _, record_cls = PACKAGES[package]
    ring = mod.WorstOffenders(k=2, window_s=10.0, keep_windows=2,
                              context_fn=lambda: {"queue_depth": 1})
    out = []
    for i, e2e in enumerate((1.0, 5.0, 2.0, 4.0, 3.0)):
        ring.offer(_finished(record_cls, f"w1-{i}", 1000.0, e2e))
    out.append(ring.snapshot())
    ring.offer(_finished(record_cls, "w2-0", 1010.0, 6.0))
    ring.offer(_finished(record_cls, "w3-0", 1020.0, 2.0))
    out += [ring.snapshot(), ring.snapshot(limit=1), ring.find("w1-1"),
            ring.worst()["trace_id"], ring.find("w3-0")["verdicts"],
            ring.find("w3-0")["record"]["timing"]]
    return out


def test_worst_offenders_bound_and_order_as_jax():
    port, jax_ = _ring("port"), _ring("jax")
    assert port == jax_
    assert [e["trace_id"] for e in port[0]["windows"][0]["entries"]] \
        == ["w1-1", "w1-3"]
    assert len(port[1]["windows"]) == 2 and port[3] is None
    assert port[4] == "w2-0"


# -- the window context over the engines ----------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    return jax.tree.map(np.asarray,
                        jax_llama.init(jcfg, jax.random.PRNGKey(0)))


def _context_run(package, weights, case):
    mod, faults, _ = PACKAGES[package]
    if package == "jax":
        jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
        engine = JaxEngine(jcfg, weights, **ENGINE_KW, **CASES[case])
    else:
        tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
        engine = GenerationEngine(tcfg, from_jax_llama(weights, "cpu"),
                                  device="cpu", **ENGINE_KW, **CASES[case])
    ring = mod.WorstOffenders(
        k=len(PROMPTS), context_fn=lambda: mod.build_window_context(
            engine=engine))
    engine.recorder.offenders = ring

    async def run():
        await engine.start()
        try:
            faults.install(faults.FaultPlan("nan_logits:@1"))
            try:
                done = await asyncio.wait_for(asyncio.gather(
                    *[engine.generate(p, BUDGET) for p in PROMPTS],
                    return_exceptions=True), 120.0)
                ctx = mod.build_window_context(
                    engine=engine, store=SimpleNamespace(
                        anomalies=lambda: {"active": {"x": {"z": 1.0}}}))
            finally:
                faults.reset()
        finally:
            await engine.stop()
        return done, ctx
    done, ctx = asyncio.run(run())
    failed = sum(isinstance(d, BaseException) for d in done)
    return ctx, failed, ring.snapshot()


@pytest.fixture(scope="module")
def contexts(weights):
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = {pkg: _context_run(pkg, weights, case)
                           for pkg in PACKAGES}
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_window_context_as_jax_after_a_faulted_burst(contexts, case):
    runs = contexts(case)
    ctx = runs["port"][0]
    assert ctx == runs["jax"][0]
    assert ctx["faults"] == {"nan_logits": 1}
    assert ctx["quarantined"] == {"nan_logits": 1}
    assert ctx["queue_depth"] == 0 and ctx["anomalies"] == {"x": {"z": 1.0}}
    assert runs["port"][1] == runs["jax"][1] == 1


@pytest.mark.parametrize("case", list(CASES))
def test_offenders_on_the_flight_recorder(contexts, case):
    snap = contexts(case)["port"][2]
    assert snap["offered"] == len(PROMPTS) == snap["diagnosed"]
    entries = [e for w in snap["windows"] for e in w["entries"]]
    assert len(entries) == len(PROMPTS)
    assert all(e["dominant_phase"] in pt_diag.PHASES for e in entries)
    assert sorted(e["status"] for e in entries) \
        == sorted(e["status"] for w in contexts(case)["jax"][2]["windows"]
                  for e in w["entries"])
