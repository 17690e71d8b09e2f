"""Port parity for disaggregated serving (``gofr_tpu_torch/tpu/cluster.py``
and the engine's ``prefill_export`` / ``adopt_kv`` / ``export_session`` /
``adopt_session``) against the JAX package on the CPU (``tiny``,
float32), the counterparts of ``tests/test_disagg.py``:

- greedy token identity through the port's ``DisaggRouter`` (a dense
  prefill replica, a paged decode replica, ``InProcTransport``) against
  JAX's monolithic paged engine, for the bf16-layout raw wire, the int8
  wire and with the prefix store on; zero prefill on the decode replica;
- sampled identity with an explicit seed;
- one trace across the hop, and the router's stitched timeline;
- geometry, codec and session-flag refusals with JAX's messages;
- a drained decode replica's free pages return to their baseline;
- the cluster registry's routing by role, open circuits and draining,
  role-aware health, ``parse_peers`` and the handoff table, each against
  JAX's on the same inputs;
- blobs crossing the packages: JAX's engine exports, the port's adopts
  (and the other way round), and the tokens are the other package's;
- session migration with ticks in flight: the whole stream equals JAX's
  monolithic one, greedy and sampled, the state's keys are JAX's, and a
  constrained session or a dense engine is refused as in JAX;
- the engine's ``stats()`` handoff counters and resilience keys, and
  ``hbm_attribution()``'s migrated pages.
"""

import asyncio
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jax_llama
from gofr_tpu.tpu import cluster as jax_cluster
from gofr_tpu.tpu import kv_wire as jax_wire
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu.tpu.generate import Sampling as JaxSampling
from gofr_tpu_torch.metrics import Manager, register_engine_metrics
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.tpu import cluster as pt_cluster
from gofr_tpu_torch.tpu import kv_wire as pt_wire
from gofr_tpu_torch.tpu.cluster import (ROLE_DECODE, ROLE_PREFILL,
                                        ClusterRegistry, DisaggRouter,
                                        InProcTransport, NoReplicaAvailable)
from gofr_tpu_torch.tpu.generate import GenerationEngine, Sampling
from gofr_tpu_torch.trace import ListExporter, Tracer

ENGINE_KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16))
REQUESTS = [([1, 2, 3, 4, 5], 8), (list(range(1, 11)), 8), ([9, 8, 7], 6),
            ([1, 2, 3, 4, 5], 8)]
SAMPLED = [([1, 2, 3, 4, 5], 8), (list(range(1, 9)), 8)]


def _sampling(pkg):
    cls = JaxSampling if pkg == "jax" else Sampling
    return cls(temperature=0.9, top_k=7, seed=1234)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    jparams = jax_llama.init(jcfg, jax.random.PRNGKey(0))
    tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
    return jcfg, jparams, tcfg, from_jax_llama(
        jax.tree.map(np.asarray, jparams), "cpu")


def _cfgs(model, kv_int8=False):
    jcfg, jparams, tcfg, tparams = model
    return (dataclasses.replace(jcfg, kv_int8=kv_int8), jparams,
            dataclasses.replace(tcfg, kv_int8=kv_int8), tparams)


def _port(tcfg, tparams, **kw):
    return GenerationEngine(tcfg, tparams, **dict(ENGINE_KW, **kw),
                            device="cpu")


def _jax(jcfg, jparams, **kw):
    return JaxEngine(jcfg, jparams, **dict(ENGINE_KW, **kw))


async def _monolithic(engine, requests, sampled=False):
    await engine.start()
    try:
        return [await asyncio.wait_for(engine.generate(
            prompt, budget, sampling=_sampling("jax") if sampled else None),
            60.0) for prompt, budget in requests]
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def jax_reference(model):
    """JAX's monolithic paged engine's tokens by (kv_int8, prefix_cache,
    sampled), each computed once."""
    cache = {}

    def get(kv_int8=False, prefix_cache=False, sampled=False):
        key = (kv_int8, prefix_cache, sampled)
        if key not in cache:
            jcfg, jparams, _, _ = _cfgs(model, kv_int8)
            cache[key] = asyncio.run(_monolithic(
                _jax(jcfg, jparams, paged_kv=True, kv_page=4,
                     prefix_cache=prefix_cache),
                SAMPLED if sampled else REQUESTS, sampled))
        return cache[key]
    return get


def _cluster(prefill_eng, decode_eng, metrics=None):
    cluster = ClusterRegistry(metrics=metrics)
    cluster.register("p0", ROLE_PREFILL, InProcTransport(prefill_eng))
    cluster.register("d0", ROLE_DECODE, InProcTransport(decode_eng))
    return cluster


async def _disagg(tcfg, tparams, requests, sampled=False, tracer=None,
                  prefix_cache=False, metrics=None):
    """A dense prefill replica and a paged decode replica behind the
    port's router (JAX's test topology)."""
    prefill_eng = _port(tcfg, tparams, kv_page=4, tracer=tracer,
                        metrics=metrics)
    decode_eng = _port(tcfg, tparams, paged_kv=True, kv_page=4,
                       tracer=tracer, prefix_cache=prefix_cache,
                       metrics=metrics)
    router = DisaggRouter(_cluster(prefill_eng, decode_eng, metrics),
                          tracer=tracer, metrics=metrics)
    await decode_eng.start()             # prefill needs no engine loop
    try:
        outs = [await asyncio.wait_for(router.generate(
            prompt, budget, sampling=_sampling("port") if sampled else None),
            60.0) for prompt, budget in requests]
        return outs, prefill_eng, decode_eng, router
    finally:
        await decode_eng.stop()


@pytest.mark.parametrize("kv_int8,prefix_cache",
                         [(False, False), (True, False), (False, True)])
def test_disagg_greedy_tokens_are_jax_monolithic(model, jax_reference,
                                                 kv_int8, prefix_cache):
    _, _, tcfg, tparams = _cfgs(model, kv_int8)
    metrics = register_engine_metrics(Manager())
    outs, prefill_eng, decode_eng, router = asyncio.run(_disagg(
        tcfg, tparams, REQUESTS, prefix_cache=prefix_cache,
        metrics=metrics))
    assert outs == jax_reference(kv_int8, prefix_cache)
    assert [len(out) for out in outs] == [b for _, b in REQUESTS]
    decode_stats = decode_eng.stats()
    assert decode_stats["prefill_bucket_tokens"] == 0
    assert decode_stats["prefill_dispatches"] == 0
    assert decode_stats["kv_adoptions"] == len(REQUESTS)
    prefill_stats = prefill_eng.stats()
    assert prefill_stats["kv_exports"] == len(REQUESTS)
    assert prefill_stats["prefill_bucket_tokens"] > 0
    stats = router.stats()
    assert stats["requests"] == len(REQUESTS) and stats["bytes_shipped"] > 0
    assert stats["kv_transfer_quantiles"]["count"] == len(REQUESTS)
    recent = decode_eng.recorder.snapshot()["recent"]
    assert len(recent) == len(REQUESTS)
    assert all(row["kv_transfer_bytes"] > 0 for row in recent)
    assert {r["status"] for r in prefill_eng.recorder.snapshot()["recent"]} \
        == {"exported"}
    assert metrics.value("app_tpu_kv_adoptions_total",
                         model="generate") == len(REQUESTS)
    assert metrics.value("app_tpu_kv_transfer_bytes_total",
                         model="generate") == stats["bytes_shipped"]


def test_disagg_sampled_tokens_are_jax_with_an_explicit_seed(
        model, jax_reference):
    _, _, tcfg, tparams = model
    outs, _, decode_eng, _ = asyncio.run(_disagg(tcfg, tparams, SAMPLED,
                                                 sampled=True))
    assert outs == jax_reference(sampled=True)
    assert decode_eng.stats()["prefill_bucket_tokens"] == 0


def test_disagg_trace_stitches_across_the_hop(model):
    _, _, tcfg, tparams = model
    exporter = ListExporter()
    tracer = Tracer(exporter=exporter)

    async def run():
        outs, prefill_eng, decode_eng, router = await _disagg(
            tcfg, tparams, [([1, 2, 3], 4)], tracer=tracer)
        return outs, await router.trace(router.last_trace_id), router
    outs, timeline, router = asyncio.run(run())
    tracer.shutdown()
    assert len(outs[0]) == 4
    (transfer,) = exporter.find("kv_transfer")
    assert int(transfer.attributes["bytes"]) > 0
    assert transfer.attributes["prefill_replica"] == "p0"
    assert transfer.attributes["decode_replica"] == "d0"
    assert transfer.attributes["transport"] == "inproc"
    (adopt,) = exporter.find("kv_adopt")
    (export,) = exporter.find("prefill.export")
    assert adopt.trace_id == export.trace_id == transfer.trace_id
    assert int(adopt.attributes["transfer_bytes"]) > 0
    assert int(export.attributes["pages"]) == 1
    assert timeline["stitched"] and not timeline["in_flight"]
    assert [p["name"] for p in timeline["phases"]] == [
        "prefill", "kv_transfer", "handoff_gap", "decode"]
    assert timeline["records"]["prefill"][0]["status"] == "exported"
    assert timeline["records"]["decode"][0]["kv_transfer_bytes"] > 0
    assert router.stats()["stitched_traces"] == 1


def test_adopt_refusals_match_jax(model):
    """A page-size, codec, geometry or session-flag mismatch raises
    ``KVWireError`` before anything is claimed, with JAX's messages."""
    jcfg, jparams, tcfg, tparams = model

    async def errors(engine_of, source_of, wire):
        engine = engine_of(paged_kv=True, kv_page=8)
        source = source_of(kv_page=4)
        payload = await source.prefill_export([1, 2, 3, 4, 5])
        out = []
        int8 = wire.KVPayload(
            codec=wire.CODEC_INT8, dtype="int8", page=8, tokens=5,
            n_layers=jcfg.n_layers, n_kv_heads=jcfg.n_kv_heads,
            head_dim=jcfg.head_dim, n_pages=1, first_token=1,
            sample_key=(0, 1), model="m", leaves={})
        alien = wire.KVPayload(
            codec=wire.CODEC_RAW, dtype="float32", page=8, tokens=5,
            n_layers=2, n_kv_heads=2, head_dim=4, n_pages=1,
            first_token=1, sample_key=(0, 1), model="m", leaves={})
        session = wire.KVPayload(
            codec=wire.CODEC_RAW, dtype="float32", page=8, tokens=5,
            n_layers=jcfg.n_layers, n_kv_heads=jcfg.n_kv_heads,
            head_dim=jcfg.head_dim, n_pages=1, first_token=1,
            sample_key=(0, 1), model="m", leaves={},
            flags=wire.FLAG_SESSION)
        for bad in (payload, int8, alien, session):
            with pytest.raises(wire.KVWireError) as err:
                await engine.adopt_kv(bad, 4)
            out.append(str(err.value))
        dense = engine_of(kv_page=8)
        with pytest.raises(ValueError) as err:
            await dense.adopt_kv(payload, 4)
        out.append(str(err.value))
        assert engine._pool.free_pages == engine._pool.num_pages
        return out

    want = asyncio.run(errors(lambda **kw: _jax(jcfg, jparams, **kw),
                              lambda **kw: _jax(jcfg, jparams, **kw),
                              jax_wire))
    got = asyncio.run(errors(lambda **kw: _port(tcfg, tparams, **kw),
                             lambda **kw: _port(tcfg, tparams, **kw),
                             pt_wire))
    assert got == want


def test_decode_drain_finishes_streams_and_releases_pages(model):
    _, _, tcfg, tparams = model

    async def run():
        prefill_eng = _port(tcfg, tparams, kv_page=4)
        decode_eng = _port(tcfg, tparams, paged_kv=True, kv_page=4)
        cluster = _cluster(prefill_eng, decode_eng)
        router = DisaggRouter(cluster)
        await decode_eng.start()
        try:
            baseline = decode_eng._pool.free_pages
            stream = await router.generate_stream([1, 2, 3, 4, 5],
                                                  max_new_tokens=6)
            tokens = [await asyncio.wait_for(stream.__anext__(), 60.0)]
            attribution = decode_eng.hbm_attribution()["page_pool"]
            assert attribution["pages"]["migrated"] == 2
            assert attribution["pages"]["decode"] == 0
            drain = asyncio.create_task(cluster.drain("d0", timeout_s=30.0))
            await asyncio.sleep(0)
            with pytest.raises(NoReplicaAvailable):
                cluster.pick(ROLE_DECODE)
            async for token in stream:
                tokens.append(token)
            assert len(tokens) == 6
            assert await asyncio.wait_for(drain, 30.0) is True
            for _ in range(200):
                if decode_eng._pool.free_pages == baseline:
                    break
                await asyncio.sleep(0.02)
            assert decode_eng._pool.free_pages == baseline
            assert decode_eng.hbm_attribution()["page_pool"]["pages"][
                "migrated"] == 0
            cluster.resume("d0")
            assert cluster.pick(ROLE_DECODE).name == "d0"
        finally:
            await decode_eng.stop()

    asyncio.run(run())


# -- the cluster's plumbing, against JAX's on the same inputs -------------------

class _FakeTransport:
    kind = "fake"

    def __init__(self, up=True, circuit_open=False):
        self.up = up
        self.circuit_open = circuit_open

    def available(self):
        return not self.circuit_open

    def health_check(self):
        return {"status": "UP" if self.up else "DOWN"}

    def describe(self):
        return {"kind": self.kind}


def _routing_trace(mod):
    """Every routing decision of a fixed script, with the errors raised
    (type and message)."""
    out = []

    def attempt(fn, *args):
        try:
            result = fn(*args)
            out.append(getattr(result, "name", result))
        except (ValueError, KeyError, RuntimeError) as exc:
            out.append((type(exc).__name__, str(exc)))

    cluster = mod.ClusterRegistry()
    attempt(cluster.register, "p0", "prefill", _FakeTransport())
    attempt(cluster.register, "d0", "decode", _FakeTransport())
    attempt(cluster.register, "d1", "decode", _FakeTransport())
    attempt(cluster.register, "x", "router", _FakeTransport())
    attempt(cluster.register, "p0", "prefill", _FakeTransport())
    attempt(cluster.pick, "prefill")
    for _ in range(4):
        attempt(cluster.pick, "decode")
    out.append(cluster.roles())
    picked = cluster.pick("decode")
    cluster.note_start(picked)
    attempt(cluster.pick, "decode")          # least in-flight wins
    cluster.note_end(picked)
    solo = mod.ClusterRegistry()
    solo.register("m0", "both", _FakeTransport())
    attempt(solo.pick, "prefill")
    attempt(solo.pick, "decode")
    shut = mod.ClusterRegistry()
    shut.register("d0", "decode", _FakeTransport(circuit_open=True))
    attempt(shut.pick, "decode")
    shut.register("d1", "decode", _FakeTransport())
    attempt(shut.pick, "decode")
    out.append(asyncio.run(shut.drain("d1")))
    attempt(shut.pick, "decode")
    shut.resume("d1")
    attempt(shut.pick, "decode")
    attempt(shut.resume, "nope")
    out.append(shut.stats()["roles"])
    return out


def test_cluster_routes_by_role_as_jax():
    assert _routing_trace(pt_cluster) == _routing_trace(jax_cluster)


def _health_trace(mod):
    out = []
    cluster = mod.ClusterRegistry()
    cluster.register("p0", "prefill", _FakeTransport())
    out.append(cluster.health_check())
    cluster.register("d0", "decode", _FakeTransport())
    out.append(cluster.health_check())
    cluster.register("d1", "decode", _FakeTransport(up=False))
    out.append(cluster.health_check())
    asyncio.run(cluster.drain("d0"))
    out.append(cluster.health_check())
    return out


def test_cluster_health_is_role_aware_as_jax():
    got = _health_trace(pt_cluster)
    assert got == _health_trace(jax_cluster)
    assert [h["status"] for h in got] == ["DOWN", "UP", "UP", "DOWN"]


@pytest.mark.parametrize("spec", [
    "p0=prefill@http://10.0.0.1:8000#10.0.0.1:9000, "
    "d0=decode@http://10.0.0.2:8000",
    None, "", " , ", "m=BOTH@http://x", "p0@http://x", "p0=router@http://x",
    "=decode@http://x", "d0=decode@"])
def test_parse_peers_as_jax(spec):
    def outcome(mod):
        try:
            return mod.parse_peers(spec)
        except ValueError as exc:
            return str(exc)
    assert outcome(pt_cluster) == outcome(jax_cluster)


def test_handoff_table_capacity_and_ttl_as_jax():
    def trace(mod):
        out = []
        table = mod.HandoffTable(capacity=2, ttl_s=60.0)
        first = table.put(b"one")
        second = table.put(b"two")
        third = table.put(b"three")
        out += [len(table), table.get(third), table.get(second)]
        try:
            table.get(first)
        except mod.HandoffExpired as exc:
            out.append(("expired", exc.status_code))
        table.pop(third)
        out += [len(table), table.stats()]
        brief = mod.HandoffTable(capacity=4, ttl_s=0.02)
        handoff = brief.put(b"blob")
        time.sleep(0.05)
        try:
            brief.get(handoff)
        except KeyError as exc:
            out.append(type(exc).__name__)
        try:
            brief.get("feedfacefeedface")
        except KeyError as exc:
            out.append((type(exc).__name__, str(exc)))
        out.append(brief.stats())
        return out
    assert trace(pt_cluster) == trace(jax_cluster)


# -- blobs across the packages -------------------------------------------------

@pytest.mark.parametrize("kv_int8", [False, True])
def test_blobs_cross_the_engines(model, jax_reference, kv_int8):
    """JAX's dense engine exports and the port's paged engine adopts the
    blob, and the other way round: each gives the exporting package's
    monolithic greedy tokens."""
    jcfg, jparams, tcfg, tparams = _cfgs(model, kv_int8)
    want = jax_reference(kv_int8)

    async def run(exporter, wire_out, adopter, wire_in):
        await adopter.start()
        try:
            outs = []
            for prompt, budget in REQUESTS:
                payload = await exporter.prefill_export(prompt)
                blob = wire_out.pack(payload)
                stream = await adopter.adopt_kv(wire_in.unpack(blob),
                                                budget)
                outs.append([token async for token in stream])
            return outs
        finally:
            await adopter.stop()

    to_port = asyncio.run(run(_jax(jcfg, jparams, kv_page=4), jax_wire,
                              _port(tcfg, tparams, paged_kv=True,
                                    kv_page=4), pt_wire))
    to_jax = asyncio.run(run(_port(tcfg, tparams, kv_page=4), pt_wire,
                             _jax(jcfg, jparams, paged_kv=True, kv_page=4),
                             jax_wire))
    assert to_port == want
    assert to_jax == want


# -- session migration -----------------------------------------------------------

async def _migrated(src, dst, transport, wire, prompt, budget, sampling,
                    after=8):
    """Serve ``prompt`` on ``src``; after ``after`` tokens export the live
    session (ticks in flight), ship it through the wire and resume it on
    ``dst``. Returns the whole stream, the state and the source's free
    pages before and after."""
    await src.start()
    await dst.start()
    try:
        baseline = src._pool.free_pages
        stream = await src.generate_stream(prompt, budget,
                                           sampling=sampling)
        before = []
        while len(before) < after:
            before.append(await asyncio.wait_for(stream.__anext__(), 60.0))
        payload, state = await src.export_session(stream)
        before += [token async for token in stream]
        blob = wire.pack(payload)
        resumed = await transport(dst).adopt_session(blob, state)
        rest = [token async for token in resumed]
        for _ in range(100):
            if src._pool.free_pages == baseline:
                break
            await asyncio.sleep(0.01)
        return before + rest, state, baseline, src._pool.free_pages, \
            src.stats(), dst.stats()
    finally:
        await src.stop()
        await dst.stop()


@pytest.mark.parametrize("sampled", [False, True])
def test_session_migration_gives_jax_stream(model, sampled):
    jcfg, jparams, tcfg, tparams = model
    kw = dict(paged_kv=True, kv_page=4, steps_per_tick=4,
              max_inflight_ticks=2)
    prompt, budget = list(range(1, 11)), 24

    async def mono():
        engine = _jax(jcfg, jparams, **kw)
        await engine.start()
        try:
            return await engine.generate(
                prompt, budget,
                sampling=_sampling("jax") if sampled else None)
        finally:
            await engine.stop()
    want = asyncio.run(mono())
    jax_run = asyncio.run(_migrated(
        _jax(jcfg, jparams, **kw), _jax(jcfg, jparams, **kw),
        jax_cluster.InProcTransport, jax_wire, prompt, budget,
        _sampling("jax") if sampled else None))
    got, state, baseline, free, src_stats, dst_stats = asyncio.run(
        _migrated(_port(tcfg, tparams, **kw), _port(tcfg, tparams, **kw),
                  InProcTransport, pt_wire, prompt, budget,
                  _sampling("port") if sampled else None))
    assert jax_run[0] == want
    assert got == want
    assert sorted(state) == sorted(jax_run[1])
    assert state["cls"] == jax_run[1]["cls"]
    assert free == baseline
    assert src_stats["session_exports"] == 1
    assert dst_stats["session_adoptions"] == 1
    assert dst_stats["kv_adoptions"] == 1
    assert dst_stats["prefill_bucket_tokens"] == 0


def test_session_export_refusals_match_jax(model):
    jcfg, jparams, tcfg, tparams = model
    regex = {"type": "regex", "pattern": "(ab|cd)+!"}

    async def errors(make):
        out = []
        dense = make()
        with pytest.raises(ValueError) as err:
            await dense.export_session(object())
        out.append(str(err.value))
        paged = make(paged_kv=True, kv_page=4)
        with pytest.raises(KeyError) as err:
            await paged.export_session(object())
        out.append(str(err.value))
        await paged.start()
        try:
            stream = await paged.generate_stream([97, 98], 12,
                                                 response_format=regex)
            await asyncio.wait_for(stream.__anext__(), 60.0)
            with pytest.raises(ValueError) as err:
                await paged.export_session(stream)
            out.append(str(err.value))
            stream.cancel()
        finally:
            await paged.stop()
        return out

    want = asyncio.run(errors(lambda **kw: _jax(jcfg, jparams, **kw)))
    got = asyncio.run(errors(lambda **kw: _port(tcfg, tparams, **kw)))
    assert got == want


def test_stats_carry_jax_handoff_and_resilience_keys(model):
    """After a replayed adopt the port's ``stats()`` has JAX's handoff
    counters and resilience keys, with JAX's values."""
    jcfg, jparams, tcfg, tparams = model

    async def run(make, wire):
        source = make(kv_page=4)
        engine = make(paged_kv=True, kv_page=4)
        await engine.start()
        try:
            payload = await source.prefill_export([5, 6, 7])
            first = await engine.adopt_kv(payload, 4, dedupe="t-1")
            again = await engine.adopt_kv(payload, 4, dedupe="t-1")
            assert again is first
            tokens = [token async for token in first]
            stats = engine.stats()
        finally:
            await engine.stop()
        keys = ("kv_exports", "kv_adoptions", "session_exports",
                "session_adoptions")
        return (tokens, {key: source.stats()[key] for key in keys},
                {key: stats[key] for key in keys}, stats["resilience"])

    want = asyncio.run(run(lambda **kw: _jax(jcfg, jparams, **kw), jax_wire))
    got = asyncio.run(run(lambda **kw: _port(tcfg, tparams, **kw), pt_wire))
    assert got == want
    assert got[3]["adopt_dedup_hits"] == 1
    assert got[3]["adopt_ledger_entries"] == 1
