"""Port parity for the fleet control plane (``gofr_tpu_torch/tpu/fleet.py``)
against the JAX package on the CPU (``tiny``, float32), the counterparts
of ``tests/test_fleet.py``, the fleet half of ``tests/test_timeseries.py``
and the resume half of ``tests/test_chaos.py``. Each case runs both
packages' fleets side by side on the same weights and inputs:

- the prefix index's depths, ties and page guard, on the same hashes;
- affinity routing over two paged replicas with the prefix store on:
  the same route decisions, depths, index and tokens;
- live migration mid-stream, greedy and sampled: the client's stream is
  JAX's (and JAX's monolithic one), the target runs no prefill, the
  source's pages come back; a bad target is refused as in JAX;
- drain by migration: the session finishes on the peer with the
  monolithic tokens, the drained replica's pages return to their
  baseline and it takes no new route;
- resumable decode: a seeded sweep of mid-decode crashes (greedy, and
  sampled, whose resume restarts the key stream from the request's seed
  as JAX's does), a crash mid-migration, the resume budget, and the
  ``fault.injected`` event on the surrounding span;
- the series rollup, the cursor-resuming refresh, a dead probe that no
  longer gives a scale-down streak, the gather's fallback to the probe
  sweep, and the autoscaler's result sequences under the same signals.
"""

import asyncio
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.metrics import timeseries as jax_timeseries
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.tpu import cluster as jax_cluster
from gofr_tpu.tpu import faults as jax_faults
from gofr_tpu.tpu import fleet as jax_fleet
from gofr_tpu.tpu import prefix_cache as jax_prefix
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu.tpu.generate import Sampling as JaxSampling
from gofr_tpu.trace.tracer import Tracer as JaxTracer
from gofr_tpu_torch.metrics import timeseries as pt_timeseries
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.tpu import cluster as pt_cluster
from gofr_tpu_torch.tpu import faults as pt_faults
from gofr_tpu_torch.tpu import fleet as pt_fleet
from gofr_tpu_torch.tpu import prefix_cache as pt_prefix
from gofr_tpu_torch.tpu.generate import GenerationEngine, Sampling
from gofr_tpu_torch.trace import Tracer as PortTracer

PKGS = {
    "jax": SimpleNamespace(cluster=jax_cluster, fleet=jax_fleet,
                           faults=jax_faults, prefix=jax_prefix,
                           timeseries=jax_timeseries, Sampling=JaxSampling,
                           Tracer=JaxTracer),
    "port": SimpleNamespace(cluster=pt_cluster, fleet=pt_fleet,
                            faults=pt_faults, prefix=pt_prefix,
                            timeseries=pt_timeseries, Sampling=Sampling,
                            Tracer=PortTracer),
}
# JAX's fleet tests' engines, and its chaos tests' smaller ones
FLEET_KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16),
                paged_kv=True, kv_page=4)
CHAOS_KW = dict(max_slots=2, max_len=32, prompt_buckets=(8,),
                paged_kv=True, kv_page=4)
SEED = 1234


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    jax_faults.reset()
    pt_faults.reset()


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    return jax.tree.map(np.asarray,
                        jax_llama.init(jcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def port_params(weights):
    return from_jax_llama(weights, "cpu")


def _engine(pkg, weights, port_params, **kw):
    if pkg == "jax":
        jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
        return JaxEngine(jcfg, weights, **kw)
    tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
    return GenerationEngine(tcfg, port_params, device="cpu", **kw)


def _sampling(pkg, sampled):
    return (PKGS[pkg].Sampling(temperature=0.9, top_k=7, seed=SEED)
            if sampled else None)


async def _fleet(pkg, weights, port_params, names=("d0", "d1"), **kw):
    """N in-proc ``both`` replicas behind the package's FleetRouter."""
    mods = PKGS[pkg]
    engines = {}
    cluster = mods.cluster.ClusterRegistry()
    for name in names:
        engines[name] = _engine(pkg, weights, port_params, **kw)
        cluster.register(name, mods.cluster.ROLE_BOTH,
                         mods.cluster.InProcTransport(engines[name]))
    router = mods.fleet.FleetRouter(cluster)
    for engine in engines.values():
        await engine.start()
    return engines, cluster, router


async def _stop(engines):
    for engine in engines.values():
        await engine.stop()


async def _pages_back(engines, baseline, deadline_s=10.0):
    deadline = time.monotonic() + deadline_s
    while True:
        now = {n: e._pool.free_pages for n, e in engines.items()}
        if now == baseline or time.monotonic() > deadline:
            return now
        await asyncio.sleep(0.02)


def _both(run, *args):
    """``run(pkg, *args)`` for both packages, each in its own loop."""
    return {pkg: asyncio.run(run(pkg, *args)) for pkg in PKGS}


@pytest.fixture(scope="module")
def reference(weights):
    """JAX's monolithic paged engine's stream, by (engine kwargs key,
    prompt, budget, sampled), each computed once."""
    cache = {}

    def get(kw, prompt, budget, sampled=False):
        key = (tuple(sorted(kw.items())), tuple(prompt), budget, sampled)
        if key not in cache:
            async def run():
                engine = _engine("jax", weights, None, **kw)
                await engine.start()
                try:
                    return await asyncio.wait_for(engine.generate(
                        prompt, max_new_tokens=budget,
                        sampling=_sampling("jax", sampled)), 60.0)
                finally:
                    await engine.stop()
            cache[key] = asyncio.run(run())
        return cache[key]
    return get


# -- the prefix index -----------------------------------------------------------

def test_prefix_index_depth_ties_and_page_guard_as_jax():
    def run(pkg):
        mods = PKGS[pkg]
        idx = mods.fleet.FleetPrefixIndex()
        hashes = mods.prefix.chain_hashes(list(range(1, 13)), 4)
        cold = mods.prefix.chain_hashes([99, 98, 97, 96], 4)
        out = [len(hashes)]
        idx.update("a", {"page": 4, "entries": hashes[:2],
                         "occupancy": 0.5})
        idx.update("b", {"page": 4, "entries": hashes[:1],
                         "occupancy": 0.1})
        out += [idx.page, idx.match_depth("a", hashes),
                idx.match_depth("b", hashes), idx.best(hashes, ["a", "b"]),
                idx.best(hashes, ["b"])]
        # equal depth: the tie goes to the lower-occupancy replica
        idx.update("a", {"page": 4, "entries": hashes[:1],
                         "occupancy": 0.5})
        out.append(idx.best(hashes, ["a", "b"]))
        # another page size drops the replica out of the index
        idx.update("a", {"page": 8, "entries": hashes[:1],
                         "occupancy": 0.0})
        out += [idx.match_depth("a", hashes), idx.stats(),
                idx.best(cold, ["b"])]
        idx.update("c", {"page": 0, "entries": hashes})
        idx.drop("b")
        out.append(idx.stats())
        return hashes, out

    (jax_hashes, jax_out), (port_hashes, port_out) = run("jax"), run("port")
    assert port_hashes == jax_hashes
    assert port_out == jax_out
    assert jax_out[4] == ("a", 2) and jax_out[6] == ("b", 1)
    assert jax_out[-1]["replicas"] == []


# -- affinity routing -------------------------------------------------------------

AFFINITY_PROMPT = list(range(1, 13))                 # 3 full pages


def test_affinity_routes_repeat_prefix_to_the_holder_as_jax(
        weights, port_params):
    async def run(pkg):
        engines, cluster, router = await _fleet(
            pkg, weights, port_params, prefix_cache=True, **FLEET_KW)
        try:
            session = await router.generate_stream(AFFINITY_PROMPT, 6)
            assert isinstance(session, PKGS[pkg].fleet.FleetSession)
            first = [token async for token in session]
            holder = session.replica_name
            routing = dict(router.fleet_stats()["routing"])
            index = await router.refresh()
            repeat = AFFINITY_PROMPT[:8] + [77, 78]
            replica, depth = router._route(repeat)
            out = await asyncio.wait_for(router.generate(repeat, 6), 60.0)
            cold, cold_depth = router._route([51, 52, 53, 54, 55])
            return {"first": first, "holder": holder, "routing": routing,
                    "index": index, "route": (replica.name, depth),
                    "out": out, "cold_depth": cold_depth,
                    "cold": cold is not None,
                    "stats": router.fleet_stats()}
        finally:
            await _stop(engines)

    runs = _both(run)
    assert runs["port"] == runs["jax"]
    jax_run = runs["jax"]
    assert len(jax_run["first"]) == len(jax_run["out"]) == 6
    assert jax_run["routing"] == {"affinity": 0, "fallback": 1}
    assert jax_run["index"]["page"] == 4
    assert jax_run["index"]["entries"][jax_run["holder"]] > 0
    assert jax_run["route"] == (jax_run["holder"], 2)
    assert jax_run["stats"]["routing"]["affinity"] == 2
    assert jax_run["cold"] and jax_run["cold_depth"] == 0


# -- live migration ---------------------------------------------------------------

@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_migration_mid_stream_is_jax_stream(weights, port_params, reference,
                                            sampled):
    prompt, budget = [1, 2, 3, 4, 5], 24

    async def run(pkg):
        engines, cluster, router = await _fleet(pkg, weights, port_params,
                                                **FLEET_KW)
        try:
            baseline = {n: e._pool.free_pages for n, e in engines.items()}
            session = await router.generate_stream(
                prompt, budget, sampling=_sampling(pkg, sampled))
            tokens = [await asyncio.wait_for(session.__anext__(), 60.0)
                      for _ in range(2)]
            source = session.replica_name
            target = await router.migrate_session(session)
            moved = (target, session.replica_name, session.migrations)
            async for token in session:
                tokens.append(token)
            free = await _pages_back(engines, baseline)
            tgt = engines[target].stats()
            return {"tokens": tokens, "source": source, "moved": moved,
                    "prefill": tgt["prefill_bucket_tokens"],
                    "adoptions": tgt["session_adoptions"],
                    "exports": engines[source].stats()["session_exports"],
                    "pages_back": free == baseline,
                    "stats": router.fleet_stats()}
        finally:
            await _stop(engines)

    runs = _both(run)
    assert runs["port"] == runs["jax"]
    jax_run = runs["jax"]
    assert jax_run["tokens"] == reference(FLEET_KW, prompt, budget, sampled)
    target = jax_run["moved"][0]
    assert target != jax_run["source"] and jax_run["moved"] == (target,
                                                                 target, 1)
    assert jax_run["prefill"] == 0 and jax_run["adoptions"] == 1
    assert jax_run["exports"] == 1 and jax_run["pages_back"]
    assert jax_run["stats"]["migrations"] == {"ok": 1, "failed": 0}


def test_migration_refuses_a_bad_target_as_jax(weights, port_params):
    async def run(pkg):
        engines, cluster, router = await _fleet(pkg, weights, port_params,
                                                **FLEET_KW)
        try:
            session = await router.generate_stream([1, 2, 3], 16)
            first = await asyncio.wait_for(session.__anext__(), 60.0)
            source = session.replica_name
            errors = []
            for name in (source, "nope"):
                with pytest.raises((ValueError, KeyError)) as info:
                    await router.migrate_session(session, target_name=name)
                errors.append((type(info.value).__name__,
                               str(info.value)))
            # a migration in flight refuses a second one
            session._next = asyncio.get_running_loop().create_future()
            with pytest.raises(RuntimeError) as info:
                await router.migrate_session(session)
            errors.append(str(info.value))
            session._next = None
            # the failed attempts left no splice armed
            target = await router.migrate_session(session)
            rest = [token async for token in session]
            return {"errors": errors, "moved": target != source,
                    "tokens": [first] + rest,
                    "stats": router.fleet_stats()}
        finally:
            await _stop(engines)

    runs = _both(run)
    assert runs["port"] == runs["jax"]
    assert runs["jax"]["moved"] and len(runs["jax"]["tokens"]) == 16
    assert "target equals" in runs["jax"]["errors"][0][1]


# -- drain by migration -------------------------------------------------------------

def test_drain_migrates_live_sessions_out_as_jax(weights, port_params,
                                                  reference):
    prompt, budget = [2, 4, 6, 8], 24

    async def run(pkg):
        engines, cluster, router = await _fleet(pkg, weights, port_params,
                                                **FLEET_KW)
        try:
            baseline = {n: e._pool.free_pages for n, e in engines.items()}
            session = await router.generate_stream(prompt, budget)
            tokens = [await asyncio.wait_for(session.__anext__(), 60.0)]
            source = session.replica_name
            other = next(n for n in engines if n != source)
            drained = await asyncio.wait_for(router.drain(source), 10.0)
            state = cluster._replicas[source].state
            moved_to = session.replica_name
            exports = engines[source].stats()["session_exports"]
            async for token in session:
                tokens.append(token)
            free = await _pages_back(engines, baseline)
            before = cluster._replicas[other].requests
            out = await asyncio.wait_for(router.generate(prompt, 4), 60.0)
            return {"drained": drained, "state": state,
                    "moved": moved_to == other, "exports": exports,
                    "tokens": tokens, "pages_back": free == baseline,
                    "out": out,
                    "routed": cluster._replicas[other].requests - before,
                    "stats": router.fleet_stats()}
        finally:
            await _stop(engines)

    runs = _both(run)
    assert runs["port"] == runs["jax"]
    jax_run = runs["jax"]
    assert jax_run["drained"] is True and jax_run["state"] == "DRAINING"
    assert jax_run["moved"] and jax_run["exports"] == 1
    assert jax_run["tokens"] == reference(FLEET_KW, prompt, budget)
    assert jax_run["pages_back"] and jax_run["routed"] == 1
    assert len(jax_run["out"]) == 4


# -- resumable decode -----------------------------------------------------------------

RESUME_PROMPT, RESUME_BUDGET = [9, 8, 7], 8


async def _chaos_fleet(pkg, weights, port_params, names):
    return await _fleet(pkg, weights, port_params, names=names, **CHAOS_KW)


@pytest.mark.parametrize("sampled,seeds", [(False, 8), (True, 3)],
                         ids=["greedy", "sampled"])
def test_decode_resume_seed_sweep_as_jax(weights, port_params, reference,
                                         sampled, seeds):
    """Seeded mid-decode crashes, each at another token index: every
    stream equals JAX's, each crash is healed by one resume, and every
    pool drains back to its baseline. Greedy streams are the undisturbed
    reference's; a sampled resume restarts the key stream from the
    request's seed on the peer (JAX's behaviour, copied)."""
    async def run(pkg):
        mods = PKGS[pkg]
        engines, cluster, router = await _chaos_fleet(
            pkg, weights, port_params, ("d0", "d1", "d2"))
        try:
            baseline = {n: e._pool.free_pages for n, e in engines.items()}
            out = []
            for seed in range(seeds):
                crash_at = 2 + seed % 5      # token indices 2..6
                plan = mods.faults.FaultPlan(
                    f"crash_mid_decode:@{crash_at}", seed=seed)
                mods.faults.install(plan)
                session = await router.generate_stream(
                    RESUME_PROMPT, max_new_tokens=RESUME_BUDGET,
                    sampling=_sampling(pkg, sampled))
                source = session.replica_name
                tokens = [token async for token in session]
                mods.faults.reset()
                free = await _pages_back(engines, baseline)
                out.append((tokens, plan.fired("crash_mid_decode"),
                            source, session.replica_name, session.resumes,
                            free == baseline))
            return out, router.fleet_stats()["resumes"]
        finally:
            mods.faults.reset()
            await _stop(engines)

    runs = _both(run)
    assert runs["port"] == runs["jax"]
    ref = reference(CHAOS_KW, RESUME_PROMPT, RESUME_BUDGET, sampled)
    out, resumes = runs["jax"]
    assert resumes == {"ok": seeds, "failed": 0}
    for seed, (tokens, fired, source, now, n, back) in enumerate(out):
        assert fired == 1 and n == 1 and now != source and back, seed
        assert len(tokens) == RESUME_BUDGET
        crash_at = 2 + seed % 5
        # the tokens delivered before the crash are the reference's
        assert tokens[:crash_at - 1] == ref[:crash_at - 1], seed
        if not sampled:
            assert tokens == ref, seed


def test_crash_mid_migration_resumes_on_the_peer_as_jax(
        weights, port_params, reference):
    async def run(pkg):
        mods = PKGS[pkg]
        # buckets up to 16: the resumed prompt is the prompt plus every
        # token delivered, the source's queued ones included
        engines, cluster, router = await _fleet(pkg, weights, port_params,
                                                **FLEET_KW)
        try:
            baseline = {n: e._pool.free_pages for n, e in engines.items()}
            session = await router.generate_stream(
                RESUME_PROMPT, max_new_tokens=RESUME_BUDGET)
            tokens = [await asyncio.wait_for(session.__anext__(), 60.0)
                      for _ in range(3)]
            mods.faults.install(mods.faults.FaultPlan(
                "crash_mid_migration:@1"))
            with pytest.raises(mods.faults.FaultError):
                await router.migrate_session(session)
            mods.faults.reset()
            tokens += [token async for token in session]
            free = await _pages_back(engines, baseline)
            return {"tokens": tokens, "resumes": session.resumes,
                    "pages_back": free == baseline,
                    "stats": {k: v for k, v in router.fleet_stats().items()
                              if k in ("migrations", "resumes")}}
        finally:
            mods.faults.reset()
            await _stop(engines)

    runs = _both(run)
    assert runs["port"] == runs["jax"]
    jax_run = runs["jax"]
    assert jax_run["tokens"] == reference(FLEET_KW, RESUME_PROMPT,
                                          RESUME_BUDGET)
    assert jax_run["resumes"] == 1 and jax_run["pages_back"]
    assert jax_run["stats"] == {"migrations": {"ok": 0, "failed": 1},
                                "resumes": {"ok": 1, "failed": 0}}


def test_resume_budget_and_fault_event_as_jax(weights, port_params):
    """A replica that keeps dying burns the resume budget (3) and then
    surfaces the fault; a crash healed by a resume leaves one
    ``fault.injected`` event on the span around the stream."""
    async def run(pkg):
        mods = PKGS[pkg]
        engines, cluster, router = await _chaos_fleet(
            pkg, weights, port_params, ("d0", "d1"))
        try:
            mods.faults.install(mods.faults.FaultPlan("crash_mid_decode"))
            session = await router.generate_stream([9, 8, 7],
                                                   max_new_tokens=6)
            with pytest.raises(mods.faults.FaultError):
                async for _ in session:
                    pass
            budget = dict(router.fleet_stats()["resumes"])
            mods.faults.reset()
            tracer = mods.Tracer("chaos-test")
            mods.faults.install(mods.faults.FaultPlan(
                "crash_mid_decode:@2", seed=3))
            with tracer.start_span("fleet.generate") as span:
                session = await router.generate_stream(
                    [9, 8, 7], max_new_tokens=6)
                tokens = [t async for t in session]
            events = [e["attributes"]
                      for e in span.find_events("fault.injected")]
            return {"budget": budget, "resume_budget": router.resume_budget,
                    "tokens": tokens, "events": events,
                    "resumes": router.fleet_stats()["resumes"]}
        finally:
            mods.faults.reset()
            await _stop(engines)

    runs = _both(run)
    assert runs["port"] == runs["jax"]
    jax_run = runs["jax"]
    assert jax_run["budget"] == {"ok": 3, "failed": 1}
    assert len(jax_run["tokens"]) == 6
    assert jax_run["events"] == [{"site": "crash_mid_decode",
                                  "arrival": "2"}]
    assert jax_run["resumes"] == {"ok": 4, "failed": 1}


# -- the series rollup ------------------------------------------------------------------

def _delta(cursor, samples, reset=False):
    return {"cursor": cursor, "reset": reset, "interval_s": 1.0,
            "samples": [
                {"seq": cursor - len(samples) + 1 + i, "t": t,
                 "values": values}
                for i, (t, values) in enumerate(samples)]}


def test_rollup_means_reset_and_misses_as_jax():
    def run(pkg):
        rollup = PKGS[pkg].fleet.FleetSeriesRollup(window_s=30.0)
        out = [rollup.ingest("d0", _delta(2, [
            (10.0, {"queue_depth": 4, "kv_occupancy": 0.5,
                    "goodput_tok_s": 100.0}),
            (11.0, {"queue_depth": 6, "kv_occupancy": 0.7,
                    "goodput_tok_s": 80.0})]), now=100.0)]
        out.append(rollup.ingest("d1", _delta(2, [
            (20.0, {"queue_depth": 1, "kv_occupancy": 0.2,
                    "goodput_tok_s": 50.0})]), now=100.0))
        out += [rollup.signals(now=100.0), rollup.cursor("d0"),
                rollup.cursor("d1"), rollup.fresh(now=100.0),
                rollup.fresh(now=200.0)]
        # a restart: the reset delta must not blend with the old window
        rollup.ingest("d0", _delta(5, [(3.0, {"queue_depth": 1,
                                              "kv_occupancy": 0.1,
                                              "goodput_tok_s": 1.0})],
                                   reset=True), now=110.0)
        out.append(rollup.signals(now=110.0))
        rollup.note_miss("d0", now=120.0)
        out += [rollup.signals(now=120.0), rollup.signals(now=200.0),
                rollup.statusz(now=120.0)]
        rollup.drop("d0")
        out.append(rollup.statusz(now=120.0))
        return out

    jax_out, port_out = run("jax"), run("port")
    assert port_out == jax_out
    assert jax_out[2]["queue_depth"] == pytest.approx(6.0)
    assert jax_out[2]["occupancy"] == pytest.approx(0.6)
    assert jax_out[9]["queue_depth"] is None
    assert jax_out[10]["misses"] == {"d0": 1}


class _ProbeTransport:
    """Decode transport double: live probes answer, dead ones raise."""

    kind = "probe"

    def __init__(self, queue_depth=2, store=None):
        self.queue_depth = queue_depth
        self.dead = False
        self.store = store

    def available(self):
        return True

    def health_check(self):
        return {"status": "UP"}

    def describe(self):
        return {"kind": self.kind}

    async def observe(self):
        if self.dead:
            raise RuntimeError("probe timeout")
        return {"kind": self.kind, "health": "UP",
                "stats": {"queue_depth": self.queue_depth}}

    async def telemetry_delta(self, cursor=None):
        if self.dead or self.store is None:
            raise RuntimeError("probe timeout")
        return self.store.delta(cursor)


def test_refresh_pulls_deltas_and_resumes_cursors_as_jax():
    async def run(pkg):
        mods = PKGS[pkg]
        store = mods.timeseries.TimeSeriesStore()
        feed = {"v": 3.0}
        store.register("queue_depth", lambda: feed["v"])
        store.register("kv_occupancy", lambda: 0.4)
        store.register("goodput_tok_s", lambda: 120.0)
        for t in range(5):
            store.sample(now=float(t))
        cluster = mods.cluster.ClusterRegistry()
        live = _ProbeTransport(store=store)
        cluster.register("d0", "decode", live)
        router = mods.fleet.FleetRouter(cluster)
        out = [await router.refresh(), router.rollup.cursor("d0"),
               router.rollup.signals()["queue_depth"]]
        for t in range(5, 8):
            store.sample(now=float(t))
        await router.refresh()
        out += [router.rollup.cursor("d0"), router.rollup._resets]
        live.dead = True                    # a miss, never an exception
        await router.refresh()
        out += [dict(router.rollup._misses), router.rollup._pulls]
        return out

    runs = _both(run)
    assert runs["port"] == runs["jax"]
    out = runs["jax"]
    assert out[1] == 5 and out[2] == pytest.approx(3.0)
    assert out[3] == 8 and out[4] <= 1 and out[5] == {"d0": 1}


def _flap_fixture(pkg):
    """Two decode replicas each holding queue depth 2; losing one probe
    used to read as the fleet going idle (sum 2 <= queue_low 2)."""
    mods = PKGS[pkg]
    cluster = mods.cluster.ClusterRegistry()
    transports = {name: _ProbeTransport(queue_depth=2)
                  for name in ("d0", "d1")}
    for name, transport in transports.items():
        cluster.register(name, "decode", transport)
    router = mods.fleet.FleetRouter(cluster)
    calls = []
    scaler = mods.fleet.Autoscaler(
        cluster, router=router, scale_up=lambda: calls.append("up"),
        scale_down=lambda name: calls.append(("down", name)),
        min_decode=1, max_decode=3, queue_high=10, queue_low=2,
        up_after=2, down_after=2, cooldown_s=0.0)
    return transports, router, scaler, calls


def _events(events):
    return [(e["result"], {k: v for k, v in e.get("signals", {}).items()},
             e.get("victim")) for e in events]


@pytest.mark.parametrize("rollup", [True, False],
                         ids=["window_means", "probe_sweep"])
def test_dead_probe_and_the_gather_fallback_as_jax(rollup):
    """With the rollup fed, a dead probe gives no scale-down streak (the
    window means keep its share); with the rollup empty the probe sweep
    serves and its old flap still shows."""
    async def run(pkg):
        transports, router, scaler, calls = _flap_fixture(pkg)
        if rollup:
            now = time.monotonic()
            for name in transports:
                router.rollup.ingest(name, _delta(3, [
                    (now - 2.0 + i, {"queue_depth": 2.0,
                                     "kv_occupancy": 0.3,
                                     "goodput_tok_s": 10.0})
                    for i in range(3)]), now=now)
        transports["d1"].dead = True
        gathered = await scaler._gather()
        events = [await scaler() for _ in range(3)]
        return {"gathered": gathered, "events": _events(events),
                "calls": calls, "down_streak": scaler._down_streak}

    runs = _both(run)
    assert runs["port"] == runs["jax"]
    out = runs["jax"]
    if rollup:
        assert out["gathered"]["source"] == "rollup"
        assert all(s["source"] == "rollup" for _, s, _ in out["events"])
        assert out["calls"] == [] and out["down_streak"] == 0
    else:
        assert out["gathered"]["source"] == "probe"
        assert out["gathered"]["queue_depth"] == 2
        assert out["calls"] and out["calls"][0][0] == "down"


# -- the autoscaler's decisions -------------------------------------------------------

class _Ledger:
    def __init__(self, n):
        self.n = n

    def serving_compiles(self, window_s):
        return self.n


class _FakeTransport:
    kind = "fake"

    def available(self):
        return True

    def health_check(self):
        return {"status": "UP"}

    def describe(self):
        return {"kind": self.kind}


def _scaler(pkg, registry=None, **kwargs):
    mods = PKGS[pkg]
    calls = []
    for key, value in dict(min_decode=1, max_decode=3, queue_high=4,
                           queue_low=1, up_after=2, down_after=2,
                           cooldown_s=0.0).items():
        kwargs.setdefault(key, value)
    scaler = mods.fleet.Autoscaler(
        registry or mods.cluster.ClusterRegistry(),
        scale_up=lambda: calls.append("up"),
        scale_down=lambda name: calls.append(("down", name)), **kwargs)
    return scaler, calls


async def _scenario(pkg, name):
    """One of JAX's autoscaler tests as a (results, calls) trace."""
    mods = PKGS[pkg]
    out = []
    pressure = {"queue_depth": 9, "decode_replicas": 1}
    if name == "hysteresis_and_bounds":
        scaler, calls = _scaler(pkg, signals_fn=lambda: dict(pressure))
        out += [(await scaler())["result"] for _ in range(3)]
        out.append(list(calls))
        pressure["decode_replicas"] = 3     # at the ceiling
        scaler, calls = _scaler(pkg, signals_fn=lambda: dict(pressure),
                                up_after=1)
        out += [(await scaler())["result"], list(calls)]
    elif name == "cooldown_and_compile_guard":
        scaler, calls = _scaler(pkg, signals_fn=lambda: dict(pressure),
                                up_after=1, cooldown_s=1000.0)
        out += [(await scaler())["result"], (await scaler())["result"],
                list(calls)]
        for n in (1, 0):
            scaler, calls = _scaler(pkg, signals_fn=lambda: dict(pressure),
                                    up_after=1, compile_ledger=_Ledger(n))
            out += [(await scaler())["result"], list(calls)]
    elif name == "scale_down_to_the_floor":
        cluster = mods.cluster.ClusterRegistry()
        cluster.register("d0", "decode", _FakeTransport())
        cluster.register("d1", "decode", _FakeTransport())
        cluster.note_start(cluster._require("d0"))     # d1 is idler
        idle = {"queue_depth": 0, "decode_replicas": 2}
        scaler, calls = _scaler(pkg, cluster, signals_fn=lambda: dict(idle))
        out += [_events([await scaler(), await scaler()]), list(calls)]
        idle["decode_replicas"] = 1
        scaler, calls = _scaler(pkg, cluster, signals_fn=lambda: dict(idle),
                                down_after=1, min_decode=2)
        out += [(await scaler())["result"], list(calls)]
    elif name == "overlapping_firings":
        gate = asyncio.Event()

        async def slow_signals():
            await gate.wait()
            return {"queue_depth": 0, "decode_replicas": 1}

        scaler, calls = _scaler(pkg, signals_fn=slow_signals)
        first = asyncio.create_task(scaler())
        await asyncio.sleep(0)                          # enter _gather
        out.append((await scaler())["result"])
        gate.set()
        out.append((await first)["result"])
        status = scaler.status()
        out += [status["busy"], [e["result"] for e in status["recent"]],
                status["bounds"], status["streaks"]]
    elif name == "bad_bounds":
        for bounds in (dict(min_decode=0),
                       dict(min_decode=2, max_decode=1)):
            with pytest.raises(ValueError) as info:
                mods.fleet.Autoscaler(mods.cluster.ClusterRegistry(),
                                      lambda: None, lambda n: None,
                                      **bounds)
            out.append(str(info.value))
    return out


SCENARIOS = {
    "hysteresis_and_bounds": ["hold", "up", "hold", ["up"], "hold", []],
    "cooldown_and_compile_guard": ["up", "cooldown", ["up"],
                                   "compile_guard", [], "up", ["up"]],
    "scale_down_to_the_floor": [
        [("hold", {"queue_depth": 0, "occupancy": None, "hbm": None,
                   "decode_replicas": 2}, None),
         ("down", {"queue_depth": 0, "occupancy": None, "hbm": None,
                   "decode_replicas": 2}, "d1")],
        [("down", "d1")], "hold", []],
    "overlapping_firings": ["overlap", "hold", False, ["overlap", "hold"],
                            {"min": 1, "max": 3}, {"up": 0, "down": 1}],
    "bad_bounds": ["min_decode must be >= 1",
                   "max_decode must be >= min_decode"],
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_autoscaler_decisions_as_jax(name):
    runs = _both(_scenario, name)
    assert runs["port"] == runs["jax"] == SCENARIOS[name]


def test_guard_passthrough_and_status_as_jax():
    def run(pkg):
        scaler, _ = _scaler(pkg, up_after=3, down_after=4, cooldown_s=7.0,
                            compile_window_s=9.0)
        return [scaler.up_after, scaler.down_after, scaler.cooldown_s,
                scaler.compile_window_s, scaler._busy, scaler._up_streak,
                scaler._down_streak, scaler._last_event_at,
                scaler.status(), scaler.guard.status()]

    assert run("port") == run("jax")
