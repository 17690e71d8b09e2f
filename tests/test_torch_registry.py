"""Port parity for the model registry (``gofr_tpu_torch/tpu/registry.py``)
against the JAX package's, the counterparts of ``tests/test_registry.py``
on the CPU (``tiny``, float32): lifecycle and its gauge, registration
checks, routing with one fallback hop (a non-READY entry, the watchdog's
``DEGRADED``), health, two models on one shared page pool, a shared
pool's reset, pool geometry, byte carves from an ``HBMBudget`` with the
carve-vs-actual view and the carve released at unload, and an MoE engine
served through the registry. Each is held to JAX's registry over JAX's
engines on the same inputs: the same states, gauge values, routes,
errors, key trees and greedy tokens.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.container import new_mock_container
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.models import moe as jax_moe
from gofr_tpu.tpu import registry as jax_registry
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu.tpu.page_pool import HBMBudget as JaxHBMBudget
from gofr_tpu.tpu.page_pool import PagePool as JaxPagePool
from gofr_tpu_torch.metrics import Manager, register_engine_metrics
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models import moe as pt_moe
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.slo import STATE_DEGRADED
from gofr_tpu_torch.tpu import registry as pt_registry
from gofr_tpu_torch.tpu.generate import GenerationEngine
from gofr_tpu_torch.tpu.page_pool import HBMBudget, PagePool

KW = dict(max_slots=2, max_len=64, prompt_buckets=(8,))


@pytest.fixture(scope="module")
def model():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    jparams = jax_llama.init(jcfg, jax.random.PRNGKey(0))
    tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
    return jcfg, jparams, tcfg, from_jax_llama(
        jax.tree.map(np.asarray, jparams), "cpu")


class _Package:
    """One package's registry, engine, pool and budget factories and a
    metrics sink with JAX's catalog."""

    def __init__(self, name, model):
        jcfg, jparams, tcfg, tparams = model
        self.name = name
        if name == "jax":
            self.registry = jax_registry
            self.metrics = new_mock_container().metrics
            self.cfg, self.params = jcfg, jparams
            self.pool = lambda **kw: JaxPagePool(jcfg, **kw)
            self.budget = JaxHBMBudget
        else:
            self.registry = pt_registry
            self.metrics = register_engine_metrics(Manager())
            self.cfg, self.params = tcfg, tparams
            self.pool = lambda **kw: PagePool(tcfg, device="cpu", **kw)
            self.budget = HBMBudget

    def engine(self, name, **kw):
        kw = dict(KW, model_name=name, metrics=self.metrics, **kw)
        if self.name == "jax":
            return JaxEngine(self.cfg, self.params, **kw)
        return GenerationEngine(self.cfg, self.params, device="cpu", **kw)


class _FakeWatchdog:
    def __init__(self, state="READY"):
        self.state = state


def _both(model, fn):
    """``fn(package)`` for JAX and the port; returns (JAX's, the port's)."""
    return tuple(fn(_Package(name, model)) for name in ("jax", "port"))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = set()
        for key, value in tree.items():
            out |= _paths(value, f"{prefix}/{key}")
        return out or {prefix}
    return {prefix}


def test_lifecycle_states_and_gauge_as_jax(model):
    def run(pkg):
        registry = pkg.registry.ModelRegistry(metrics=pkg.metrics)
        engine = pkg.engine("m")
        registry.register("m", engine)
        out = [registry._entries["m"].state,
               pkg.metrics.value("app_tpu_model_state", model="m")]

        async def main():
            task = asyncio.ensure_future(registry.warmup(
                "m", prompt_counts=(1,)))
            await asyncio.sleep(0)
            out.append(registry._entries["m"].state)
            await task
            out.append((registry._entries["m"].state,
                        pkg.metrics.value("app_tpu_model_state",
                                          model="m")))
            await registry.start("m")
            out.append(await registry.route("m").generate([1, 2, 3], 4))
            out.append(await registry.drain("m", timeout_s=5.0))
            out.append(registry._entries["m"].state)
            await registry.unload("m")
            out.append((registry._entries["m"].state,
                        pkg.metrics.value("app_tpu_model_state",
                                          model="m")))
        asyncio.run(main())
        return out
    want, got = _both(model, run)
    assert got == want
    assert got[0] == pt_registry.STATE_LOADING and got[1] == 0.0
    assert got[-1] == (pt_registry.STATE_UNLOADED, 4.0)


def test_register_validation_as_jax(model):
    def run(pkg):
        registry = pkg.registry.ModelRegistry()
        engine = pkg.engine("a")
        registry.register("a", engine)
        out = []
        for args, kw in (((("a", engine)), {}),
                         (("b", engine), dict(fallback="b")),
                         (("c", engine), dict(role="router"))):
            try:
                registry.register(*args, **kw)
            except ValueError as exc:
                out.append(str(exc))
        for call in (lambda: registry.route("nope"),
                     lambda: pkg.registry.ModelRegistry().route()):
            try:
                call()
            except (KeyError, RuntimeError) as exc:
                out.append((type(exc).__name__, str(exc)))
        out += [registry.default_model, registry.models()]
        return out
    want, got = _both(model, run)
    assert got == want and len(got) == 7


def test_route_fallback_on_non_ready_and_degraded_as_jax(model):
    def run(pkg):
        dog = _FakeWatchdog()
        registry = pkg.registry.ModelRegistry(watchdog=dog,
                                              metrics=pkg.metrics)
        big, cheap = pkg.engine("big"), pkg.engine("cheap")
        names = {id(big): "big", id(cheap): "cheap"}
        registry.register("big", big, fallback="cheap", default=True)
        registry.register("cheap", cheap)
        out = []

        async def main():
            await registry.start()
            out.append([names[id(registry.route(n))]
                        for n in ("big", None)])
            dog.state = "DEGRADED"
            out.append([names[id(registry.route(n))]
                        for n in ("big", "cheap")])
            out.append(pkg.metrics.value("app_tpu_model_fallback_total",
                                         model="big", to="cheap"))
            dog.state = "READY"
            await registry.drain("big", timeout_s=5.0)
            out.append(names[id(registry.route("big"))])
            out.append(registry.stats()["fallbacks_taken"])
            await registry.unload("cheap")
            try:
                registry.route("big")
            except pkg.registry.ModelUnavailable as exc:
                out.append((str(exc), exc.status_code, exc.model,
                            exc.state))
            await registry.stop()
        asyncio.run(main())
        return out
    want, got = _both(model, run)
    assert STATE_DEGRADED == "DEGRADED"
    assert got == want
    assert got[1] == ["cheap", "cheap"] and got[-1][1] == 503


def test_health_aggregation_and_views_as_jax(model):
    def run(pkg):
        registry = pkg.registry.ModelRegistry()
        registry.register("m", pkg.engine("m"), role="decode")
        out = [registry.health_check()]

        async def main():
            await registry.start()
            out.append(registry.health_check())
            out.append({key: _paths(getattr(registry, key)())
                        for key in ("stats", "statusz", "xlaz")})
            await registry.stop()
        asyncio.run(main())
        return out
    want, got = _both(model, run)
    assert [h["status"] for h in got[:2]] == ["DOWN", "UP"]
    for h_got, h_want in zip(got[:2], want[:2]):
        assert h_got["status"] == h_want["status"]
        assert h_got["details"]["models"]["m"] == \
            h_want["details"]["models"]["m"]
    # the registry's own layers of each view are JAX's (the engines'
    # views below them are held by tests/test_torch_telemetry.py)
    for view in ("stats", "statusz", "xlaz"):
        top = {p.split("/")[1] for p in got[2][view]}
        assert top == {p.split("/")[1] for p in want[2][view]}, view


def test_two_models_share_one_page_pool(model):
    def run(pkg):
        pool = pkg.pool(page=8, num_pages=64)
        registry = pkg.registry.ModelRegistry(page_pool=pool)
        kw = dict(paged_kv=True, kv_page=8, page_pool=pool)
        big, cheap = pkg.engine("big", **kw), pkg.engine("cheap", **kw)
        registry.register("big", big, fallback="cheap")
        registry.register("cheap", cheap)

        async def main():
            await registry.start()
            outs = await asyncio.gather(
                registry.route("big").generate([1, 2, 3], 6),
                registry.route("cheap").generate([1, 2, 3], 6))
            stats = registry.stats()
            sz = registry.statusz(recent=8)
            pages = [sz["models"][n]["kv_cache"]["pool_pages"]
                     for n in ("big", "cheap")]
            hbm = registry.hbm_attribution()
            await registry.stop()
            return (outs, stats["shared_pool"]["allocs"] >= 2, pages,
                    hbm["attributed_bytes"] - 2 * hbm["models"]["big"][
                        "params_bytes"], sorted(hbm["models"]))
        return asyncio.run(main())
    want, got = _both(model, run)
    assert got[0][0] == got[0][1] == want[0][0]
    assert got[1:3] == want[1:3] == (True, [64, 64])
    assert got[4] == want[4]
    # the shared pool is counted once (with the staging slabs each engine
    # reports, which are the port's own)
    assert got[3] >= 64 * PagePool._page_bytes(_Package("port", model).cfg,
                                               8)


def test_shared_pool_reset_fails_then_serves_again(model):
    def run(pkg):
        pool = pkg.pool(page=8, num_pages=64)
        kw = dict(paged_kv=True, kv_page=8, page_pool=pool)
        a, b = pkg.engine("a", **kw), pkg.engine("b", **kw)

        async def main():
            await a.start()
            await b.start()
            try:
                out = await b.generate([1, 2], 4)
                if pkg.name == "jax":
                    a._reset_device_state()
                else:
                    await asyncio.get_running_loop().run_in_executor(
                        a._device_exec, a._reset_device_state)
                await asyncio.sleep(0.05)
                return out, await b.generate([1, 2], 4)
            finally:
                await a.stop()
                await b.stop()
        return asyncio.run(main())
    want, got = _both(model, run)
    assert got == want and got[0] == got[1]


def test_page_pool_geometry_validation_as_jax(model):
    def run(pkg):
        pool = pkg.pool(page=8, num_pages=32)
        try:
            pkg.engine("bad", paged_kv=True, kv_page=16, page_pool=pool,
                       prompt_buckets=(16,))
        except ValueError as exc:
            return str(exc)
    want, got = _both(model, run)
    assert got == want and "page size" in got


def test_budget_carves_size_pools_through_the_registry(model):
    """Each model's pool is sized from its carve of one ``HBMBudget``
    (``kv_pool_bytes``, as the app's ``MODELS`` path carves it); the
    registry's carve-vs-actual view and the release at unload are JAX's."""
    def run(pkg):
        page_bytes = (JaxPagePool._page_bytes(pkg.cfg, 8)
                      if pkg.name == "jax"
                      else PagePool._page_bytes(pkg.cfg, 8))
        budget = pkg.budget(100 * page_bytes)
        registry = pkg.registry.ModelRegistry(hbm_budget=budget)
        out = []
        for name, pages in (("big", 48), ("cheap", 24)):
            carved = budget.carve(name, pages * page_bytes)
            registry.register(name, pkg.engine(
                name, paged_kv=True, kv_page=8, kv_pool_bytes=carved))
        try:
            budget.carve("huge", 40 * page_bytes)
        except ValueError as exc:
            out.append(str(exc))
        view = registry.hbm_attribution()
        out.append(view["hbm_budget"])
        out.append({name: (row["carved_bytes"],
                           view["models"][name]["page_pool"]["pool_bytes"])
                    for name, row in view["carve_vs_actual"].items()})
        asyncio.run(registry.unload("cheap"))
        out.append(budget.stats())
        return out
    want, got = _both(model, run)
    assert got == want
    assert got[2]["big"][0] == got[2]["big"][1]
    assert got[3]["carves"] == {"big": got[2]["big"][0]}


def test_moe_through_the_registry_gives_jax_tokens(model):
    jcfg = jax_moe.config("tiny", base=jax_llama.config("tiny",
                                                        dtype=jnp.float32))
    jparams = jax_moe.init(jcfg, jax.random.PRNGKey(0))
    tcfg = pt_moe.config("tiny", base=pt_llama.config("tiny",
                                                      dtype=torch.float32))
    tparams = from_jax_llama(jax.tree.map(np.asarray, jparams), "cpu")

    def run(mod, engine):
        registry = mod.ModelRegistry()
        registry.register("moe", engine)

        async def main():
            await registry.start()
            try:
                out = await registry.route().generate([3, 17, 42, 9], 8)
                return out, registry.stats()["models"]["moe"]["stats"][
                    "model"]
            finally:
                await registry.stop()
        return asyncio.run(main())
    want = run(jax_registry, JaxEngine(jcfg, jparams, model_module=jax_moe,
                                       model_name="moe", **KW))
    got = run(pt_registry, GenerationEngine(tcfg, tparams,
                                            model_module=pt_moe,
                                            model_name="moe", device="cpu",
                                            **KW))
    assert got == want
