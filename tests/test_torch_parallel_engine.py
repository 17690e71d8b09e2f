"""Port parity for the engine, the page pool, the prefix store, the
executor and the example over a mesh: the port's dp × tp engine against
the JAX package's sharded and single-device engines on the CPU, ``tiny``
at float32, greedy. JAX shards over its 8 virtual CPU devices
(tests/conftest.py); the port's mesh of the same shape lists that many
``torch.device("cpu")`` entries. Each JAX reference runs once a module.

The cases are JAX's own: the dp 4 × tp 2 dense engine
(tests/test_generate_engine.py:147-175), tp 2 paged and paged
``kv_int8``, dp 2 × tp 2 over int8 weights (tests/test_quant.py:110-135),
the sharded prefix store (tests/test_prefix_cache.py:305-330), GQA 16:4
at dp 2 × tp 4 (``__graft_entry__.py``'s dry-run phase 7); then the
refusals, JAX's and the port's, the executor over dp 8
(tests/test_tpu_executor.py:86-100) and the example's ``MESH``.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.container import new_mock_container
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.parallel import make_mesh as jax_make_mesh
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models import moe as pt_moe
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.parallel import make_mesh
from gofr_tpu_torch.parallel.mesh import Mesh
from gofr_tpu_torch.tpu.generate import GenerationEngine
from gofr_tpu_torch.tpu.page_pool import PagePool
from gofr_tpu_torch.tpu.prefix_cache import PrefixStore

CPU8 = [torch.device("cpu")] * 8
PROMPTS = [[1, 2, 3], [9, 8, 7, 6], [4, 4], [5]]
ENGINE_KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16))
PAGED = dict(paged_kv=True, kv_page=4)


async def _serve(engine, prompts, budget=6):
    await engine.start()
    try:
        return list(await asyncio.wait_for(asyncio.gather(
            *[engine.generate(p, max_new_tokens=budget) for p in prompts]),
            120.0))
    finally:
        await engine.stop()


def _models(**over):
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, **over)
    jparams = jax_llama.init(jcfg, jax.random.PRNGKey(0))
    tcfg = pt_llama.config("tiny", dtype=torch.float32, **over)
    tparams = from_jax_llama(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _jax(cfg, params, mesh=None, **kw):
    container = new_mock_container()
    return JaxEngine(cfg, params, mesh=mesh, logger=container.logger,
                     metrics=container.metrics, **{**ENGINE_KW, **kw})


def _port(cfg, params, axes=None, **kw):
    mesh = make_mesh(axes, CPU8) if axes else None
    return GenerationEngine(cfg, params, mesh=mesh, device="cpu",
                            **{**ENGINE_KW, **kw})


def _strip(spec):
    """A spec without its trailing Nones (JAX drops them)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


CASES = {
    "dense_dp4_tp2": ({}, {"dp": 4, "tp": 2}, {}, False),
    "paged_tp2": ({}, {"tp": 2}, PAGED, False),
    "paged_kv_int8_tp2": (dict(kv_int8=True), {"tp": 2}, PAGED, False),
    "int8_params_dp2_tp2": ({}, {"dp": 2, "tp": 2}, {}, True),
    "gqa16_4_dp2_tp4": (dict(n_heads=16, n_kv_heads=4), {"dp": 2, "tp": 4},
                        dict(steps_per_tick=2), False),
}


@pytest.fixture(scope="module")
def jax_runs():
    """Each case's JAX tokens, single-device and sharded, run once."""
    cache = {}

    def run(case):
        if case not in cache:
            over, axes, kw, int8 = CASES[case]
            jcfg, jparams, tcfg, tparams = _models(**over)
            if int8:
                jparams = jax_llama.quantize_params(jparams)
                tparams = from_jax_llama(jax.tree.map(np.asarray, jparams),
                                         "cpu")
            single = asyncio.run(_serve(_jax(jcfg, jparams, **kw), PROMPTS))
            sharded_engine = _jax(jcfg, jparams, jax_make_mesh(axes), **kw)
            sharded = asyncio.run(_serve(sharded_engine, PROMPTS))
            cache[case] = (tcfg, tparams, single, sharded, sharded_engine)
        return cache[case]
    return run


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_engine_gives_jax_tokens(jax_runs, case):
    tcfg, tparams, single, sharded, jengine = jax_runs(case)
    _, axes, kw, _ = CASES[case]
    assert sharded == single
    engine = _port(tcfg, tparams, axes, **kw)
    assert asyncio.run(_serve(engine, PROMPTS)) == single
    assert engine.stats()["mesh"] == jengine.stats()["mesh"] == axes
    assert engine.max_slots == jengine.max_slots
    # the per-shard shapes are JAX's
    if engine.paged:
        jleaves, pleaves = jengine._pool.leaves, engine._pool.leaves
    else:
        jleaves, pleaves = jengine.cache, engine.cache
    for name, jleaf in jleaves.items():
        pleaf = pleaves[name]
        assert _strip(pleaf.spec) == _strip(jleaf.sharding.spec), name
        shapes = {tuple(s.data.shape) for s in jleaf.addressable_shards}
        if engine.paged:
            # the port's pool holds the scratch page row JAX drops to
            shapes = {(s[0], s[1] + 1) + s[2:] for s in shapes}
        assert {tuple(t.shape) for t in pleaf.shards.flat} == shapes, name


def test_sharded_prefix_store_gives_jax_tokens():
    """tests/test_prefix_cache.py:305-330 on both packages: the store's
    pool shards kv heads on tp; a second prefill of the prompt reuses
    the first's pages and keeps its tokens."""
    jcfg, jparams, tcfg, tparams = _models()
    prompt = list(range(1, 11))

    async def waves(engine):
        await engine.start()
        try:
            return [await asyncio.wait_for(
                engine.generate(prompt, max_new_tokens=4), 60.0)
                for _ in range(2)]
        finally:
            await engine.stop()

    kw = dict(prefix_cache=True, prefix_page=4)
    want = asyncio.run(waves(_jax(jcfg, jparams, **kw)))
    sharded = asyncio.run(waves(_jax(jcfg, jparams,
                                     jax_make_mesh({"dp": 4, "tp": 2}),
                                     **kw)))
    assert sharded == want
    engine = _port(tcfg, tparams, {"dp": 4, "tp": 2}, **kw)
    assert asyncio.run(waves(engine)) == want
    assert engine._prefix.hits >= 1
    leaf = engine._prefix.pool["k"]
    assert tuple(leaf.spec) == (None, None, None, "tp", None)
    assert leaf.shard((0, 1)).shape[3] == tcfg.n_kv_heads // 2


def test_sharded_pool_and_store_stand_alone():
    """``PagePool(mesh=)`` and ``PrefixStore(mesh=)``: the shards' shapes,
    bytes that count every tp shard of a page, and a reset that clears
    every replica."""
    cfg = pt_llama.config("tiny", kv_int8=True)
    mesh = make_mesh({"dp": 2, "tp": 2}, CPU8[:4])
    pool = PagePool(cfg, page=4, num_pages=6, device="cpu", mesh=mesh)
    assert pool.page_bytes == PagePool(cfg, page=4, num_pages=6,
                                       device="cpu").page_bytes
    assert len(pool.replicas()) == 2 and len(pool.ranks()) == 2
    assert pool.ranks()[1]["k"].shape == (2, 7, 4, 1, 16)
    assert pool.ranks()[1]["ks"].shape == (2, 7, 4, 1)
    for replica in pool.replicas():
        replica[1]["k"].fill_(3)
    pool.reset()
    assert all(int(r[1]["k"].abs().sum()) == 0 for r in pool.replicas())
    store = PrefixStore(cfg, page=4, num_pages=6, device="cpu", mesh=mesh)
    rows = [{name: torch.ones((2, 1, 8) + leaf.shape[3:], dtype=leaf.dtype)
             for name, leaf in leaves.items()} for leaves in store._pool.ranks()]
    store.publish(rows, torch.tensor([0, 1]), 2)
    got = store.gather(torch.tensor([[0, 1]]))
    assert len(got) == 2 and got[1]["k"].shape == (2, 1, 8, 1, 16)
    assert all(int(r[1]["k"][:, :2].sum()) == 2 * 2 * 4 * 16
               for r in store._pool.replicas())


def test_mesh_refusals_as_jax_and_the_ports_own():
    """JAX's refusals with JAX's messages (a custom model module, paged KV
    over dp > 1, speculative decode), then the port's: tp not dividing
    the heads (JAX's ``device_put`` refuses the uneven shard there too),
    a mesh across processes, an axis other than dp and tp, and a
    non-mesh object."""
    jcfg, jparams, tcfg, tparams = _models()
    jmesh = jax_make_mesh({"dp": 2, "tp": 2})
    pmesh = make_mesh({"dp": 2, "tp": 2}, CPU8[:4])
    mcfg = pt_moe.config(base=tcfg)
    cases = [
        (dict(model_module=pt_moe), None),
        (dict(**PAGED), None),
        (dict(draft_cfg=tcfg, draft_params=tparams), None),
    ]
    jax_kw = [dict(model_module=_jax_moe_module()), dict(**PAGED),
              dict(draft_cfg=jcfg, draft_params=jparams)]
    for (kw, _), jkw in zip(cases, jax_kw):
        with pytest.raises(ValueError) as want:
            jcfg_used = jkw.pop("cfg", jcfg)
            _jax(jcfg_used, jparams if "model_module" not in jkw
                 else jkw["model_module"].init(
                     jkw["model_module"].config(base=jcfg),
                     jax.random.PRNGKey(0)), jmesh, **jkw)
        with pytest.raises(ValueError) as got:
            if "model_module" in kw:
                GenerationEngine(mcfg, pt_moe.init(mcfg, 0, device="cpu"),
                                 mesh=pmesh, device="cpu", **kw, **ENGINE_KW)
            else:
                GenerationEngine(tcfg, tparams, mesh=pmesh, device="cpu",
                                 **kw, **ENGINE_KW)
        assert str(got.value) == str(want.value)
    # tp 4 over tiny's 2 kv heads: JAX's device_put refuses the uneven
    # cache sharding; the port names the quantity
    with pytest.raises(ValueError, match="divisible by 4"):
        _jax(jcfg, jparams, jax_make_mesh({"dp": 2, "tp": 4}))
    with pytest.raises(ValueError, match="tp 4 does not divide n_kv_heads 2"):
        _port(tcfg, tparams, {"dp": 2, "tp": 4})
    across = Mesh(np.array([[torch.device("cpu")], [torch.device("meta")]],
                           dtype=object), ("dcn", "tp"),
                  processes=np.array([[0], [1]]))
    with pytest.raises(ValueError, match="span 2 processes"):
        GenerationEngine(tcfg, tparams, mesh=across, device="cpu",
                         **ENGINE_KW)
    with pytest.raises(ValueError, match="sp"):
        _port(tcfg, tparams, {"sp": 2, "tp": 2})
    with pytest.raises(ValueError, match="mesh"):
        GenerationEngine(tcfg, tparams, mesh=object(), device="cpu",
                         **ENGINE_KW)


def _jax_moe_module():
    from gofr_tpu.models import moe as jax_moe
    return jax_moe


def test_shadow_clone_and_reset_over_a_mesh():
    """A shadow clone shares the sharded params (no copy) and serves the
    same tokens; a device-state reset clears every shard of the cache;
    ``xlaz()["mesh"]`` and ``hbm_attribution()["by_device"]`` show the
    shards' bytes by device."""
    _, _, tcfg, tparams = _models()
    engine = _port(tcfg, tparams, {"dp": 2, "tp": 2})
    want = asyncio.run(_serve(engine, PROMPTS))
    clone = engine.shadow_clone()
    assert clone.params["lm_head"] is engine.params["lm_head"]
    assert asyncio.run(_serve(clone, PROMPTS)) == want
    engine._reset_device_state()
    assert all(int(t.abs().sum()) == 0
               for t in engine.cache["k"].shards.flat)
    assert engine.hbm_attribution()["params_bytes"] > 0
    # xlaz and hbmz by device: every shard on the one CPU device
    view = engine.xlaz()["mesh"]
    assert (view["shape"], view["shards"], view["devices"]) \
        == ({"dp": 2, "tp": 2}, 4, 1)
    assert engine.hbm_attribution()["by_device"] \
        == view["bytes_by_device"]
    assert view["bytes_by_device"]["cpu"] >= \
        engine.hbm_attribution()["params_bytes"]


def test_executor_over_a_dp_mesh_as_jax(mock_container):
    """tests/test_tpu_executor.py:86-100: ``TPU_MESH=dp:2,tp:4`` gives the
    mesh shape; dp 8 predicts JAX's values; a tp ``param_specs`` is
    refused (an arbitrary fn is not partitioned without GSPMD)."""
    from gofr_tpu.config import MapConfig
    from gofr_tpu.tpu.executor import Executor as JaxExecutor
    from gofr_tpu.tpu.executor import new_executor as jax_new_executor
    from gofr_tpu_torch.parallel import P
    from gofr_tpu_torch.tpu.executor import Executor, new_executor

    config = MapConfig({"TPU_MESH": "dp:2,tp:4"})
    jex = jax_new_executor(config, mock_container.logger,
                           mock_container.metrics)
    pex = new_executor(config, mock_container.logger,
                       mock_container.metrics, device="cpu")
    assert dict(pex.mesh.shape) == dict(jex.mesh.shape) == {"dp": 2, "tp": 4}

    def jfn(params, x):
        return x * params["w"] + params["b"]

    jparams = {"w": jnp.float32(2.0), "b": jnp.arange(4, dtype=jnp.float32)}
    tparams = {"w": torch.tensor(2.0), "b": torch.arange(4).float()}
    jexec = JaxExecutor(mock_container.logger, mock_container.metrics,
                        mesh=jax_make_mesh({"dp": 8}))
    jexec.register("double", jfn, jparams, buckets=(8,))
    pexec = Executor(mock_container.logger, mock_container.metrics,
                     mesh=make_mesh({"dp": 8}, CPU8), device="cpu")
    pexec.register("double", jfn, tparams, buckets=(8, 3))
    assert pexec._models["double"].buckets == (8,)
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    np.testing.assert_array_equal(pexec.predict("double", x),
                                  np.asarray(jexec.predict("double", x)))
    np.testing.assert_array_equal(pexec.predict("double", x[:5]),
                                  np.asarray(jexec.predict("double", x[:5])))
    with pytest.raises(ValueError, match="shards a parameter"):
        pexec.register("tp", jfn, tparams, buckets=(8,),
                       param_specs={"w": P(), "b": P("dp")})


def test_example_mesh_serves_the_tokens_of_mesh_off(monkeypatch):
    """``MESH=tp:2`` over two CPU devices serves ``/generate`` with the
    tokens of ``MESH=off`` (at float32, JAX's weights)."""
    from test_torch_llama_generate import (ENV, UNSET, LoopThread,
                                           _jax_weights, _request)

    from gofr_tpu_torch.examples import llama_generate

    for key in UNSET:
        monkeypatch.delenv(key, raising=False)
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setitem(pt_llama.PRESETS, "tiny", dataclasses.replace(
        pt_llama.PRESETS["tiny"], dtype=torch.float32))
    apps = {}
    for spec in ("off", "tp:2"):
        monkeypatch.setenv("MESH", spec)
        apps[spec] = llama_generate.build_app(
            device="cpu", params_fn=_jax_weights)
    assert apps["tp:2"].engine.stats()["mesh"] == {"dp": 1, "tp": 2}
    loop = LoopThread()
    try:
        for app in apps.values():
            app.http_port = app.metrics_port = app.grpc_port = 0
            loop.run(app.start())
        body = {"prompt": "the quick brown fox", "max_new_tokens": 8}
        got = {spec: loop.run(_request(app.bound_http_port, "POST",
                                       "/generate", body))
               for spec, app in apps.items()}
    finally:
        for app in apps.values():
            loop.run(app.stop())
        loop.close()
    import json
    tokens = {spec: json.loads(res[2])["data"]["tokens"]
              for spec, res in got.items()}
    assert got["tp:2"][0] == got["off"][0] == 201
    assert tokens["tp:2"] == tokens["off"] and len(tokens["off"]) == 8


def test_example_7b_presets_serve_unsharded_without_a_knob(monkeypatch):
    """JAX's example shards the 7B-class presets over every device by
    default; an engine on the card serves a mesh on one card only, so
    with several distinct cards and no ``MESH`` the port's example
    builds them unsharded instead of refusing at build (``llama3-8b``
    here at tiny's widths)."""
    from test_torch_llama_generate import UNSET

    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.examples import llama_generate
    from gofr_tpu_torch.parallel import mesh as mesh_mod

    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(mesh_mod, "visible_devices", lambda: cards)
    for key in UNSET:
        monkeypatch.delenv(key, raising=False)
    assert llama_generate.mesh_from_config(MapConfig({}), cards[0]) is None
    with pytest.raises(ValueError, match="must share that card"):
        mesh_mod.check_one_card(mesh_mod.device_mesh({"tp": 2}, cards[0]),
                                cards[0], "engine")
    monkeypatch.setitem(pt_llama.PRESETS, "llama3-8b",
                        pt_llama.PRESETS["tiny"])
    monkeypatch.setenv("LLAMA_PRESET", "llama3-8b")
    monkeypatch.setenv("GENERATE_SLOTS", "2")
    app = llama_generate.build_app(device="cpu")
    assert app.engine.stats()["mesh"] is None
