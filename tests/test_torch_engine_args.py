"""Port parity for the engine arguments the example app passes
(``examples/llama-generate/main.py``'s ``GenerationEngine(...)`` call)
against the JAX engine on the CPU (``tiny``, float32).

- The port's constructor takes every keyword the app passes, in JAX's
  order, and the app's own keyword set builds a serving engine for
  ``tiny`` and ``moe-tiny``.
- ``kv_pool_bytes`` gives JAX's page count.
- Two engines sharing one ``page_pool``: each one's tokens, served
  concurrently, equal its tokens alone, which equal JAX's; every page
  comes back; a page-size or geometry mismatch raises JAX's message; a
  reset by one fails the other's outstanding request, which then serves
  again. ``HBMBudget`` keeps JAX's bookkeeping and errors.
- ``ragged_attn`` ``auto`` / ``on`` / ``off``: tokens equal the JAX
  engine's in the same mode; ``attn_path``, ``app_tpu_attn_kernel_total``
  labels, gather widths and window rungs as JAX's for ``off``; ``on``
  without paging and a bad mode raise JAX's messages.
- ``mesh=None`` is accepted and any other mesh refused.
- ``coalesce_uploads`` on and off give the same tokens, which equal
  JAX's; the coalescer counts one transfer a prefill group (two arrays
  each).
- ``coalesce_stream`` yields the same token sequence as without it, a
  tick's tokens as one chunk.
"""

import ast
import asyncio
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.container import new_mock_container
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu.tpu.page_pool import HBMBudget as JaxHBMBudget
from gofr_tpu.tpu.page_pool import PagePool as JaxPagePool
from gofr_tpu_torch.metrics import Manager, register_engine_metrics
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models import moe as pt_moe
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.slo import SLOTracker
from gofr_tpu_torch.tpu.constrain import token_byte_table
from gofr_tpu_torch.tpu.generate import GenerationEngine
from gofr_tpu_torch.tpu.page_pool import HBMBudget, PagePool
from gofr_tpu_torch.trace import Tracer

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = [[[1, 2, 3, 4, 5], list(range(1, 11)), [9, 8, 7], [4] * 13],
           [[7, 7, 1], list(range(30, 42)), [2, 4, 6, 8, 10], [99]]]
BUDGET = 8
ENGINE_KW = dict(max_slots=4, max_len=256, prompt_buckets=(8, 16),
                 steps_per_tick=4)
PAGED = dict(ENGINE_KW, paged_kv=True, kv_page=4)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    jparams = jax_llama.init(jcfg, jax.random.PRNGKey(0))
    tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
    return jcfg, jparams, tcfg, from_jax_llama(
        jax.tree.map(np.asarray, jparams), "cpu")


def _jax(jcfg, jparams, **kw):
    container = new_mock_container()
    return JaxEngine(jcfg, jparams, logger=container.logger,
                     metrics=container.metrics, **kw)


async def _serve(engine, prompts):
    await engine.start()
    try:
        return list(await asyncio.wait_for(asyncio.gather(
            *[engine.generate(p, BUDGET) for p in prompts]), 60.0))
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def jax_tokens(model):
    """The JAX engine's tokens by (prompt set, engine keywords), each
    computed once."""
    jcfg, jparams, _, _ = model
    cache = {}

    def get(which, **kw):
        key = (which, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = asyncio.run(_serve(_jax(jcfg, jparams, **kw),
                                            PROMPTS[which]))
        return cache[key]
    return get


def _app_call_keywords():
    """The keywords of the app's ``GenerationEngine(...)`` call."""
    tree = ast.parse((ROOT / "examples/llama-generate/main.py").read_text())
    calls = [node for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and getattr(node.func, "id", None) == "GenerationEngine"]
    assert len(calls) == 1
    return [kw.arg for kw in calls[0].keywords]


def test_constructor_takes_the_apps_keywords_in_jax_order():
    port = list(inspect.signature(GenerationEngine).parameters)
    jax_params = list(inspect.signature(JaxEngine).parameters)
    assert port[:-1] == jax_params and port[-1] == "device"
    for name in _app_call_keywords():
        assert name in port, name
    for name in jax_params:
        want = inspect.signature(JaxEngine).parameters[name].default
        got = inspect.signature(GenerationEngine).parameters[name].default
        if name != "prompt_buckets":
            assert got == want, name


@pytest.mark.parametrize("preset", ["tiny", "moe-tiny"])
def test_the_apps_keyword_set_builds_an_engine(preset):
    """``main.py``'s ``make_engine`` for one preset, with the app's
    defaults (no environment), on the CPU."""
    if preset.startswith("moe"):
        module = pt_moe
        cfg = pt_moe.config(base=pt_llama.config("tiny", vocab_size=256,
                                                 dtype=torch.float32))
        params = pt_moe.init(cfg, 0, device="cpu")
    else:
        module = pt_llama
        cfg = pt_llama.config("tiny", vocab_size=256, dtype=torch.float32)
        params = pt_llama.init(cfg, 0, device="cpu")
    metrics = register_engine_metrics(Manager())
    kwargs = dict(
        mesh=None, max_slots=8, max_len=min(cfg.max_seq_len, 1024),
        steps_per_tick=16, max_inflight_ticks=4,
        prefix_cache=False, prefix_cache_bytes=64 << 20,
        paged_kv=False, kv_page=32, ragged_attn="auto",
        kv_pool_bytes=None, page_pool=None,
        model_module=None if module is pt_llama else module,
        model_name="generate", draft_cfg=None, draft_params=None,
        spec_gamma=4, class_weights=None, coalesce_uploads=False,
        coalesce_stream=False,
        token_table=token_byte_table(vocab_size=cfg.vocab_size),
        grammar_cache_entries=32, logger=None, metrics=metrics,
        tracer=Tracer(), slo=SLOTracker(metrics))
    assert set(kwargs) == set(_app_call_keywords())
    engine = GenerationEngine(cfg, params, device="cpu", **kwargs)
    asyncio.run(engine.warmup(prompt_counts=(1, 8)))
    out = asyncio.run(_serve(engine, PROMPTS[0][:2]))
    assert [len(o) for o in out] == [BUDGET, BUDGET]


def test_kv_pool_bytes_gives_jax_page_count(model):
    jcfg, jparams, tcfg, tparams = model
    page_bytes = PagePool._page_bytes(tcfg, 4)
    assert page_bytes == JaxPagePool._page_bytes(jcfg, 4)
    for nbytes in (10_000, 3 * page_bytes + 5, 50 * page_bytes):
        port = GenerationEngine(tcfg, tparams, device="cpu",
                                kv_pool_bytes=nbytes, **PAGED)
        want = _jax(jcfg, jparams, kv_pool_bytes=nbytes, **PAGED)
        assert port._pool.num_pages == want._pool.num_pages
        assert port.stats()["kv_pool"]["pool_bytes"] \
            == want.stats()["kv_pool"]["pool_bytes"]
    # kv_pages wins over kv_pool_bytes, as in JAX
    port = GenerationEngine(tcfg, tparams, device="cpu", kv_pages=7,
                            kv_pool_bytes=10 * page_bytes, **PAGED)
    assert port._pool.num_pages == 7


def test_shared_pool_engines_match_alone_and_jax(model, jax_tokens):
    _, _, tcfg, tparams = model
    pool = PagePool(tcfg, page=4, budget_bytes=200 * PagePool._page_bytes(
        tcfg, 4), device="cpu")
    engines = [GenerationEngine(tcfg, tparams, device="cpu", page_pool=pool,
                                **PAGED) for _ in range(2)]
    assert all(e._pool is pool for e in engines)
    assert engines[0]._device_exec is engines[1]._device_exec
    alone = [asyncio.run(_serve(e, p)) for e, p in zip(engines, PROMPTS)]
    assert alone == [jax_tokens(i, ragged_attn="on", **PAGED)
                     for i in range(2)]

    async def together():
        return await asyncio.gather(*[_serve(e, p)
                                      for e, p in zip(engines, PROMPTS)])
    assert asyncio.run(together()) == alone
    assert pool.used_pages == 0


def test_shared_pool_geometry_checks_as_jax(model):
    jcfg, jparams, tcfg, tparams = model
    cases = [(dict(page=8), {}),
             (dict(page=4), dict(n_layers=3))]
    for pool_kw, cfg_over in cases:
        jpool = JaxPagePool(jax_llama.config("tiny", dtype=jnp.float32,
                                             **cfg_over), num_pages=16,
                            **pool_kw)
        ppool = PagePool(pt_llama.config("tiny", dtype=torch.float32,
                                         **cfg_over), num_pages=16,
                         device="cpu", **pool_kw)
        with pytest.raises(ValueError) as want:
            _jax(jcfg, jparams, page_pool=jpool, **PAGED)
        with pytest.raises(ValueError) as got:
            GenerationEngine(tcfg, tparams, device="cpu", page_pool=ppool,
                             **PAGED)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="mesh"):
        PagePool(tcfg, num_pages=4, device="cpu", mesh=object())
    # a mesh is served: kv heads on tp, page bytes counting every shard
    from gofr_tpu_torch.parallel import make_mesh
    sharded = PagePool(tcfg, num_pages=4, device="cpu", mesh=make_mesh(
        {"tp": 2}, [torch.device("cpu")] * 2))
    assert [leaves["k"].shape[3] for leaves in sharded.ranks()] \
        == [tcfg.n_kv_heads // 2] * 2
    assert sharded.page_bytes == PagePool(tcfg, num_pages=4,
                                          device="cpu").page_bytes


def test_reset_by_one_fails_the_others_request(model):
    _, _, tcfg, tparams = model
    pool = PagePool(tcfg, page=4, num_pages=120, device="cpu")
    a, b = (GenerationEngine(tcfg, tparams, device="cpu", page_pool=pool,
                             **PAGED) for _ in range(2))
    alone = asyncio.run(_serve(b, PROMPTS[1]))
    epoch = pool.epoch

    async def run():
        await a.start()
        await b.start()
        try:
            stream = await b.generate_stream(PROMPTS[1][1], 120)
            first = await stream.__anext__()
            await asyncio.get_running_loop().run_in_executor(
                a._device_exec, a._reset_device_state)
            with pytest.raises(RuntimeError, match="co-resident"):
                async for _ in stream:
                    pass
            return first, await asyncio.gather(
                *[b.generate(p, BUDGET) for p in PROMPTS[1]])
        finally:
            await a.stop()
            await b.stop()
    first, again = asyncio.run(run())
    assert first == alone[1][0]
    assert again == alone
    assert pool.epoch == epoch + 1 and pool.used_pages == 0
    assert b._pool_epoch == a._pool_epoch == pool.epoch


def test_pool_lock_subscribe_and_stale_release():
    cfg = pt_llama.config("tiny", dtype=torch.float32)
    pool = PagePool(cfg, page=4, num_pages=8, device="cpu")
    heard = []
    pool.subscribe(lambda: heard.append(pool.epoch))
    pool.subscribe(lambda: heard.append("other"))
    ids = pool.alloc(3)
    old = pool.epoch
    pool.reset()
    assert heard[0] == old + 1 and len(heard) == 2
    assert pool.free_pages == 8
    again = pool.alloc(2)
    pool.release(ids, epoch=old)          # the old epoch's ids: no-op
    assert pool.used_pages == 2
    pool.release(again, epoch=pool.epoch)
    assert pool.used_pages == 0
    with pool.lock:                       # re-entrant
        assert pool.alloc(1) is not None


def test_hbm_budget_matches_jax():
    ours, theirs = HBMBudget(1000), JaxHBMBudget(1000)
    for op, args in (("carve", ("a", 400)), ("carve", ("b", 500)),
                     ("carve", ("c", 200)), ("carve", ("a", 10)),
                     ("carve", ("d", 0)), ("release", ("a",)),
                     ("carve", ("c", 200)), ("release", ("zz",))):
        outcomes = []
        for budget in (ours, theirs):
            try:
                outcomes.append(("ok", getattr(budget, op)(*args)))
            except ValueError as exc:
                outcomes.append(("error", str(exc)))
        assert outcomes[0] == outcomes[1], (op, args)
        assert ours.stats() == theirs.stats()
    for bad in (0, -5):
        with pytest.raises(ValueError, match="positive byte budget"):
            HBMBudget(bad)


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_ragged_attn_modes_match_jax(model, jax_tokens, mode):
    _, _, tcfg, tparams = model
    metrics = register_engine_metrics(Manager())
    engine = GenerationEngine(tcfg, tparams, device="cpu", ragged_attn=mode,
                              metrics=metrics, **PAGED)
    got = asyncio.run(_serve(engine, PROMPTS[0]))
    assert got == jax_tokens(0, ragged_attn=mode, **PAGED)
    path = "gather" if mode == "off" else "ragged"
    assert engine.attn_path == path
    labels = {key for key in metrics.snapshot()[
        "app_tpu_attn_kernel_total"].series}
    assert labels == {(("model", "generate"), ("path", path))}
    xlaz = engine.xlaz()["paged_kv"]
    assert xlaz["ragged_attn"] == mode and xlaz["attn_path"] == path
    if mode != "auto":
        # JAX on the CPU serves "auto" through the gather (ROADMAP.md §3)
        jax_engine = _jax(*model[:2], ragged_attn=mode, **PAGED)
        assert xlaz["gather_widths"] \
            == jax_engine.xlaz()["paged_kv"]["gather_widths"]
        assert jax_engine.attn_path == path
    if mode == "off":
        assert xlaz["gather_widths"] == [32, 64]
        assert 128 in engine.stats()["ticks_by_window"]
        assert engine.stats()["kv_pool"]["attn_path"] == "gather"
    else:
        assert set(engine.window_ticks) == {None}


def test_ragged_attn_refusals_as_jax(model):
    jcfg, jparams, tcfg, tparams = model
    for kw in (dict(ragged_attn="on", **ENGINE_KW),
               dict(ragged_attn="fast", **PAGED)):
        with pytest.raises(ValueError) as want:
            _jax(jcfg, jparams, **kw)
        with pytest.raises(ValueError) as got:
            GenerationEngine(tcfg, tparams, device="cpu", **kw)
        assert str(got.value) == str(want.value)


def test_mesh_none_only(model):
    """``mesh=None`` serves one device; a ``parallel/mesh.Mesh`` serves
    dp × tp (its shape in ``stats()``, slots rounded up to dp); anything
    else is refused."""
    from gofr_tpu_torch.parallel import make_mesh

    _, _, tcfg, tparams = model
    GenerationEngine(tcfg, tparams, device="cpu", mesh=None, **ENGINE_KW)
    mesh = make_mesh({"dp": 2, "tp": 2}, [torch.device("cpu")] * 4)
    kw = dict(ENGINE_KW, max_slots=3)
    sharded = GenerationEngine(tcfg, tparams, device="cpu", mesh=mesh, **kw)
    assert sharded.stats()["mesh"] == {"dp": 2, "tp": 2}
    assert sharded.max_slots == 4
    with pytest.raises(ValueError, match="mesh"):
        GenerationEngine(tcfg, tparams, device="cpu", mesh=object(),
                         **ENGINE_KW)


@pytest.mark.parametrize("paged", [False, True])
def test_coalesce_uploads_same_tokens_one_transfer_a_group(model, jax_tokens,
                                                           paged):
    _, _, tcfg, tparams = model
    kw = PAGED if paged else ENGINE_KW
    want = jax_tokens(0, coalesce_uploads=True, **kw)
    assert want == jax_tokens(0, **kw)
    runs = {}
    for on in (False, True):
        engine = GenerationEngine(tcfg, tparams, device="cpu",
                                  coalesce_uploads=on, **kw)
        runs[on] = (asyncio.run(_serve(engine, PROMPTS[0])), engine)
    assert runs[True][0] == runs[False][0] == want
    engine = runs[True][1]
    stats = engine.data_plane()
    assert stats["coalesce_uploads"] is True
    assert stats["coalescer"]["transfers"] == engine.prefill_dispatches
    assert stats["coalescer"]["arrays_coalesced"] \
        == 2 * engine.prefill_dispatches
    assert stats["coalescer"]["arrays_per_transfer"] == 2.0
    assert runs[False][1].data_plane()["coalescer"]["transfers"] == 0
    rung = next(iter(engine._prefills.values()))
    assert rung.arena is not None and rung.ints.dtype == torch.int32


def test_coalesced_biased_paged_tick_is_one_transfer(model):
    """A paged constrained tick whose table moved ships the table and the
    bias as one transfer; the tokens equal the uncoalesced engine's."""
    _, _, tcfg, tparams = model
    rf = {"type": "regex", "pattern": "(ab|cd)+!"}

    async def run(engine):
        await engine.start()
        try:
            return await asyncio.gather(
                engine.generate([1, 2, 3], 12, response_format=rf),
                engine.generate([4, 5, 6, 7, 8, 9], 12))
        finally:
            await engine.stop()
    outs = {}
    for on in (False, True):
        engine = GenerationEngine(tcfg, tparams, device="cpu",
                                  coalesce_uploads=on, **PAGED)
        outs[on] = asyncio.run(run(engine))
    assert outs[True] == outs[False]
    assert engine.data_plane()["coalescer"]["transfers"] \
        > engine.prefill_dispatches


def test_coalesce_stream_same_sequence(model):
    _, _, tcfg, tparams = model

    async def stream(engine, chunked):
        await engine.start()
        try:
            s = await engine.generate_stream(PROMPTS[0][1], 13)
            if chunked:
                return [chunk async for chunk in s.chunks()]
            return [tok async for tok in s]
        finally:
            await engine.stop()
    plain = asyncio.run(stream(GenerationEngine(
        tcfg, tparams, device="cpu", **ENGINE_KW), False))
    coalesced = asyncio.run(stream(GenerationEngine(
        tcfg, tparams, device="cpu", coalesce_stream=True, **ENGINE_KW),
        False))
    chunks = asyncio.run(stream(GenerationEngine(
        tcfg, tparams, device="cpu", coalesce_stream=True, **ENGINE_KW),
        True))
    assert coalesced == plain and len(plain) == 13
    assert sum(chunks, []) == plain
    assert max(len(c) for c in chunks) > 1


def test_shared_pool_ownership_under_threads():
    """Eight threads (more than this host's cores) allocating, retaining
    and releasing pages of one pool with a short switch interval, as the
    loop threads of engines sharing it do: no page is lost or handed out
    twice (every page ends free, each exactly once)."""
    import sys
    import threading

    cfg = pt_llama.config("tiny", dtype=torch.float32)
    pool = PagePool(cfg, page=4, num_pages=64, device="cpu")
    errors = []

    def churn(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(300):
                ids = pool.alloc(int(rng.integers(1, 4)))
                if ids is None:
                    continue
                pool.retain(ids[:1])
                pool.release(ids[:1])
                pool.release(ids)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=churn, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sorted(pool._free) == list(range(64))
    assert pool.used_pages == 0 and not pool._refs.any()
