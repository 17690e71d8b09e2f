"""The engine's captured ticks on the card. Marked ``cuda``: each test
skips itself on a host without a CUDA device (a CUDA graph has no CPU
form). Run them on the GPU host with
``python -m pytest tests/test_torch_cuda_graphs.py -q --noconftest``.

- A plain and a spec tick replayed from their graphs give, bit for bit,
  the tokens and the state (cache_len, last token, keys, pool pages,
  draft cache) of the same tick run eagerly from a copy of the state,
  greedy and sampled, over bf16 and int8 pools. The pool's scratch page
  is left out: it takes every dropped write, and which of several lands
  last is not defined.
- The same for the dense engine's ticks at window rung 128, the cache
  whole.
- The kernel launch counters move by the same counts under a replay as
  under the eager run.
- After a prefix hit (the suffix prefilled over the store's pages; paged:
  the cached pages in the slot's table row, dense: copied into its cache
  row), the replayed tick gives the eager tick's bits.
- A biased tick (grammar-constrained decoding) replayed from its graph
  gives the eager tick's tokens and state bit for bit, dense and paged,
  greedy and sampled, with 1 and 2 ticks queued, while the bias slab
  each replay reads is rewritten between queued replays.
- ``GenerationEngine`` refuses at construction, on CUDA, each
  configuration the kernels would refuse at the first tick.
- With every telemetry hook on (metrics, tracer, SLO tracker, flight
  recorder, the anatomy of every tick), dense and paged: a replay inside
  the profiler's step annotation gives the eager tick's bits; a burst
  gives the unhooked engine's tokens, every tick and every prefill a
  replay, under ``set_sync_debug_mode("error")`` (no hook and no part of
  the dispatch syncs, the prefills included).
- A prefill replayed from its rung's graph gives, bit for bit, the first
  tokens and the state (cache or pool rows, the store's pages, the draft
  cache, cache_len, last token, sampling rows, keys) of the same group's
  prefill run eagerly from a copy of the state, for every kind of rung
  (full, suffix over the store's pages with the draft's own bucket,
  biased, full with a draft), dense and paged, bf16 and ``kv_int8`` (the
  draft int8 too): two slots claimed, the others and the padding rows
  untouched. The launch counters move by the same counts.
- A suffix rung met while serving is captured once, at its first group,
  and counted as one serving compile; the next group of that rung
  replays it.
- An MoE engine (``model_module=moe``): its prefill rungs keep JAX's
  rows, and a plain tick and a full prefill replayed from their graphs
  give the eager run's tokens and state bit for bit, every slot live.
- With ``coalesce_uploads``, a paged biased tick whose table and bias
  both moved uploads them as one transfer into one arena, and its replay
  gives the eager tick's bits.
- ``tick_exception`` raised with ``max_inflight_ticks - 1`` ticks and a
  prefill queued behind a sleep kernel fails the callers bound to
  slots; the reset clears the state in place (no buffer moves, no graph
  is captured again), a replay still gives the eager bits, and the next
  burst's tokens equal a fresh engine's.
- A tick graph captured by a prewarm job behind two replayed ticks still
  in flight (queued behind a sleep kernel): the in-flight ticks' tokens
  and the state are those of the same ticks with no capture between, the
  live mask is restored, and the new graph's replay gives the eager
  tick's bits, dense and paged.
- A burst served while ``prewarm_operating_point`` captures a move (one
  new bucket, one new k rung), with the telemetry store's default
  signals sampled every 20 ms and ``set_sync_debug_mode("error")`` on
  throughout: its greedy tokens are those of the same burst with no
  prewarm, ticks run between the prewarm's captures, nothing syncs (the
  sampler's ``stats()`` and ``hbm_occupancy`` included), and after the
  move is applied a burst captures nothing.
- An export rung (``prefill_export``) captured by ``warmup()`` replays to
  the eager run's first token, key and small-cache rows bit for bit,
  bf16 and ``kv_int8``, dense and paged, and writes no engine state.
- Payloads a dense engine exported, adopted by a paged engine while its
  own burst has ticks in flight, under ``set_sync_debug_mode("error")``,
  give a monolithic engine's greedy tokens, with no prefill for them.
- No cyclic collection starts inside a capture while a dropped paged
  engine is garbage (the collector made to run at almost every
  allocation), and the capturing engine serves.
- Two engines never warmed serve at once, each capturing lazily on its
  own device thread: the captures take turns and each engine's tokens
  are its tokens alone.
- A shadow scoring pass of the auto-tuner (a clone at a candidate
  point, the recorded trace replayed through its lazily captured graphs)
  while the live engine has ticks in flight, under
  ``set_sync_debug_mode("error")``: the live burst's tokens are the
  burst's alone and the score is a pass's alone; the reserved bytes
  after three scoring firings are no higher than after one.
- A graph capture that fails inside the tuner's prewarm (a device sync
  planted in the captured body) raises out of the firing: nothing is
  applied and the firing is not noted as a refusal.

The model is 2 layers of head_dim 128 or 64 (Hq 8, Hkv 2) at vocabulary
1024, random weights from a seed; the state is random too: pages
scattered over the pool, fills 0..200, every slot sampled with its own
key.
"""

import asyncio
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gofr_tpu_torch.hbmz import hbm_occupancy
from gofr_tpu_torch.metrics import Manager, register_engine_metrics
from gofr_tpu_torch.metrics.timeseries import (TimeSeriesStore,
                                               register_default_signals)
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.ops import prng
from gofr_tpu_torch.ops.cuda import launch_counts
from gofr_tpu_torch.slo import SLOTracker
from gofr_tpu_torch.tpu import faults
from gofr_tpu_torch.tpu.constrain import NEG_BIAS
from gofr_tpu_torch.tpu.flightrecorder import FlightRecorder
from gofr_tpu_torch.tpu.generate import (GenerationEngine, Sampling,
                                         _pack, _prefill_key)
from gofr_tpu_torch.trace import ListExporter, Tracer

pytestmark = pytest.mark.cuda

SLOTS, MAX_LEN, PAGE = 4, 256, 32
HEAD_DIMS = [64, 128]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfg(**over):
    return llama.config("tiny", **{
        **dict(vocab_size=1024, dim=1024, n_layers=2, n_heads=8,
               n_kv_heads=2, ffn_dim=512, max_seq_len=MAX_LEN,
               use_flash=True), **over})


def _engine(cuda, int8=False, spec=False, paged=True, d=128,
            int8_draft=False, **kw):
    cfg = _cfg(kv_int8=int8, dim=8 * d)
    params = llama.init(cfg, 0, device=cuda)
    if spec:
        dcfg = _cfg(dim=8 * d, kv_int8=int8_draft)
        kw.update(draft_cfg=dcfg, draft_params=llama.init(dcfg, 1,
                                                          device=cuda),
                  spec_gamma=4)
    return GenerationEngine(cfg, params, max_slots=SLOTS, max_len=MAX_LEN,
                            prompt_buckets=(32, 64), steps_per_tick=4,
                            paged_kv=paged, kv_page=PAGE, prefix_page=PAGE,
                            device=cuda, **kw)


def _fill_state(engine, seed, fills=(0, 37, 200, 90)):
    """Random live state: fills, tokens, sampling rows, keys, random KV
    (paged: pages through a scattered table); slot 3 inactive."""
    rng = np.random.default_rng(seed)
    fills = np.array(fills)
    gen = torch.Generator(device=engine.device).manual_seed(seed)
    if engine.paged:
        pool = engine._pool
        table = np.full(engine.table.shape, pool.sentinel, np.int32)
        order = rng.permutation(pool.num_pages)
        nxt = 0
        for slot, fill in enumerate(fills):
            for col in range(-(-(int(fill) + 5) // PAGE)):  # room for γ + 1
                table[slot, col] = order[nxt]
                nxt += 1
        engine.table.copy_(torch.from_numpy(table))
    leaves = engine._pool.leaves if engine.paged else engine.cache
    for name, leaf in leaves.items():
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen,
                                     device=leaf.device, dtype=torch.int8))
        else:
            leaf.copy_(torch.rand(leaf.shape, generator=gen,
                                  device=leaf.device) * 0.1)
    if engine.spec:
        for leaf in engine._draft_cache.values():
            leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                   device=leaf.device))
    engine.cache_len.copy_(torch.from_numpy(fills).int())
    engine.last_token.copy_(torch.from_numpy(rng.integers(0, 1024, SLOTS)))
    engine.temps.copy_(torch.tensor([0.0, 0.8, 1.2, 0.9]))
    engine.top_ks.copy_(torch.tensor([0, 50, 0, 10]))
    engine.top_ps.copy_(torch.tensor([1.0, 0.9, 1.0, 0.95]))
    engine.sample_keys.copy_(prng.split(prng.seed_key(torch.tensor(seed)),
                                        SLOTS))
    engine.active.copy_(torch.tensor([True, True, True, False]))


def _state(engine):
    tensors = {"cache_len": engine.cache_len, "last_token": engine.last_token,
               "keys": engine.sample_keys}
    if engine.paged:
        tensors.update({f"pool.{k}": v
                        for k, v in engine._pool.leaves.items()})
    else:
        tensors.update({f"cache.{k}": v for k, v in engine.cache.items()})
    if engine.spec:
        tensors.update({f"draft.{k}": v
                        for k, v in engine._draft_cache.items()})
    return tensors


def _restore(engine, saved):
    for name, tensor in _state(engine).items():
        tensor.copy_(saved[name])


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kind", ["plain", "spec"])
def test_replayed_tick_is_bitwise_the_eager_tick(cuda, kind, sampled, int8,
                                                 d):
    engine = _engine(cuda, int8=int8, spec=kind == "spec", d=d)
    key = (kind, 4, sampled, None)
    asyncio.run(engine.warmup(ks=(4,)))
    assert key in engine._graphs
    _fill_state(engine, 3)
    saved = {k: v.clone() for k, v in _state(engine).items()}
    launch_counts.write({k: 0 for k in launch_counts.read()})
    eager = engine._tick_body(key, engine.active).clone()
    torch.cuda.synchronize()
    eager_counts = launch_counts.read()
    after_eager = {k: v.clone() for k, v in _state(engine).items()}
    _restore(engine, saved)
    launch_counts.write({k: 0 for k in launch_counts.read()})
    replayed = engine._run_tick(key, None, None)()
    assert launch_counts.read() == eager_counts
    assert any(eager_counts.values())
    np.testing.assert_array_equal(replayed, eager.cpu().numpy())
    for name, tensor in _state(engine).items():
        if name.startswith("pool."):
            # the scratch page takes every dropped write, several to one
            # row in a verify: which lands last is not defined
            tensor, want = tensor[:, :-1], after_eager[name][:, :-1]
        else:
            want = after_eager[name]
        assert torch.equal(_bits(tensor), _bits(want)), name
    # the tick moved the live slots and kept the inactive one
    assert not torch.equal(after_eager["cache_len"][:3],
                           saved["cache_len"][:3])
    assert after_eager["cache_len"][3] == saved["cache_len"][3]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kind", ["plain", "spec"])
def test_dense_tick_replay_is_bitwise_the_eager_tick(cuda, kind, sampled,
                                                     int8, d):
    """The dense engine's tick at window 128 (the ragged kernels over the
    128-position identity table; the draft's flash decode over the
    window's view), fills below the window and the inactive slot's past
    it: replay and eager run give the same tokens and state, the whole
    cache included (no scratch rows: the inactive slot writes at its
    frozen position)."""
    engine = _engine(cuda, int8=int8, spec=kind == "spec", paged=False, d=d)
    key = (kind, 4, sampled, 128)
    asyncio.run(engine.warmup(ks=(4,), windows=(128,)))
    assert key in engine._graphs
    _fill_state(engine, 5, fills=(0, 37, 100, 200))
    saved = {k: v.clone() for k, v in _state(engine).items()}
    launch_counts.write({k: 0 for k in launch_counts.read()})
    eager = engine._tick_body(key, engine.active).clone()
    torch.cuda.synchronize()
    eager_counts = launch_counts.read()
    after_eager = {k: v.clone() for k, v in _state(engine).items()}
    _restore(engine, saved)
    launch_counts.write({k: 0 for k in launch_counts.read()})
    replayed = engine._run_tick(key, None, None)()
    assert launch_counts.read() == eager_counts
    assert any(eager_counts.values())
    np.testing.assert_array_equal(replayed, eager.cpu().numpy())
    for name, tensor in _state(engine).items():
        assert torch.equal(_bits(tensor), _bits(after_eager[name])), name
    assert not torch.equal(after_eager["cache_len"][:3],
                           saved["cache_len"][:3])
    assert after_eager["cache_len"][3] == saved["cache_len"][3]


async def _admit(engine, prompts):
    """Admit ``prompts`` in one pass of the engine's admission (without
    its loop) and wait for their prefills; the slots stay active."""
    loop = asyncio.get_running_loop()
    futures = [engine._submit(p, 8, None, None, None) for p in prompts]
    engine._admit_pending(loop)
    for entry in list(engine._publishq):
        await entry.task
    engine._publishq.clear()
    for future in futures:
        future.cancel()


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("paged", [False, True])
def test_prefix_hit_tick_replay_is_bitwise_the_eager_tick(cuda, paged, d):
    """A full prefill publishes (dense) or registers (paged) its first
    page; a second prompt with the same head hits it at rung 1 and
    prefills its suffix alone. The next tick, replayed from its graph,
    gives the eager tick's tokens and state: the paged graph reads the
    cached page through the device table at its fixed address, uploaded
    from the host master table; the dense one the rows the suffix insert
    copied."""
    engine = _engine(cuda, paged=paged, d=d, prefix_cache=True)
    window = None if paged else 128
    key = ("plain", 4, False, window)
    asyncio.run(engine.warmup(ks=(4,),
                              windows=None if paged else (window,)))
    head = np.random.default_rng(d).integers(0, 1024, PAGE).tolist()
    asyncio.run(_admit(engine, [head + [5, 6, 7]]))
    asyncio.run(_admit(engine, [head + [9, 10]]))
    store = engine.stats()["prefix_cache"]
    assert store["lookups"]["hit"] == 1 and store["tokens_saved"] == PAGE
    slot = next(s for s in engine._slots if s.active and s.fill == PAGE + 2)
    if paged:
        assert len(slot.nodes) == 1
    mask = np.array([s.active for s in engine._slots])
    assert mask.sum() == 2
    engine._staging.upload(engine.active, mask)
    if paged:
        engine._staging.upload(engine.table, engine._table.copy())
    saved = {k: v.clone() for k, v in _state(engine).items()}
    eager = engine._tick_body(key, engine.active).clone()
    torch.cuda.synchronize()
    after_eager = {k: v.clone() for k, v in _state(engine).items()}
    _restore(engine, saved)
    replayed = engine._run_tick(key, None, None)()
    np.testing.assert_array_equal(replayed, eager.cpu().numpy())
    for name, tensor in _state(engine).items():
        if name.startswith("pool."):
            tensor, want = tensor[:, :-1], after_eager[name][:, :-1]
        else:
            want = after_eager[name]
        assert torch.equal(_bits(tensor), _bits(want)), name


def _bias_slabs(engine, seed, n):
    """``n`` (max_slots, vocab) grammar-bias slabs: slots 0 and 1 each
    allowed a few random tokens (``NEG_BIAS`` elsewhere), a new set in
    each slab; slot 2 unconstrained (0); slot 3 inactive."""
    rng = np.random.default_rng(seed)
    slabs, allowed = [], []
    for _ in range(n):
        slab = np.full((SLOTS, engine.cfg.vocab_size), NEG_BIAS, np.float32)
        slab[2:] = 0.0
        sets = [rng.choice(engine.cfg.vocab_size, 3, replace=False)
                for _ in range(2)]
        for slot, toks in enumerate(sets):
            slab[slot, toks] = 0.0
        slabs.append(slab)
        allowed.append(sets)
    return slabs, allowed


@pytest.mark.parametrize("inflight", [1, 2])
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_biased_tick_replay_is_bitwise_the_eager_tick(cuda, paged, sampled,
                                                      inflight):
    """Four biased ticks, each with its own bias slab, replayed from the
    graph of the ``("bias", 1, sampled, window)`` family (dense: window
    128) with ``inflight`` of them queued before the oldest one's tokens
    are read, behind a sleep kernel so every upload and replay queues up
    and the staging ring's slabs are rewritten while earlier replays
    still wait: tokens and state equal the same four ticks run eagerly,
    one after another, bit for bit, and each constrained slot's token is
    one its slab allowed."""
    engine = _engine(cuda, paged=paged, d=64, max_inflight_ticks=inflight)
    key = ("bias", 1, sampled, None if paged else 128)
    _fill_state(engine, 7, fills=(0, 37, 100, 90))
    engine._capture(key)
    assert key in engine._graphs
    slabs, allowed = _bias_slabs(engine, 11, 4)
    saved = {k: v.clone() for k, v in _state(engine).items()}
    eager = []
    for slab in slabs:
        engine.bias.copy_(torch.from_numpy(slab))
        eager.append(engine._tick_body(key, engine.active).cpu().numpy())
    after_eager = {k: v.clone() for k, v in _state(engine).items()}
    _restore(engine, saved)
    torch.cuda.synchronize()
    replays = engine.graph_replays
    torch.cuda._sleep(50_000_000)        # ~25 ms: everything below queues
    fetches, replayed = [], []
    for slab in slabs:
        fetches.append(engine._run_tick(key, None, None, slab))
        if len(fetches) == inflight:
            replayed.append(fetches.pop(0)())
    replayed += [fetch() for fetch in fetches]
    assert engine.graph_replays == replays + len(slabs)
    for got, want, sets in zip(replayed, eager, allowed):
        np.testing.assert_array_equal(got, want)
        for slot, toks in enumerate(sets):
            assert got[0, slot] in toks
    for name, tensor in _state(engine).items():
        if name.startswith("pool."):
            tensor, want = tensor[:, :-1], after_eager[name][:, :-1]
        else:
            want = after_eager[name]
        assert torch.equal(_bits(tensor), _bits(want)), name


# what each configuration changes, and its spec_gamma
REFUSED = {
    "spec_gamma": (dict(), 8),
    "head_dim": (dict(dim=768), 4),                      # head_dim 96
    "group": (dict(dim=1536, n_heads=12, n_kv_heads=1), 4),
    "dtype": (dict(dtype=torch.float32), 4),
    "table": (dict(max_seq_len=16384, n_kv_heads=1), 4),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_engine_refuses_what_the_kernels_refuse(cuda, case):
    over, gamma = REFUSED[case]
    cfg = _cfg(**over)
    with pytest.raises(ValueError, match="refuse"):
        GenerationEngine(cfg, {}, max_slots=SLOTS, max_len=cfg.max_seq_len,
                         prompt_buckets=(32,), kv_page=PAGE, draft_cfg=cfg,
                         draft_params={}, spec_gamma=gamma, device=cuda)


class _Strict:
    """A logger whose ``error`` raises: a metric the catalog lacks, or a
    failed tick, cannot pass unseen."""

    def error(self, message, *args):
        raise AssertionError(message % args if args else message)

    def warning(self, *args):
        pass

    info = warning


class _Ticks:
    def __init__(self):
        self.ticks = []

    def note_tick(self, entry):
        self.ticks.append(entry)


def _hooked(cuda, paged, **kw):
    metrics = register_engine_metrics(Manager(logger=_Strict()))
    exporter = ListExporter()
    tracer = Tracer(exporter=exporter)
    engine = _engine(cuda, paged=paged, d=64, metrics=metrics,
                     tracer=tracer, slo=SLOTracker(metrics),
                     recorder=FlightRecorder(), **kw)
    store = _Ticks()
    engine.attach_telemetry(store, every=1)
    return engine, tracer, exporter, store


def _prompts(seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1024, int(length)).tolist()
            for length in rng.integers(5, 60, n)]


async def _serve(engine, prompts, budget=24):
    await engine.start()
    try:
        return await asyncio.wait_for(asyncio.gather(
            *[engine.generate(p, budget) for p in prompts]), 300)
    finally:
        await engine.stop()


@pytest.mark.parametrize("paged", [False, True])
def test_hooked_replay_in_the_step_annotation_is_the_eager_tick(cuda,
                                                                paged):
    engine, tracer, _, _ = _hooked(cuda, paged)
    key = ("plain", 4, True, None)
    asyncio.run(engine.warmup(ks=(4,), windows="all"))
    assert key in engine._graphs
    _fill_state(engine, 5)
    saved = {k: v.clone() for k, v in _state(engine).items()}
    eager = engine._tick_body(key, engine.active).cpu().numpy()
    after_eager = {k: v.clone() for k, v in _state(engine).items()}
    _restore(engine, saved)
    with torch.profiler.profile() as prof:
        replayed = engine._annotated("tpu.engine.step", 7, engine._run_tick,
                                     key, None, None)()
    np.testing.assert_array_equal(replayed, eager)
    assert any(evt.name == "tpu.engine.step" for evt in prof.events())
    for name, tensor in _state(engine).items():
        if name.startswith("pool."):
            tensor, want = tensor[:, :-1], after_eager[name][:, :-1]
        else:
            want = after_eager[name]
        assert torch.equal(_bits(tensor), _bits(want)), name
    tracer.shutdown()


@pytest.mark.parametrize("paged", [False, True])
def test_hooked_burst_is_the_unhooked_burst_and_syncs_nowhere(cuda, paged):
    prompts = _prompts(1)
    bare = _engine(cuda, paged=paged, d=64)
    asyncio.run(bare.warmup(windows="all"))
    want = asyncio.run(_serve(bare, prompts))
    engine, tracer, exporter, store = _hooked(cuda, paged)
    asyncio.run(engine.warmup(windows="all"))
    replays = engine.graph_replays
    prefills = engine.stats()["graphs"]["prefill"]["replays"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = asyncio.run(_serve(engine, prompts))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tracer.shutdown()
    assert got == want
    ticks = engine.ticks + engine.spec_dispatches
    assert engine.graph_replays - replays == ticks and not \
        engine.lazy_captures
    graphs = engine.stats()["graphs"]["prefill"]
    assert graphs["replays"] - prefills == engine.prefill_dispatches
    assert not graphs["lazy_captures"]
    assert engine.serving_compiles() == 0
    assert len(store.ticks) == ticks
    names = [span.name for span in exporter.spans]
    for name in ("queue.wait", "prefill", "decode"):
        assert names.count(name) == len(prompts)
    assert engine.hbm_attribution()["device_bytes_in_use"] \
        >= engine.hbm_attribution()["attributed_bytes"]


@pytest.mark.parametrize("paged", [False, True])
def test_tick_exception_with_ticks_in_flight_resets_in_place(cuda, paged):
    inflight = 4
    prompts = _prompts(2)
    fresh = _engine(cuda, paged=paged, d=64, max_inflight_ticks=inflight)
    asyncio.run(fresh.warmup(windows="all"))
    want = asyncio.run(_serve(fresh, prompts))
    del fresh
    engine, tracer, _, _ = _hooked(cuda, paged, max_inflight_ticks=inflight)
    asyncio.run(engine.warmup(windows="all"))
    graphs = engine.stats()["graphs"]["captured"]
    ptrs = {name: t.data_ptr() for name, t in _state(engine).items()}
    run_tick, slept = engine._run_tick, []

    def behind_a_sleep(*args):
        if not slept:
            slept.append(1)
            torch.cuda._sleep(100_000_000)      # ~50 ms: the rest queues
        return run_tick(*args)

    engine._run_tick = behind_a_sleep

    async def faulted():
        await engine.start()
        try:
            faults.install(faults.FaultPlan(f"tick_exception:@{inflight}"))
            try:
                failed = await asyncio.wait_for(asyncio.gather(
                    *[engine.generate(p, 24) for p in prompts],
                    return_exceptions=True), 300)
            finally:
                faults.reset()
            peak = engine.stats()["ticks_inflight_peak"]
            engine._run_tick = run_tick
            later = await asyncio.wait_for(asyncio.gather(
                *[engine.generate(p, 24) for p in prompts]), 300)
            return failed, peak, later
        finally:
            await engine.stop()

    failed, peak, later = asyncio.run(faulted())
    tracer.shutdown()
    assert all(isinstance(out, faults.FaultError) for out in failed)
    assert peak == inflight - 1
    assert later == want
    assert engine.stats()["graphs"]["captured"] == graphs
    assert {n: t.data_ptr() for n, t in _state(engine).items()} == ptrs
    # a replay after the reset is still the eager tick
    key = ("plain", 4, True, None)
    _fill_state(engine, 9)
    saved = {k: v.clone() for k, v in _state(engine).items()}
    eager = engine._tick_body(key, engine.active).cpu().numpy()
    _restore(engine, saved)
    np.testing.assert_array_equal(engine._run_tick(key, None, None)(), eager)



# what each prefill kind's engine has: (spec, prefix store)
PREFILL_KINDS = {"full": (False, True), "suffix": (True, True),
                 "biased": (False, False), "draft": (True, False)}


def _prefill_state(engine):
    tensors = dict(_state(engine), temps=engine.temps, top_ks=engine.top_ks,
                   top_ps=engine.top_ps)
    if engine._prefix is not None and not engine.paged:
        tensors.update({f"store.{k}": v
                        for k, v in engine._prefix._pool.leaves.items()})
    return tensors


def _without_scratch(name, tensor):
    """A pool's or store's leaves without the scratch page, which takes
    every dropped write (which lands last is not defined)."""
    if name.startswith(("pool.", "store.")):
        return tensor[:, :-1]
    return tensor


def _prefill_group(engine, kind, rng, head=(), pages=()):
    """One group of ``kind`` for slots 0 and 2 (rows 0 and 1, the rest
    padding): random prompts, sampling rows (one greedy, one sampled),
    seeds; paged, fresh pages; suffix, at bucket 32 after the store's
    cached ``pages`` of ``head``, the whole prompts for the draft at
    bucket 64; biased, a bias row that allows 3 tokens; dense with the
    store, the first row's first page published. Returns the
    ``_prefill_insert`` arguments."""
    p_rung = len(pages)
    bucket, db = (32, 64) if p_rung else (64, 0)
    nb = engine._prefill_count(2, bucket)
    arrays = engine._group_arrays(nb, bucket, p_rung, db)
    floats = engine._group_floats(nb, kind == "biased")
    vocab = engine.cfg.vocab_size
    for row, slot in enumerate((0, 2)):
        length = int(rng.integers(10, bucket))
        suffix = rng.integers(0, vocab, length).tolist()
        arrays["tokens"][row, :length] = suffix
        arrays["lengths"][row] = length
        arrays["row_of_slot"][slot] = row
        arrays["top_ks"][row] = (0, 20)[row]
        arrays["seeds"][row] = 17 + row
        floats[row], floats[nb + row] = ((0.0, 1.0), (0.9, 0.95))[row]
        if engine.paged:
            npg = bucket // PAGE
            arrays["page_ids"][row * npg:(row + 1) * npg] = \
                engine._pool.alloc(npg)
        if p_rung:
            arrays["prefix_ids"][row] = pages
            prompt = list(head) + suffix
            arrays["draft_tokens"][row, :len(prompt)] = prompt
            arrays["draft_lengths"][row] = len(prompt)
        if kind == "biased":
            bias = np.full(vocab, NEG_BIAS, np.float32)
            bias[rng.choice(vocab, 3, replace=False)] = 0.0
            floats[2 * nb + row * vocab:2 * nb + (row + 1) * vocab] = bias
    if "publish_ids" in arrays:
        arrays["publish_ids"][0] = 3
    ints, layout = _pack(arrays)
    return (nb, bucket, 2, p_rung, ints, layout, floats, kind == "biased")


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kind", sorted(PREFILL_KINDS))
def test_prefill_replay_is_bitwise_the_eager_prefill(cuda, kind, paged,
                                                     int8):
    spec, prefix = PREFILL_KINDS[kind]
    engine = _engine(cuda, int8=int8, spec=spec, paged=paged, d=64,
                     int8_draft=int8, prefix_cache=prefix)
    asyncio.run(engine.warmup(ks=(4,)))
    rng = np.random.default_rng(23)
    head, pages = [], []
    if kind == "suffix":
        # a full prefill publishes (dense) or registers (paged) its head's
        # page; the group then reads it
        head = rng.integers(0, 1024, PAGE).tolist()
        asyncio.run(_admit(engine, [head + [5, 6, 7]]))
        pages = [node.page_id for node in engine._prefix.lookup(head + [9])]
        assert len(pages) == 1
    _fill_state(engine, 13)
    args = _prefill_group(engine, kind, rng, head, pages)
    nb, bucket, _, p_rung, ints, layout, floats, biased = args
    rung = engine._prefill_rung(
        _prefill_key(nb, bucket, p_rung, biased, layout), layout,
        floats.size)
    assert (rung.graph is None) == (kind in ("suffix", "biased"))
    torch.cuda.synchronize()
    saved = {k: v.clone() for k, v in _prefill_state(engine).items()}
    launch_counts.write({k: 0 for k in launch_counts.read()})
    engine._staging.upload(rung.ints, ints)
    engine._staging.upload(rung.floats, floats)
    eager = engine._prefill_body(rung).cpu().numpy()
    eager_counts = launch_counts.read()
    after_eager = {k: v.clone() for k, v in _prefill_state(engine).items()}
    if rung.graph is None:
        engine._capture_prefill(rung)
    for name, tensor in _prefill_state(engine).items():
        tensor.copy_(saved[name])
    launch_counts.write({k: 0 for k in launch_counts.read()})
    replays = rung.replays
    replayed = engine._prefill_insert(*args)()
    assert rung.replays == replays + 1
    assert launch_counts.read() == eager_counts
    assert eager_counts["flash_attention.launches"] > 0
    np.testing.assert_array_equal(replayed, eager)
    for name, tensor in _prefill_state(engine).items():
        assert torch.equal(_bits(_without_scratch(name, tensor)),
                           _bits(_without_scratch(name, after_eager[name]))), \
            name
    # the claimed slots moved; slots 1 and 3 kept their state
    for name in ("cache_len", "last_token", "keys", "temps"):
        assert torch.equal(after_eager[name][[1, 3]], saved[name][[1, 3]])
    assert not torch.equal(after_eager["cache_len"][[0, 2]],
                           saved["cache_len"][[0, 2]])
    if biased:
        assert floats[2 * nb + replayed[0]] == 0.0


def test_lazy_suffix_capture_is_one_serving_compile(cuda):
    engine = _engine(cuda, paged=False, d=64, prefix_cache=True)
    asyncio.run(engine.warmup(windows="all"))
    assert engine.serving_compiles() == 0
    head = np.random.default_rng(29).integers(0, 1024, PAGE).tolist()

    async def serve():
        await engine.start()
        try:
            await engine.generate(head + [1, 2, 3], 4)
            graphs = dict(engine.stats()["graphs"]["prefill"])
            await engine.generate(head + [4, 5], 4)
            first = engine.serving_compiles()
            await engine.generate(head + [6, 7, 8, 9], 4)
            return graphs, first
        finally:
            await engine.stop()

    before, first = asyncio.run(serve())
    after = engine.stats()["graphs"]["prefill"]
    assert before["lazy_captures"] == 0
    assert first == engine.serving_compiles() == 1
    assert after["lazy_captures"] == 1
    assert after["by_kind"]["suffix_prefill"] == 1
    assert after["replays"] - before["replays"] == 2
    assert engine.stats()["prefix_cache"]["suffix_prefills"] == 2
    assert engine.lazy_captures == 0


def _moe_engine(cuda, **kw):
    from gofr_tpu_torch.models import moe

    cfg = moe.config(base=_cfg(dim=512), n_experts=4)     # head_dim 64
    params = moe.init(cfg, 0, device=cuda)
    return GenerationEngine(cfg, params, max_slots=SLOTS, max_len=MAX_LEN,
                            prompt_buckets=(32, 64), steps_per_tick=4,
                            model_module=moe, device=cuda, **kw)


def test_moe_tick_and_prefill_replays_are_bitwise_eager(cuda):
    """An MoE engine (every slot routes through the experts, capacity
    over all rows): its prefill rungs keep JAX's rows (no padding to
    ``CUDA_MIN_PREFILL_ROWS``); a plain tick and a full prefill replayed
    from their graphs give the eager run's tokens and state bit for
    bit, every slot live."""
    engine = _moe_engine(cuda)
    asyncio.run(engine.warmup(ks=(4,), prompt_counts=(1, SLOTS)))
    keys = sorted(tuple(k) for k in
                  engine.stats()["graphs"]["prefill"]["keys"])
    assert keys == sorted((n, b, 0, False, 0) for b in (32, 64)
                          for n in (1, SLOTS))
    key = ("plain", 4, False, 128)
    _fill_state(engine, 5)
    engine.active.fill_(True)
    saved = {k: v.clone() for k, v in _state(engine).items()}
    eager = engine._tick_body(key, engine.active).cpu().numpy()
    after_eager = {k: v.clone() for k, v in _state(engine).items()}
    _restore(engine, saved)
    np.testing.assert_array_equal(engine._run_tick(key, None, None)(),
                                  eager)
    for name, tensor in _state(engine).items():
        assert torch.equal(_bits(tensor), _bits(after_eager[name])), name
    rng = np.random.default_rng(9)
    arrays = engine._group_arrays(SLOTS, 64, 0)
    for row, n in enumerate((64, 40, 9, 1)):
        arrays["tokens"][row, :n] = rng.integers(0, 1024, n)
        arrays["lengths"][row] = n
        arrays["row_of_slot"][row] = row
        arrays["seeds"][row] = row
    floats = engine._group_floats(SLOTS, False)
    ints, layout = _pack(arrays)
    rung = engine._prefills[(SLOTS, 64, 0, False, 0)]
    saved = {k: v.clone() for k, v in _state(engine).items()}
    engine._upload_prefill(rung, ints, floats)
    eager = engine._prefill_body(rung).cpu().numpy()
    after_eager = {k: v.clone() for k, v in _state(engine).items()}
    _restore(engine, saved)
    replayed = engine._prefill_insert(SLOTS, 64, SLOTS, 0, ints, layout,
                                      floats)()
    np.testing.assert_array_equal(replayed, eager)
    for name, tensor in _state(engine).items():
        assert torch.equal(_bits(tensor), _bits(after_eager[name])), name


@pytest.mark.parametrize("sampled", [False, True])
def test_coalesced_tick_replay_is_bitwise_the_eager_tick(cuda, sampled):
    """With ``coalesce_uploads`` a paged biased tick whose table and bias
    both moved uploads them as one transfer into views of one arena;
    its replay gives the tokens and state of the same tick run eagerly
    over the same table and bias, uploaded one by one, bit for bit."""
    engine = _engine(cuda, d=64, coalesce_uploads=True)
    assert engine._tick_arena is not None
    key = ("bias", 1, sampled, None)
    _fill_state(engine, 7, fills=(0, 37, 100, 90))
    engine._capture(key)
    table = engine.table.cpu().numpy()
    slab = _bias_slabs(engine, 11, 1)[0][0]
    saved = {k: v.clone() for k, v in _state(engine).items()}
    engine.bias.copy_(torch.from_numpy(slab))
    eager = engine._tick_body(key, engine.active).cpu().numpy()
    after_eager = {k: v.clone() for k, v in _state(engine).items()}
    _restore(engine, saved)
    engine.bias.zero_()
    engine.table.fill_(engine._pool.sentinel)
    transfers = engine._coalescer.stats()["transfers"]
    replayed = engine._run_tick(key, None, table, slab)()
    assert engine._coalescer.stats()["transfers"] == transfers + 1
    np.testing.assert_array_equal(replayed, eager)
    for name, tensor in _state(engine).items():
        if name.startswith("pool."):
            tensor, want = tensor[:, :-1], after_eager[name][:, :-1]
        else:
            want = after_eager[name]
        assert torch.equal(_bits(tensor), _bits(want)), name


@pytest.mark.parametrize("paged", [False, True])
def test_prewarm_capture_with_ticks_in_flight_is_the_eager_tick(cuda,
                                                                paged):
    engine = _engine(cuda, paged=paged, d=64)
    asyncio.run(engine.warmup(ks=(4,), windows="all"))
    old, new = ("plain", 4, True, None), ("plain", 8, True, None)
    assert old in engine._graphs and new not in engine._graphs
    # fills leave room for 16 more positions inside each slot's pages
    _fill_state(engine, 13, fills=(0, 37, 140, 60))
    saved = {k: v.clone() for k, v in _state(engine).items()}
    mask = engine.active.clone()
    want = [engine._run_tick(old, None, None)() for _ in range(2)]
    want_new = engine._tick_body(new, engine.active).cpu().numpy()
    after = {k: v.clone() for k, v in _state(engine).items()}
    _restore(engine, saved)
    torch.cuda._sleep(100_000_000)              # ~50 ms: the ticks queue
    fetches = [engine._run_tick(old, None, None) for _ in range(2)]
    assert engine._warm_tick(new, live=True) is True
    for fetch, tokens in zip(fetches, want):
        np.testing.assert_array_equal(fetch(), tokens)
    assert torch.equal(engine.active, mask)
    np.testing.assert_array_equal(engine._run_tick(new, None, None)(),
                                  want_new)
    for name, tensor in _state(engine).items():
        if name.startswith("pool."):
            tensor, want_t = tensor[:, :-1], after[name][:, :-1]
        else:
            want_t = after[name]
        assert torch.equal(_bits(tensor), _bits(want_t)), name


@pytest.mark.parametrize("paged", [False, True])
def test_burst_during_a_prewarm_is_the_burst_without(cuda, paged):
    prompts, budget = _prompts(3, n=8), 128
    bare = _engine(cuda, paged=paged, d=64)
    asyncio.run(bare.warmup(windows="all"))
    want = asyncio.run(_serve(bare, prompts, budget))
    del bare
    engine = _engine(cuda, paged=paged, d=64)
    asyncio.run(engine.warmup(windows="all"))
    move = SimpleNamespace(prompt_buckets=(32, 64, 128), steps_per_tick=8)
    store = TimeSeriesStore(interval_s=0.02)
    register_default_signals(store, tpu=engine,
                             container=SimpleNamespace(tpu=engine))
    events = []
    for name in ("_run_tick", "_warm_tick", "_warm_prefill"):
        def timed(*args, _fn=getattr(engine, name), _name=name):
            events.append((_name, time.monotonic()))
            return _fn(*args)
        setattr(engine, name, timed)
    graphs = engine.stats()["graphs"]
    before = (graphs["captured"], graphs["prefill"]["captured"])

    async def run():
        await engine.start()
        store.start()
        try:
            tasks = [asyncio.ensure_future(engine.generate(p, budget))
                     for p in prompts]
            while not engine.active_slots:
                await asyncio.sleep(0.001)
            warm = await engine.prewarm_operating_point(move)
            got = await asyncio.wait_for(asyncio.gather(*tasks), 300)
            # the sampler's reads, on the loop thread, under the check
            assert engine.stats()["queue_depth"] == 0
            assert 0.0 < hbm_occupancy(SimpleNamespace(tpu=engine)) < 1.0
            lazy = (engine.lazy_captures, engine.prefill_lazy_captures)
            engine.apply_operating_point(move)
            later = await asyncio.wait_for(asyncio.gather(
                *[engine.generate(p, budget) for p in prompts]), 300)
            return got, warm, lazy, later
        finally:
            await store.stop()
            await engine.stop()

    torch.cuda.set_sync_debug_mode("error")
    try:
        got, warm, lazy, later = asyncio.run(run())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got == want
    graphs = engine.stats()["graphs"]
    new_ticks = 2 * (1 if paged else len(engine._window_ladder))
    assert graphs["captured"] - before[0] == new_ticks
    assert graphs["prefill"]["captured"] - before[1] == 2     # bucket 128
    assert warm["compiled"] == new_ticks + 2
    jobs = [t for name, t in events if name != "_run_tick"]
    assert any(jobs[0] < t < jobs[-1] for name, t in events
               if name == "_run_tick")
    assert (engine.lazy_captures, engine.prefill_lazy_captures) == lazy
    assert engine.serving_compiles(3600.0) == 0
    assert all(len(tokens) == budget for tokens in later)
    series = store.series("1s")["series"]
    for name in ("queue_depth", "batch_fill", "hbm_occupancy"):
        assert any(v is not None for v in series[name]), name


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_export_replay_is_bitwise_the_eager_export(cuda, paged, int8):
    """An export rung captured by ``warmup()`` replays to the eager run's
    first token, key and small-cache rows bit for bit, with the same
    launch counts, and writes no state of the engine's."""
    engine = _engine(cuda, int8=int8, paged=paged, d=64)
    asyncio.run(engine.warmup(ks=(4,)))
    assert engine.stats()["graphs"]["export"]["captured"] == 2
    rng = np.random.default_rng(31)
    prompt = rng.integers(0, 1024, 41).tolist()
    sampling = Sampling(temperature=0.9, top_k=20, seed=77)
    rung = engine._exports[64]
    nb = rung.key[0]
    ints, _ = _pack(engine._export_arrays(nb, 64, prompt, sampling))
    floats = engine._group_floats(nb, False)
    floats[0], floats[nb] = 0.9, 1.0
    _fill_state(engine, 19)
    torch.cuda.synchronize()
    saved = {k: v.clone() for k, v in _prefill_state(engine).items()}
    launch_counts.write({k: 0 for k in launch_counts.read()})
    engine._staging.upload(rung.ints, ints)
    engine._staging.upload(rung.floats, floats)
    eager = [_bits(out).cpu().numpy() for out in engine._export_body(rung)]
    eager_counts = launch_counts.read()
    launch_counts.write({k: 0 for k in launch_counts.read()})
    replays = rung.replays
    replayed = engine._export_run(64, ints, floats)()
    assert rung.replays == replays + 1
    assert launch_counts.read() == eager_counts
    assert eager_counts["flash_attention.launches"] > 0
    assert len(replayed) == len(eager) == (6 if int8 else 4)
    for got, want in zip(replayed, eager):
        np.testing.assert_array_equal(got, want)
    for name, tensor in _prefill_state(engine).items():
        assert torch.equal(_bits(tensor), _bits(saved[name])), name
    assert engine.export_lazy_captures == 0


def test_adopt_with_ticks_in_flight_syncs_nowhere(cuda):
    """Payloads a dense engine exported are adopted by a paged engine
    while its own burst has ticks in flight, under
    ``set_sync_debug_mode("error")``: the adopted streams give a
    monolithic engine's greedy tokens for those prompts, the local ones
    theirs, and the adoptions ran no prefill."""
    prompts = _prompts(3)
    mono = _engine(cuda, paged=True, d=64)
    asyncio.run(mono.warmup(prompt_counts=(1, SLOTS)))
    want = asyncio.run(_serve(mono, prompts))
    del mono
    src = _engine(cuda, paged=False, d=64)
    asyncio.run(src.warmup(prompt_counts=(1,)))

    async def export():
        return [await src.prefill_export(p) for p in prompts[:2]]
    payloads = asyncio.run(export())
    assert src.export_lazy_captures == 0
    engine = _engine(cuda, paged=True, d=64)
    asyncio.run(engine.warmup(prompt_counts=(1, SLOTS)))

    async def serve():
        await engine.start()
        try:
            local = [asyncio.ensure_future(engine.generate(p, 24))
                     for p in prompts[2:]]
            while engine._ticks_inflight < 2 \
                    and not all(f.done() for f in local):
                await asyncio.sleep(0)
            inflight.append(engine._ticks_inflight)
            streams = [await engine.adopt_kv(p, 24) for p in payloads]
            adopted = [[t async for t in s] for s in streams]
            return adopted + list(await asyncio.gather(*local))
        finally:
            await engine.stop()
    prefills = engine.prefill_dispatches
    inflight = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = asyncio.run(asyncio.wait_for(serve(), 300))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got == want
    assert inflight == [2]
    # the two local prompts take one or two prefill groups, the adopted
    # ones none
    assert 1 <= engine.prefill_dispatches - prefills <= len(prompts) - 2
    assert engine.stats()["kv_adoptions"] == 2
    assert engine._pool.free_pages == engine._pool.num_pages


def test_no_collection_runs_inside_a_capture(cuda):
    """A dropped paged engine (it and its pool reference each other) is
    freed by the cyclic collector; a collection inside another engine's
    capture would destroy its graphs mid-capture and invalidate that
    capture. With the collector made to run at almost every allocation,
    a second engine warms up while the first is garbage: no collection
    starts while a capture is open, and the second engine serves."""
    import gc

    from gofr_tpu_torch.tpu import generate

    dropped = _engine(cuda, paged=True, d=64)
    asyncio.run(dropped.warmup(ks=(1,)))
    del dropped
    during = []

    def watch(phase, info):
        if phase == "start" and generate._CAPTURES["open"]:
            during.append(info["generation"])

    engine = _engine(cuda, paged=True, d=64)
    thresholds = gc.get_threshold()
    gc.callbacks.append(watch)
    gc.set_threshold(1, 1, 1)
    try:
        asyncio.run(engine.warmup(ks=(1, 2)))
    finally:
        gc.set_threshold(*thresholds)
        gc.callbacks.remove(watch)
    gc.collect()
    assert during == []
    assert gc.isenabled() and generate._CAPTURES["open"] == 0
    assert len(asyncio.run(_serve(engine, _prompts(4, 2), budget=8))) == 2


def _tuner_trace(n=8):
    """A recorded trace of ``n`` requests, 20-60 prompt tokens, 8 new
    tokens each, as the workload recorder exports it."""
    import json

    from gofr_tpu_torch.tpu.flightrecorder import RequestRecord
    from gofr_tpu_torch.tpu.workload import TrafficRecorder, load_trace

    rec = TrafficRecorder(capacity=64)
    for i in range(n):
        record = RequestRecord(model="generate", prompt_len=20 + 5 * i,
                               budget=8)
        rec.admit(record, "standard", now=10.0 + i * 0.002)
        record.tokens = 8
        record.status = "done"
        rec.finish(record)
    return load_trace(json.dumps(rec.export_trace()))


def test_shadow_scoring_with_ticks_in_flight_syncs_nowhere(cuda):
    """A shadow scoring pass (the auto-tuner's ``_score_point``: a clone
    at the candidate point built, started, the trace replayed through
    its lazily captured graphs, stopped) while the live engine has ticks
    in flight, under ``set_sync_debug_mode("error")``: the live burst's
    greedy tokens are those of the same burst with no scoring, and the
    score is the one a pass alone gives."""
    from gofr_tpu_torch.tpu.autotune import AutoTuner, OperatingPoint

    prompts, budget = _prompts(5, n=4), 96
    bare = _engine(cuda, paged=False, d=64)
    asyncio.run(bare.warmup(prompt_counts=(1, SLOTS)))
    want = asyncio.run(_serve(bare, prompts, budget))
    del bare
    engine = _engine(cuda, paged=False, d=64)
    asyncio.run(engine.warmup(prompt_counts=(1, SLOTS)))
    tuner = AutoTuner(engine, min_trace_events=1)
    trace = _tuner_trace()
    point = OperatingPoint(prompt_buckets=(64,), steps_per_tick=2)
    alone = asyncio.run(tuner._score_point(point, trace))
    inflight = []

    async def run():
        await engine.start()
        try:
            tasks = [asyncio.ensure_future(engine.generate(p, budget))
                     for p in prompts]
            while engine._ticks_inflight < 1:
                await asyncio.sleep(0.001)
            inflight.append(engine._ticks_inflight)
            score = await tuner._score_point(point, trace)
            inflight.append(sum(not t.done() for t in tasks))
            return await asyncio.wait_for(asyncio.gather(*tasks), 300), score
        finally:
            await engine.stop()

    torch.cuda.set_sync_debug_mode("error")
    try:
        got, score = asyncio.run(run())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # the live engine captures the window rungs past its startup ones
    # lazily, in turns with the clone's captures
    assert got == want
    assert score == alone > 0.0
    assert inflight[0] >= 1


def test_scoring_firings_release_their_clones(cuda):
    """Each of the tuner's scoring firings builds a shadow clone a point
    (its own cache and graphs); the reserved bytes after three firings
    are no higher than after one."""
    import gc

    from gofr_tpu_torch.tpu.autotune import AutoTuner

    engine = _engine(cuda, paged=False, d=64)
    asyncio.run(engine.warmup(prompt_counts=(1, SLOTS)))
    trace = _tuner_trace()
    # every firing scores the live point and its candidates, and rejects
    tuner = AutoTuner(engine, improve_after=1, cooldown_s=0.0,
                      min_trace_events=1, min_gain_pct=1e9,
                      trace_fn=lambda: trace)

    def reserved():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_stats()["reserved_bytes.all.current"]

    async def fire():
        result = await tuner()
        # a stopped clone is freed once the loop has run its pending
        # callbacks
        await asyncio.sleep(0.05)
        return result["result"]

    after = []
    for _ in range(3):
        assert asyncio.run(fire()) == "rejected"
        after.append(reserved())
    assert after[2] <= after[0], after
    assert sum(e["result"] == "proposed" for e in tuner.ledger()) >= 3


def test_a_failed_capture_in_a_tuner_prewarm_raises(cuda):
    """The tuner's winner needs graphs the engine lacks (bucket 64, k 2);
    its prewarm captures them, and a device sync planted in the tick's
    captured body (legal in the eager run, refused while the stream
    captures) fails the capture: the firing raises, nothing is applied
    and the ledger holds no refusal."""
    import gc

    from gofr_tpu_torch.tpu import generate
    from gofr_tpu_torch.tpu.autotune import AutoTuner, OperatingPoint

    engine = _engine(cuda, paged=False, d=64)
    asyncio.run(engine.warmup(prompt_counts=(1,)))
    trace = _tuner_trace()
    winner = OperatingPoint(prompt_buckets=(64,), steps_per_tick=2)
    tuner = AutoTuner(engine, improve_after=1, cooldown_s=0.0,
                      min_trace_events=1, trace_fn=lambda: trace,
                      score_fn=lambda point, _: 2.0 if point == winner
                      else 1.0)
    tuner._candidates = lambda: [winner]
    body = engine._tick_body

    def planted(key, active):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()
        return body(key, active)
    engine._tick_body = planted
    generation = engine.operating_point()["generation"]
    with pytest.raises(RuntimeError):
        asyncio.run(tuner())
    engine._tick_body = body
    assert engine.operating_point()["generation"] == generation
    assert not any(e["result"] in ("rejected", "applied")
                   for e in tuner.ledger())
    assert gc.isenabled() and generate._CAPTURES["open"] == 0


def test_engines_capturing_at_once_take_turns(cuda):
    """Two engines that were never warmed serve at once from one loop,
    each capturing its ticks and prefills lazily on its own device
    thread: the captures take turns (a capture's start synchronizes the
    device, which fails while another stream captures), and each
    engine's tokens are its tokens served alone."""
    prompts = _prompts(6, n=4)
    want = [asyncio.run(_serve(_engine(cuda, paged=paged, d=64), prompts,
                               budget=40)) for paged in (True, False)]
    engines = [_engine(cuda, paged=paged, d=64) for paged in (True, False)]

    async def both():
        return await asyncio.gather(*[_serve(e, prompts, budget=40)
                                      for e in engines])
    assert list(asyncio.run(both())) == want
    assert all(e.lazy_captures and e.prefill_lazy_captures
               for e in engines)
