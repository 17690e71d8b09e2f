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
- ``GenerationEngine`` refuses at construction, on CUDA, each
  configuration the kernels would refuse at the first tick.

The model is 2 layers of head_dim 128 (Hq 8, Hkv 2) at vocabulary 1024,
random weights from a seed; the state is random too: pages scattered
over the pool, fills 0..200, every slot sampled with its own key.
"""

import asyncio

import numpy as np
import pytest
import torch

from gofr_tpu_torch.models import llama
from gofr_tpu_torch.ops import prng
from gofr_tpu_torch.ops.cuda import launch_counts
from gofr_tpu_torch.tpu.generate import GenerationEngine

pytestmark = pytest.mark.cuda

SLOTS, MAX_LEN, PAGE = 4, 256, 32


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


def _engine(cuda, int8=False, spec=False, paged=True):
    cfg = _cfg(kv_int8=int8)
    params = llama.init(cfg, 0, device=cuda)
    kw = {}
    if spec:
        dcfg = _cfg()
        kw = dict(draft_cfg=dcfg, draft_params=llama.init(dcfg, 1,
                                                          device=cuda),
                  spec_gamma=4)
    return GenerationEngine(cfg, params, max_slots=SLOTS, max_len=MAX_LEN,
                            prompt_buckets=(32, 64), steps_per_tick=4,
                            paged_kv=paged, kv_page=PAGE, device=cuda, **kw)


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


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kind", ["plain", "spec"])
def test_replayed_tick_is_bitwise_the_eager_tick(cuda, kind, sampled, int8):
    engine = _engine(cuda, int8=int8, spec=kind == "spec")
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


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kind", ["plain", "spec"])
def test_dense_tick_replay_is_bitwise_the_eager_tick(cuda, kind, sampled,
                                                     int8):
    """The dense engine's tick at window 128 (the ragged kernels over the
    128-position identity table; the draft's flash decode over the
    window's view), fills below the window and the inactive slot's past
    it: replay and eager run give the same tokens and state, the whole
    cache included (no scratch rows: the inactive slot writes at its
    frozen position)."""
    engine = _engine(cuda, int8=int8, spec=kind == "spec", paged=False)
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


# what each configuration changes, and its spec_gamma
REFUSED = {
    "spec_gamma": (dict(), 8),
    "head_dim": (dict(dim=512), 4),                      # head_dim 64
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
