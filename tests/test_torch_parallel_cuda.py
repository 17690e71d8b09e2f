"""The engine over a mesh on the card: tp 2 (and dp 2) with every shard
on one card. Marked ``cuda``: each test skips itself without a CUDA
device; on the GPU host run ``python -m pytest
tests/test_torch_parallel_cuda.py -q --noconftest``.

- A tick's graph replay equals its eager run bit for bit at tp 2, dense
  and paged, the cache or pool of every rank included, and the launch
  counts of both are the same (each rank's kernels).
- A mesh of one shard gives the unsharded engine's greedy tokens bit for
  bit.
- Training over a mesh on cuda:0 shards: a dp 2 × tp 2 × sp 2 float32
  step equals the unsharded step within chip_smoke.py's phase 40 float32
  gates (loss 1e-5 relative; each moment leaf within 1e-4 of its
  largest; params within 1e-4 of the leaf's largest where the first
  moment is settled, 2·lr elsewhere); the eval over tp 2 launches the
  flash kernel once a layer and rank, within 1e-2 of the one-device
  flash eval; a sharded state's checkpoint restores with ``sharding=``
  bit for bit, shard for shard.
"""

import asyncio

import numpy as np
import pytest
import torch

from gofr_tpu_torch.models import llama
from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod
from gofr_tpu_torch.ops.cuda import launch_counts
from gofr_tpu_torch.parallel import make_mesh, sharding, train
from gofr_tpu_torch.tpu.generate import GenerationEngine
from gofr_tpu_torch.utils import restore_checkpoint, save_checkpoint
from gofr_tpu_torch.utils import tree as tree_util

pytestmark = pytest.mark.cuda

SLOTS, MAX_LEN, PAGE = 4, 256, 32


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _engine(cuda, axes, paged, params=None, cfg=None):
    cfg = cfg or llama.config(
        "tiny", vocab_size=1024, dim=1024, n_layers=2, n_heads=8,
        n_kv_heads=2, ffn_dim=512, max_seq_len=MAX_LEN, use_flash=True)
    params = params if params is not None else llama.init(cfg, 0,
                                                          device=cuda)
    mesh = make_mesh(axes, [cuda] * 8) if axes else None
    return GenerationEngine(cfg, params, max_slots=SLOTS, max_len=MAX_LEN,
                            prompt_buckets=(32, 64), steps_per_tick=4,
                            paged_kv=paged, kv_page=PAGE, mesh=mesh,
                            device=cuda), cfg, params


def _leaves(engine):
    """Every shard of the cache or pool by name and coordinate."""
    tree = engine._pool.leaves if engine.paged else engine.cache
    return {f"{name}@{coord}": t for name, leaf in tree.items()
            for coord, t in leaf.addressable_shards}


def _state(engine):
    out = {"cache_len": engine.cache_len, "last_token": engine.last_token,
           "keys": engine.sample_keys}
    out.update(_leaves(engine))
    return out


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("axes,paged", [({"tp": 2}, False), ({"tp": 2}, True),
                                        ({"dp": 2, "tp": 2}, False)])
def test_tp_tick_replay_is_bitwise_the_eager_tick(cuda, axes, paged):
    engine, _, _ = _engine(cuda, axes, paged)
    window = None if paged else 128
    key = ("plain", 4, True, window)
    asyncio.run(engine.warmup(ks=(4,), windows=(window,) if window else None))
    assert key in engine._graphs
    gen = torch.Generator(device=cuda).manual_seed(3)
    if paged:
        table = np.arange(SLOTS * (MAX_LEN // PAGE), dtype=np.int32)
        engine.table.copy_(torch.from_numpy(table.reshape(SLOTS, -1)))
    for t in _leaves(engine).values():
        t.copy_(torch.rand(t.shape, generator=gen, device=cuda) * 0.1)
    engine.cache_len.copy_(torch.tensor([0, 37, 100, 90], device=cuda))
    engine.last_token.copy_(torch.tensor([1, 2, 3, 4], device=cuda))
    engine.temps.copy_(torch.tensor([0.0, 0.8, 1.2, 0.9]))
    engine.active.copy_(torch.tensor([True, True, True, False]))
    saved = {k: v.clone() for k, v in _state(engine).items()}
    launch_counts.write({k: 0 for k in launch_counts.read()})
    eager = engine._tick_body(key, engine.active).clone()
    torch.cuda.synchronize()
    eager_counts = launch_counts.read()
    after = {k: v.clone() for k, v in _state(engine).items()}
    for name, tensor in _state(engine).items():
        tensor.copy_(saved[name])
    launch_counts.write({k: 0 for k in launch_counts.read()})
    replayed = engine._run_tick(key, None, None)()
    assert launch_counts.read() == eager_counts
    # each rank of each dp row launches its ragged kernel a layer a step
    ragged = sum(v for k, v in eager_counts.items() if "ragged" in k)
    assert ragged == 4 * 2 * axes.get("dp", 1) * axes["tp"]
    np.testing.assert_array_equal(replayed, eager.cpu().numpy())
    for name, tensor in _state(engine).items():
        if paged and "@" in name:
            tensor, want = tensor[:, :-1], after[name][:, :-1]
        else:
            want = after[name]
        assert torch.equal(_bits(tensor), _bits(want)), name


def test_one_shard_mesh_is_the_unsharded_engine(cuda):
    engine, cfg, params = _engine(cuda, None, False)
    sharded, _, _ = _engine(cuda, {"dp": 1, "tp": 1}, False, params, cfg)

    async def serve(eng):
        await eng.warmup(prompt_counts=(1, SLOTS))
        await eng.start()
        try:
            return await asyncio.gather(*[
                eng.generate([i + 1] * (5 + 7 * i), max_new_tokens=12)
                for i in range(SLOTS)])
        finally:
            await eng.stop()
    assert asyncio.run(serve(sharded)) == asyncio.run(serve(engine))


def _tokens(cuda, vocab, shape, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    tokens = torch.randint(0, vocab, shape, generator=gen, device=cuda)
    return tokens, torch.roll(tokens, -1, dims=1)


def _full(tree):
    return {key: leaf.gather() if isinstance(leaf, sharding.Sharded)
            else leaf for key, leaf in tree_util.flatten(tree).items()}


def test_mesh_train_step_is_the_unsharded_step(cuda):
    cfg = llama.config("tiny", dtype=torch.float32)
    mesh = make_mesh({"dp": 2, "tp": 2, "sp": 2}, [cuda] * 8)
    tokens, targets = _tokens(cuda, cfg.vocab_size, (4, 64), 40)
    init_fn, step_fn = train.make_train_step(cfg, device=cuda)
    _, mesh_step = train.make_train_step(cfg, mesh, use_sp=True, device=cuda)
    state = init_fn(0)
    mstate = train.shard_train_state(state, mesh)
    _, loss = step_fn(state, tokens, targets)
    _, mesh_loss = mesh_step(mstate, tokens, targets)
    assert abs(mesh_loss.item() - loss.item()) <= 1e-5 * loss.item()
    got, want = _full(mstate), _full(state)
    for key, ref in want.items():
        d = (got[key].float() - ref.float()).abs()
        scale = ref.float().abs().max().item()
        if "/.mu/" in key or "/.nu/" in key:
            assert d.max().item() <= 1e-4 * scale, key
        elif key.startswith(".params/"):
            mu = want[".opt_state/0/.mu/" + key[len(".params/"):]].abs()
            settled = mu > 1e-2 * mu.max()
            assert d[settled].max().item() <= 1e-4 * scale, key
            assert d.max().item() <= 2 * 3e-4, key
        else:
            assert torch.equal(got[key].cpu(), ref.cpu()), key


def test_eval_over_tp2_runs_the_flash_kernel(cuda):
    cfg = llama.config("tiny", dim=256, n_heads=4, n_kv_heads=2,
                       use_flash=True)
    params = llama.init(cfg, 0, device=cuda)
    mesh = make_mesh({"tp": 2}, [cuda] * 2)
    tokens, targets = _tokens(cuda, cfg.vocab_size, (2, 128), 41)
    flash_mod.reset_launches()
    loss = train.make_eval_step(cfg, mesh, device=cuda)(params, tokens,
                                                        targets)
    torch.cuda.synchronize()
    assert flash_mod.launches == cfg.n_layers * 2
    one = train.make_eval_step(cfg, device=cuda)(params, tokens, targets)
    assert abs(loss.item() - one.item()) <= 1e-2 * one.item()


def test_sharded_checkpoint_round_trip_is_bitwise(cuda, tmp_path):
    cfg = llama.config("tiny")
    mesh = make_mesh({"dp": 2, "tp": 2}, [cuda] * 4)
    tokens, targets = _tokens(cuda, cfg.vocab_size, (2, 32), 42)
    init_fn, step_fn = train.make_train_step(cfg, mesh, device=cuda)
    state, _ = step_fn(init_fn(0), tokens, targets)
    save_checkpoint(str(tmp_path), state, step=1)
    restored = restore_checkpoint(
        str(tmp_path), state,
        sharding=tree_util.tree_map(lambda leaf: leaf.sharding, state))
    want = tree_util.flatten(state)
    for key, leaf in tree_util.flatten(restored).items():
        assert leaf.spec == want[key].spec, key
        assert len(leaf.distinct_shards()) == \
            len(want[key].distinct_shards()), key
        for coord, t in leaf.addressable_shards:
            ref = want[key].shard(coord)
            assert t.device == ref.device and t.dtype == ref.dtype, key
            assert torch.equal(_bits(t), _bits(ref)), (key, coord)
