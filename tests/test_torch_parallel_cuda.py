"""The engine over a mesh on the card: tp 2 (and dp 2) with every shard
on one card. Marked ``cuda``: each test skips itself without a CUDA
device; on the GPU host run ``python -m pytest
tests/test_torch_parallel_cuda.py -q --noconftest``.

- A tick's graph replay equals its eager run bit for bit at tp 2, dense
  and paged, the cache or pool of every rank included, and the launch
  counts of both are the same (each rank's kernels).
- A mesh of one shard gives the unsharded engine's greedy tokens bit for
  bit.
"""

import asyncio

import numpy as np
import pytest
import torch

from gofr_tpu_torch.models import llama
from gofr_tpu_torch.ops.cuda import launch_counts
from gofr_tpu_torch.parallel import make_mesh
from gofr_tpu_torch.tpu.generate import GenerationEngine

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
