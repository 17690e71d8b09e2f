"""The executor's CUDA graphs on the card. Marked ``cuda``: each test
skips itself on a host without a CUDA device. Run them on the GPU host
with ``python -m pytest tests/test_torch_cuda_executor.py -q
--noconftest``.

- Every bucket's replay gives, bit for bit, the eager run of the model
  function on the same padded batch (ResNet ``tiny`` and BERT ``tiny`` in
  bf16); a warm burst captures nothing.
- A model function that syncs the host fails its capture: ``predict``
  raises, no bucket is kept, the ledger notes no compile, and nothing
  falls back to an eager run.
- The executor replays its graphs from one thread while an engine
  captures its ticks and prefills in another (the one capture turn):
  every replay gives the reference output, and the engine then serves
  the tokens of an engine that warmed up alone.
"""

import asyncio
import threading

import numpy as np
import pytest
import torch

from gofr_tpu_torch.models import bert, llama, resnet
from gofr_tpu_torch.tpu.executor import Executor
from gofr_tpu_torch.tpu.generate import GenerationEngine

pytestmark = pytest.mark.cuda

BUCKETS = (1, 4, 8)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _models(cuda):
    rcfg = resnet.config("tiny")
    bcfg = bert.config("tiny")
    rng = np.random.default_rng(0)

    def images(n):
        return rng.standard_normal((n, 32, 32, 3)).astype(np.float32)

    def pairs(n):
        ids = rng.integers(0, 256, size=(n, 64)).astype(np.int32)
        mask = (np.arange(64)[None] < rng.integers(1, 65, size=(n, 1)))
        return ids, mask.astype(np.int32)

    def tbert(p, inputs):
        return bert.apply(p, bcfg, inputs[0], inputs[1])["mean"]

    return {"resnet": (lambda p, x: resnet.apply(p, rcfg, x),
                       resnet.init(rcfg, 0, device=cuda), images),
            "bert": (tbert, bert.init(bcfg, 1, device=cuda), pairs)}


@pytest.mark.parametrize("name", ["resnet", "bert"])
def test_bucket_replay_is_bitwise_the_eager_run(cuda, name):
    fn, params, make = _models(cuda)[name]
    executor = Executor(None, None, device=cuda)
    executor.register(name, fn, params, buckets=BUCKETS)
    first = make(1)
    executor.warmup(name, tuple(leaf[0] for leaf in first)
                    if name == "bert" else first[0])
    assert executor.ledger.total("warmup") == len(BUCKETS)
    for bucket in BUCKETS:
        n = max(1, bucket - 1)
        batch = make(n)
        got = executor.predict(name, batch)
        leaves = batch if name == "bert" else (batch,)
        padded = [torch.from_numpy(np.pad(
            leaf, [(0, bucket - n)] + [(0, 0)] * (leaf.ndim - 1))).to(cuda)
            for leaf in leaves]
        inputs = tuple(padded) if name == "bert" else padded[0]
        with torch.cuda.stream(executor._stream):
            want = fn(executor._models[name].params, inputs)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got, want.float().cpu().numpy()[:n])
    assert executor.ledger.total() == len(BUCKETS)


def test_a_host_sync_fails_the_capture_with_no_fallback(cuda):
    executor = Executor(None, None, device=cuda)
    executor.register("sync", lambda p, x: x * float(x.sum().item()), {},
                      buckets=(2,))
    with pytest.raises(RuntimeError):
        executor.predict("sync", np.ones((2, 3), np.float32))
    assert executor._models["sync"].compiled == {}
    assert executor.ledger.total() == 0
    assert executor.health_check()["compiling"] == []
    assert torch.cuda.get_sync_debug_mode() == 0


def _engine(cuda):
    cfg = llama.config("tiny", vocab_size=1024, dim=512, n_layers=2,
                       n_heads=8, n_kv_heads=2, ffn_dim=512,
                       max_seq_len=256, use_flash=True)
    return GenerationEngine(cfg, llama.init(cfg, 0, device=cuda),
                            max_slots=4, max_len=256,
                            prompt_buckets=(32, 64), steps_per_tick=4,
                            device=cuda)


async def _serve(engine, prompts):
    await engine.start()
    try:
        return await asyncio.wait_for(asyncio.gather(
            *[engine.generate(p, 12) for p in prompts]), 300)
    finally:
        await engine.stop()


def test_replays_while_an_engine_captures_stay_correct(cuda):
    prompts = [list(range(1, 1 + n)) for n in (5, 40, 17)]
    alone = _engine(cuda)
    asyncio.run(alone.warmup(prompt_counts=(1, 4)))
    want_tokens = asyncio.run(_serve(alone, prompts))
    del alone

    fn, params, make = _models(cuda)["resnet"]
    executor = Executor(None, None, device=cuda)
    executor.register("resnet", fn, params, buckets=BUCKETS)
    executor.warmup("resnet", make(1)[0])
    batches = [make(4) for _ in range(4)]
    want = [executor.predict("resnet", b) for b in batches]
    engine = _engine(cuda)
    warm = threading.Thread(target=lambda: asyncio.run(
        engine.warmup(prompt_counts=(1, 4))))
    warm.start()
    replays = 0
    while warm.is_alive() or replays < 8:
        for batch, expect in zip(batches, want):
            np.testing.assert_array_equal(
                executor.predict("resnet", batch), expect)
            replays += 1
    warm.join(timeout=300)
    assert not warm.is_alive()
    assert executor.ledger.total() == len(BUCKETS)
    assert engine.stats()["graphs"]["captured"] > 0
    assert asyncio.run(_serve(engine, prompts)) == want_tokens
