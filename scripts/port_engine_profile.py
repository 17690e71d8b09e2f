#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's engine, on one GPU.

Runs the engine configuration of ``chip_smoke.py``'s engine phase
(``llama3-8b`` width, random weights from ``--seed``, paged KV, page 32,
or with ``--dense`` the dense cache and its attention-window ladder,
8 slots, buckets 32/128/512, 4 steps per tick) over the same 8 concurrent
requests (prompts 5..512 tokens, 32 new tokens each, one sampled), once
unprofiled for the end-to-end numbers and once under ``torch.profiler``
for the device time by kernel. An engine with ``warmup()`` (graph capture
of its ticks) runs it first; its time and the memory it took are
reported apart. Prints one JSON object (also written to ``--out``):

- ``wall_s``, ``tokens_per_s``, ``ttft_*``, ``peak_mem_gb``: the
  unprofiled run;
- ``warmup_s``, ``warmup_mem_gb``, ``graphs``: the engine's warm-up (graph
  capture), where it has one;
- ``device_busy_s`` and ``device_idle_share``: the sum of device kernel
  time over the profiled run's wall time (one stream, so no overlap);
- ``by_kernel``: device time per kernel name, largest first, with the
  port's kernels named as they are launched;
- ``port_kernels``: for every kernel of the port's CUDA sources (flash
  prefill, flash decode's partial and combine, ragged), its device time,
  share of the busy time and count, whether or not it is among the
  largest.

``--kv-int8`` gives the target an int8 KV pool (``LlamaConfig.kv_int8``:
decode and verify through the ragged kernel's int8 instantiation; the
draft stays bf16). ``--spec-gamma 4`` profiles the speculative engine
instead, with the draft
of ``chip_smoke.py``'s speculative phase (``chip_smoke.draft_view``: views
of the target's first ``DRAFT_LAYERS`` (4) layers, its embedding, final
norm and head): the draft proposes through the flash-decode kernel and
the target verifies through the ragged verify kernel; the result then
also holds the engine's ``speculative`` stats.

:func:`run_cell` is the burst itself; ``scripts/engine_ab.py`` runs it
against two trees in turns.

Run from the root of a checkout: ``python3 scripts/port_engine_profile.py``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import asyncio
import inspect
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (DRAFT_LAYERS, card_line, device_times,  # noqa: E402
                        draft_view)

# kernel names of gofr_tpu_torch/csrc, as the profiler shows them
PORT_KERNELS = ("flash_wgmma_kernel", "flash_fwd_kernel",
                "flash_decode_partial", "flash_decode_combine",
                "ragged_kernel")
PROMPT_LENGTHS = (5, 30, 64, 100, 128, 300, 480, 512)
BUDGET = 32


def make_engine(generate, llama, cfg, params, spec_gamma=0, device="cuda",
                dense=False, **engine_kw):
    """The cell's engine: the configuration of ``chip_smoke.py``'s engine
    phase, paged (or with ``dense`` the dense cache and its window
    ladder), speculative (a draft of views of the target's first layers)
    when ``spec_gamma`` is set. ``engine_kw`` entries the engine does not
    take (an older tree's) are dropped: a tree without ``paged_kv`` has
    only the paged engine."""
    kw = dict(max_slots=8, max_len=2048, prompt_buckets=(32, 128, 512),
              steps_per_tick=4, kv_page=32, device=device)
    takes = inspect.signature(generate.GenerationEngine).parameters
    if "paged_kv" in takes:
        kw["paged_kv"] = not dense
    elif dense:
        raise ValueError("this tree's engine has no dense cache")
    if spec_gamma:
        dcfg, dparams = draft_view(llama, cfg, params, DRAFT_LAYERS)
        kw.update(draft_cfg=dcfg, draft_params=dparams,
                  spec_gamma=spec_gamma)
    kw.update({key: val for key, val in engine_kw.items() if key in takes})
    return generate.GenerationEngine(cfg, params, **kw)


def run_cell(torch, generate, engine, vocab_size, seed=0, profile=True):
    """Warm the engine up (``warmup()`` where it has one, then one
    request), serve the burst unprofiled, then again under
    ``torch.profiler`` (device activity only) when ``profile``. Returns
    the result dict."""
    import numpy as np
    from torch.profiler import ProfilerActivity

    cuda = engine.device.type == "cuda"
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab_size, n).tolist()
               for n in PROMPT_LENGTHS]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    async def one_run():
        samplings = [generate.Sampling() for _ in range(7)] + [
            generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]
        engine.ttfts.clear()
        start = time.monotonic()
        outs = await asyncio.gather(*[
            engine.generate(p, BUDGET, sampling=s)
            for p, s in zip(prompts, samplings)])
        sync()
        return outs, time.monotonic() - start, sorted(engine.ttfts)

    async def serve():
        warm = {}
        if hasattr(engine, "warmup"):
            sync()
            mem0 = torch.cuda.memory_allocated() if cuda else 0
            t0 = time.monotonic()
            await engine.warmup()
            sync()
            warm = dict(warmup_s=time.monotonic() - t0,
                        warmup_mem_gb=((torch.cuda.memory_allocated() - mem0)
                                       / 1e9 if cuda else None))
        await engine.start()
        try:
            await engine.generate(prompts[0], 8)          # warm-up
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            outs, wall, ttfts = await one_run()
            peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
            before = (engine.decode_steps, engine.ticks,
                      engine.spec_dispatches, engine.draft_steps)
            prof, prof_wall = None, None
            if profile:
                prof = torch.profiler.profile(
                    activities=[ProfilerActivity.CUDA])
                with prof:
                    _, prof_wall, _ = await one_run()
            after = (engine.decode_steps, engine.ticks,
                     engine.spec_dispatches, engine.draft_steps)
            return (outs, wall, ttfts, peak, warm, prof, prof_wall,
                    [a - b for a, b in zip(after, before)])
        finally:
            await engine.stop()

    (outs, wall, ttfts, peak, warm, prof, prof_wall,
     (steps, ticks, spec_ticks, draft_steps)) = asyncio.run(serve())
    assert all(len(out) == BUDGET for out in outs)
    stats = engine.stats()
    tokens = BUDGET * len(outs)
    result = {
        "kv_int8": bool(engine.cfg.kv_int8),
        "spec_gamma": engine.spec_gamma if engine.spec else 0,
        "max_inflight_ticks": stats.get("max_inflight_ticks"),
        "paged": "kv_pool" in stats,
        "kv_pool": stats.get("kv_pool"),
        "kv_cache": stats.get("kv_cache"),
        "ticks_by_window": stats.get("ticks_by_window"),
        "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "ttft_p50_s": ttfts[len(ttfts) // 2],
        "ttft_max_s": ttfts[-1],
        "peak_mem_gb": peak,
        **warm,
        "graphs": stats.get("graphs"),
        "speculative": stats.get("speculative"),
        "greedy_outputs": outs[:7],
    }
    if prof is not None and cuda:
        by_kernel, calls = device_times(torch, prof)
        busy = sum(by_kernel.values())
        result.update({
            "profiled_wall_s": prof_wall,
            "profiled_decode_steps": steps,
            "profiled_ticks": ticks,
            "profiled_spec_ticks": spec_ticks,
            "profiled_draft_steps": draft_steps,
            "device_busy_s": busy,
            "device_idle_share": (1.0 - busy / prof_wall) if prof_wall
            else None,
            "by_kernel": [{"name": name, "device_s": sec,
                           "share_of_busy": sec / busy if busy else None}
                          for name, sec in sorted(by_kernel.items(),
                                                  key=lambda kv: -kv[1])[:20]],
            "port_kernels": {
                name: {"device_s": sec,
                       "share_of_busy": sec / busy if busy else None,
                       "count": calls[name]}
                for name, sec in by_kernel.items()
                if any(stem in name for stem in PORT_KERNELS)},
        })
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--layers", type=int, default=32)
    parser.add_argument("--spec-gamma", type=int, default=0,
                        help="speculative decode with this gamma (0: off)")
    parser.add_argument("--kv-int8", action="store_true",
                        help="int8 KV pool with float32 scale planes")
    parser.add_argument("--dense", action="store_true",
                        help="the dense cache and its window ladder "
                             "(paged_kv=False) instead of the paged pool")
    parser.add_argument("--out", default="chiprun_out/engine_profile.json")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("port_engine_profile: no CUDA device", file=sys.stderr)
        return 1
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops.cuda import _build
    from gofr_tpu_torch.tpu import generate

    _build.build_all()
    cfg = llama.config("llama3-8b", n_layers=args.layers, use_flash=True,
                       kv_int8=args.kv_int8)
    params = llama.init(cfg, args.seed, device="cuda")
    engine = make_engine(generate, llama, cfg, params, args.spec_gamma,
                         dense=args.dense)
    result = {"device": torch.cuda.get_device_name(0), "card": card_line(),
              "n_layers": args.layers,
              **run_cell(torch, generate, engine, cfg.vocab_size, args.seed)}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
