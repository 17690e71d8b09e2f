#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's engine, on one GPU.

Runs the engine configuration of ``chip_smoke.py``'s engine phase
(``llama3-8b`` width, random weights from ``--seed``, paged KV, page 32,
8 slots, buckets 32/128/512, 4 steps per tick) over the same 8 concurrent
requests (prompts 5..512 tokens, 32 new tokens each), once unprofiled for
the end-to-end numbers and once under ``torch.profiler`` for the device
time by kernel. Prints one JSON object (also written to ``--out``):

- ``wall_s``, ``tokens_per_s``, ``ttft_*``: the unprofiled run;
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

Run from the root of a checkout: ``python3 scripts/port_engine_profile.py``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import DRAFT_LAYERS, card_line, draft_view  # noqa: E402

# kernel names of gofr_tpu_torch/csrc, as the profiler shows them
PORT_KERNELS = ("flash_wgmma_kernel", "flash_fwd_kernel",
                "flash_decode_partial", "flash_decode_combine",
                "ragged_kernel")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--layers", type=int, default=32)
    parser.add_argument("--spec-gamma", type=int, default=0,
                        help="speculative decode with this gamma (0: off)")
    parser.add_argument("--kv-int8", action="store_true",
                        help="int8 KV pool with float32 scale planes")
    parser.add_argument("--out", default="chiprun_out/engine_profile.json")
    args = parser.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("port_engine_profile: no CUDA device", file=sys.stderr)
        return 1
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops.cuda import _build
    from gofr_tpu_torch.tpu.generate import GenerationEngine, Sampling

    _build.build_all()
    cfg = llama.config("llama3-8b", n_layers=args.layers, use_flash=True,
                       kv_int8=args.kv_int8)
    params = llama.init(cfg, args.seed, device="cuda")
    spec_kw = {}
    if args.spec_gamma:
        dcfg, dparams = draft_view(llama, cfg, params, DRAFT_LAYERS)
        spec_kw = dict(draft_cfg=dcfg, draft_params=dparams,
                       spec_gamma=args.spec_gamma)
    engine = GenerationEngine(cfg, params, max_slots=8, max_len=2048,
                              prompt_buckets=(32, 128, 512),
                              steps_per_tick=4, kv_page=32, device="cuda",
                              **spec_kw)
    rng = np.random.default_rng(args.seed)
    lengths = [5, 30, 64, 100, 128, 300, 480, 512]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    budget = 32

    async def one_run():
        samplings = [Sampling() for _ in range(7)] + [
            Sampling(temperature=0.8, top_p=0.95, seed=args.seed)]
        engine.ttfts.clear()
        start = time.monotonic()
        outs = await asyncio.gather(*[
            engine.generate(p, budget, sampling=s)
            for p, s in zip(prompts, samplings)])
        torch.cuda.synchronize()
        return outs, time.monotonic() - start, sorted(engine.ttfts)

    async def serve(prof):
        await engine.start()
        try:
            await engine.generate(prompts[0], 8)          # warm-up
            outs, wall, ttfts = await one_run()
            steps0, ticks0 = engine.decode_steps, engine.ticks
            spec0, draft0 = engine.spec_dispatches, engine.draft_steps
            with prof:
                _, prof_wall, _ = await one_run()
            return (outs, wall, ttfts, prof_wall,
                    engine.decode_steps - steps0, engine.ticks - ticks0,
                    engine.spec_dispatches - spec0,
                    engine.draft_steps - draft0)
        finally:
            await engine.stop()

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    (outs, wall, ttfts, prof_wall, steps, ticks, spec_ticks,
     draft_steps) = asyncio.run(serve(prof))
    assert all(len(out) == budget for out in outs)

    by_kernel, calls = {}, {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + dev_us / 1e6
            calls[evt.key] = calls.get(evt.key, 0) + evt.count
    busy = sum(by_kernel.values())
    port = {name: {"device_s": sec,
                   "share_of_busy": sec / busy if busy else None,
                   "count": calls[name]}
            for name, sec in by_kernel.items()
            if any(stem in name for stem in PORT_KERNELS)}
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:20]
    tokens = budget * len(outs)
    result = {
        "device": torch.cuda.get_device_name(0),
        "card": card_line(),
        "n_layers": args.layers,
        "kv_int8": args.kv_int8,
        "kv_pool": engine.stats()["kv_pool"],
        "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "ttft_p50_s": ttfts[len(ttfts) // 2],
        "ttft_max_s": ttfts[-1],
        "profiled_wall_s": prof_wall,
        "profiled_decode_steps": steps,
        "profiled_ticks": ticks,
        "profiled_spec_ticks": spec_ticks,
        "profiled_draft_steps": draft_steps,
        "speculative": engine.stats().get("speculative"),
        "device_busy_s": busy,
        "device_idle_share": (1.0 - busy / prof_wall) if prof_wall else None,
        "by_kernel": [{"name": name, "device_s": sec,
                       "share_of_busy": sec / busy if busy else None}
                      for name, sec in top],
        "port_kernels": port,
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
