#!/usr/bin/env python3
"""Timeline of one engine burst on the card: when the loop admits, when the
device thread starts and ends queueing each prefill and each tick, when
each host copy lands and when each step publishes, with Python's garbage
collections over 1 ms; then the burst's TTFTs.

The burst is ``port_engine_profile``'s (8 requests, prompts 5..512, 32 new
tokens, one sampled) on the plain and the ``kv_int8`` engine, each after
``warmup()`` and one warm-up request. Times are milliseconds from the
burst's start. It wraps the engine's own steps, so it reads the engine
without changing what the card runs.

Run from the root of a checkout: ``python3 scripts/engine_timeline.py``.
Needs a CUDA device.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import port_engine_profile as profile_mod  # noqa: E402

LINES = 24


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("engine_timeline: no CUDA device", file=sys.stderr)
        return 1
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops.cuda import _build
    from gofr_tpu_torch.tpu import generate

    _build.build_all()
    cfg = llama.config("llama3-8b", use_flash=True)
    params = llama.init(cfg, 0, device="cuda")
    start, log, gc_at = [0.0], [], [0.0]

    def mark(what):
        log.append(((time.monotonic() - start[0]) * 1e3, what))

    def on_gc(phase, info):
        if phase == "start":
            gc_at[0] = time.monotonic()
        elif time.monotonic() - gc_at[0] > 1e-3:
            mark(f"gc gen{info['generation']} "
                 f"{(time.monotonic() - gc_at[0]) * 1e3:.1f} ms")

    gc.callbacks.append(on_gc)
    for int8 in (False, True):
        engine = profile_mod.make_engine(
            generate, llama, dataclasses.replace(cfg, kv_int8=int8), params)

        def traced(name, fn, label):
            def call(*args):
                mark(f"device: {label(args)} queue start")
                fetch = fn(*args)
                mark(f"device: {label(args)} queue end")

                def wait():
                    values = fetch()
                    mark(f"landed {label(args)}")
                    return values
                return wait
            setattr(engine, name, call)

        traced("_prefill_insert", engine._prefill_insert,
               lambda a: f"prefill nb={a[0]} bucket={a[1]}")
        traced("_run_tick", engine._run_tick, lambda a: f"tick {a[0]}")
        publish, admit = engine._publish, engine._admit_pending

        def published(entry, host, publish=publish):
            mark(f"publish {entry.kind}")
            publish(entry, host)

        def admitted(loop, admit=admit):
            if not engine._pending.empty():
                mark(f"admit {engine._pending.qsize()} pending")
            return admit(loop)
        engine._publish, engine._admit_pending = published, admitted

        async def burst():
            await engine.warmup()
            await engine.start()
            try:
                rng = np.random.default_rng(0)
                prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                           for n in profile_mod.PROMPT_LENGTHS]
                await engine.generate(prompts[0], 8)
                samplings = [generate.Sampling() for _ in range(7)] + [
                    generate.Sampling(temperature=0.8, top_p=0.95, seed=0)]
                log.clear()
                engine.ttfts.clear()
                start[0] = time.monotonic()
                await asyncio.gather(*[
                    engine.generate(p, profile_mod.BUDGET, sampling=s)
                    for p, s in zip(prompts, samplings)])
                return sorted(engine.ttfts)
            finally:
                await engine.stop()

        ttfts = asyncio.run(burst())
        print(f"{'kv_int8' if int8 else 'bf16'} engine, TTFT ms: "
              f"{[round(t * 1e3, 1) for t in ttfts]}")
        for at, what in log[:LINES]:
            print(f"  {at:9.2f} {what}")
        del engine
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
