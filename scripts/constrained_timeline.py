#!/usr/bin/env python3
"""Timeline of one mixed burst (constrained and unconstrained requests) on
the card: when the device thread queues each prefill and each tick (its
kind, k and window), when each host copy lands and when it publishes,
with Python's garbage collections over 1 ms; then each request's TTFT
and finish time and the ticks by (kind, k).

The model and engine are ``chip_smoke.py`` phase 26's: the example app's
``small`` over 256 byte ids (random weights, seed 3), dense, max_len
1024, 8 slots, 16 steps a tick, 4 ticks in flight, and its burst of 8
(4 constrained). The burst runs twice (the first captures the biased
rungs) and the second is traced. Times are milliseconds from the burst's
start.

Run from the root of a checkout: ``python3 scripts/constrained_timeline.py``.
Needs a CUDA device.
"""

from __future__ import annotations

import asyncio
import gc
import sys
import time
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

LINES = 60


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("constrained_timeline: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops.cuda import _build
    from gofr_tpu_torch.tpu import constrain, generate

    _build.build_all()
    print(smoke.card_line())
    cfg = llama.config("small", vocab_size=smoke.EXAMPLE_VOCAB,
                       use_flash=True)
    params = llama.init(cfg, 3, device="cuda")
    engine = generate.GenerationEngine(
        cfg, params, device="cuda",
        token_table=constrain.token_byte_table(vocab_size=cfg.vocab_size),
        **smoke.SMALL_ENGINE)
    mixed = smoke.burst_requests(generate, cfg, 0, 4)
    start, log, gc_at, ticks = [0.0], [], [0.0], Counter()
    tracing = [False]

    def mark(what):
        if tracing[0]:
            log.append(((time.monotonic() - start[0]) * 1e3, what))

    def on_gc(phase, info):
        if phase == "start":
            gc_at[0] = time.monotonic()
        elif time.monotonic() - gc_at[0] > 1e-3:
            mark(f"gc gen{info['generation']} "
                 f"{(time.monotonic() - gc_at[0]) * 1e3:.1f} ms")

    def traced(name, label):
        fn = getattr(engine, name)

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

    def tick_label(args):
        kind, k, sampled, window = args[0]
        return f"{kind} k {k}{' sampled' if sampled else ''} w {window}"

    traced("_prefill_insert",
           lambda a: f"prefill {a[2]} of {a[0]} rows x {a[1]}"
           + (" biased" if len(a) > 7 and a[7] else ""))
    traced("_run_tick", tick_label)
    dispatch = engine._dispatch

    def dispatched(loop, key, *args, **kw):
        if tracing[0]:
            ticks[key[0], key[1]] += 1
        return dispatch(loop, key, *args, **kw)
    engine._dispatch = dispatched
    publish = engine._publish

    def published(entry, host):
        mark(f"publish {entry.kind}")
        publish(entry, host)
    engine._publish = published
    gc.callbacks.append(on_gc)

    async def burst():
        await engine.warmup()
        await engine.start()
        try:
            await engine.generate(mixed[0][0], 8)
            await smoke.serve_requests(engine, mixed)
            gc.collect()
            engine.ttfts.clear()
            done = {}

            async def one(i, prompt, budget, sampling, rf):
                out = await engine.generate(prompt, budget,
                                            sampling=sampling,
                                            response_format=rf)
                done[i] = ((time.monotonic() - start[0]) * 1e3, len(out))
            tracing[0] = True
            start[0] = time.monotonic()
            await asyncio.gather(*[one(i, *req)
                                   for i, req in enumerate(mixed)])
            tracing[0] = False
            return sorted(engine.ttfts), done
        finally:
            await engine.stop()

    ttfts, done = asyncio.run(burst())
    print(f"TTFT ms: {[round(t * 1e3, 1) for t in ttfts]}")
    for i, (at, n) in sorted(done.items()):
        rf = mixed[i][3]
        print(f"  request {i}: {n} tokens, done at {at:.1f} ms"
              f"{', ' + rf['type'] if rf else ''}")
    print(f"ticks by (kind, k): {dict(sorted(ticks.items()))}")
    for at, what in log[:LINES]:
        print(f"  {at:9.2f} {what}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
