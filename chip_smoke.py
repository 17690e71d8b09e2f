#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``gofr_tpu_torch``).

Drives the port's main path on one NVIDIA GPU: the paged Llama
``/generate`` engine at the full ``llama3-8b`` geometry (random weights
from ``--seed``), with prefill through the hand-written flash-attention
kernel and every decode step through the hand-written ragged paged decode
kernel. Phases, each of which raises (exit code != 0) on failure:

1. card identity (``nvidia-smi`` name and power limit, torch/CUDA);
2. kernel build (one ``nvcc`` per source, all at once) and its time;
3. flash kernel vs its plain version, bf16, Hq 32 / Hkv 8 / D 128,
   causal, S in {32, 128, 512, 2048}, B in {1, 4}; timed beside the plain
   version and ``scaled_dot_product_attention`` (a yardstick only);
4. ragged kernel vs its plain version, bf16, 8 slots, page 32, 64 table
   columns, fills {0, 1, 31, 32, 33, 700, 2047, 512}, every position no
   live entry references poisoned with NaN;
5. a 2-layer full-width model: prefill + 4 paged decode steps through the
   kernels on the card (bf16) against the plain path on the CPU (f32);
6. the full 32-layer engine answering 8 concurrent requests (prompts over
   every bucket, 32 new tokens each, one sampled), with the kernels'
   launch counts checked against the engine's prefill dispatches and
   decode steps, then one streamed request;
7. one ``{"kernels": [...]}`` line, then the card line, then the last
   line ``{"ok": true, "device": {...}}``.

Run from the root of a checkout: ``python3 chip_smoke.py``. Details go to
``chiprun_out/chip_smoke.json``. Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor-core rate
FLASH_TOL = 3e-2                 # bf16: see phase 3
RAGGED_TOL = 1.6e-2              # bf16: one ulp at |x| <= 2, see phase 4
MODEL_REL_TOL = 5e-2             # relative L2 logits error, see phase 5
Q_HEADS, KV_HEADS, HEAD_DIM = 32, 8, 128


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Per-launch CUDA-event timing with the L2 flushed before each launch
    (a decode layer or a prefill finds its operands cold in the 50 MB L2)."""

    def __init__(self, torch):
        self.torch = torch
        self.scratch = torch.empty(256 << 20, dtype=torch.uint8,
                                   device="cuda")

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.scratch.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def phase_flash(torch, flash_mod, timer, results):
    import torch.nn.functional as F

    log("== phase 3: flash_attention kernel vs plain (bf16, causal)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, worst = [], 0.0
    for batch in (1, 4):
        for seq in (32, 128, 512, 2048):
            q = torch.randn((batch, seq, Q_HEADS, HEAD_DIM), generator=gen,
                            device="cuda").bfloat16()
            k, v = (torch.randn((batch, seq, KV_HEADS, HEAD_DIM),
                                generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
            out = flash_mod.flash_attention(q, k, v)
            torch.cuda.synchronize()
            ref = flash_mod.flash_attention_plain(q, k, v)
            err = (out.float() - ref.float()).abs().max().item()
            if not torch.isfinite(out).all() or err > FLASH_TOL:
                raise AssertionError(
                    f"flash B={batch} S={seq}: max|kernel-plain| {err} > "
                    f"{FLASH_TOL}")
            worst = max(worst, err)
            ms = timer(lambda: flash_mod.flash_attention(q, k, v))
            plain_ms = timer(lambda: flash_mod.flash_attention_plain(q, k, v),
                             iters=3)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            flops = 2.0 * batch * Q_HEADS * seq * seq * HEAD_DIM
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
            bound = max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
            row = dict(B=batch, S=seq, max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound * 1e3,
                       bound_by=("operations" if flops / BF16_FLOP_PER_S
                                 >= nbytes / HBM_BYTES_PER_S else "bytes"),
                       tflops=flops / (ms * 1e-3) / 1e12)
            rows.append(row)
            log(f"flash B={batch} S={seq:5d} err={err:.3e} "
                f"kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
                f"sdpa={lib_ms:.4f}ms bound={row['bound_ms']:.4f}ms "
                f"({row['tflops']:.1f} TFLOP/s)")
    results["flash"] = rows
    return worst


def phase_ragged(torch, ragged_mod, timer, results):
    import numpy as np

    log("== phase 4: ragged_paged_decode_attention kernel vs plain (bf16)")
    fills = [0, 1, 31, 32, 33, 700, 2047, 512]
    batch, page, width = len(fills), 32, 64
    num_pages = batch * width
    rng = np.random.default_rng(2)
    order = rng.permutation(num_pages)          # pages scattered in the pool
    table = np.full((batch, width), num_pages, np.int32)
    live = np.zeros((num_pages, page), bool)
    nxt = 0
    for row, n in enumerate(fills):
        for col in range(-(-n // page)):
            pid = int(order[nxt])
            nxt += 1
            table[row, col] = pid
            live[pid, :min(page, n - col * page)] = True
    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = (num_pages, page, KV_HEADS, HEAD_DIM)
    poison = torch.from_numpy(~live).cuda()[..., None, None]
    k_pages = torch.randn(shape, generator=gen, device="cuda").bfloat16() \
        .masked_fill(poison, float("nan"))
    v_pages = torch.randn(shape, generator=gen, device="cuda").bfloat16() \
        .masked_fill(poison, float("nan"))
    q = torch.randn((batch, 1, Q_HEADS, HEAD_DIM), generator=gen,
                    device="cuda").bfloat16()
    k_new, v_new = (torch.randn((batch, KV_HEADS, HEAD_DIM), generator=gen,
                                device="cuda").bfloat16() for _ in range(2))
    args = (q, k_pages, v_pages, torch.from_numpy(table).cuda(), k_new,
            v_new, torch.tensor(fills, dtype=torch.int32, device="cuda"))
    out = ragged_mod.ragged_paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = ragged_mod.ragged_paged_decode_attention_plain(*args)
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.isfinite(out).all():
        raise AssertionError("ragged kernel output is not finite: it read a "
                             "poisoned page")
    if not torch.isfinite(ref).all() or err > RAGGED_TOL:
        raise AssertionError(f"ragged: max|kernel-plain| {err} > "
                             f"{RAGGED_TOL}")
    ms = timer(lambda: ragged_mod.ragged_paged_decode_attention(*args),
               iters=20)
    plain_ms = timer(
        lambda: ragged_mod.ragged_paged_decode_attention_plain(*args),
        iters=5)
    live_tokens = sum(fills)
    kv_bytes = 2 * live_tokens * KV_HEADS * HEAD_DIM * 2
    small_bytes = 2 * (2 * q.numel() + k_new.numel() + v_new.numel()) \
        + 4 * (table.size + batch)
    nbytes = kv_bytes + small_bytes
    flops = 4.0 * (live_tokens + batch) * Q_HEADS * HEAD_DIM
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
    row = dict(B=batch, fills=fills, page=page, table_width=width,
               max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=bound * 1e3, bound_by="bytes",
               gb_per_s=nbytes / (ms * 1e-3) / 1e9)
    results["ragged"] = row
    log(f"ragged B={batch} err={err:.3e} kernel={ms:.4f}ms "
        f"plain={plain_ms:.4f}ms bound={row['bound_ms']:.4f}ms "
        f"({row['gb_per_s']:.1f} GB/s) library=none")
    return row


def phase_model(torch, llama, seed, results):
    import numpy as np

    log("== phase 5: 2-layer llama3-8b width, kernels (card, bf16) vs "
        "plain (CPU, f32)")
    cfg = llama.config("llama3-8b", n_layers=2, use_flash=True)
    params = llama.init(cfg, seed, device="cuda")
    ref_cfg = llama.config("llama3-8b", n_layers=2, dtype=torch.float32)

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {key: to_cpu(val) for key, val in tree.items()}
        return tree.float().cpu()

    ref_params = to_cpu(params)
    rng = np.random.default_rng(seed)
    lengths = np.array([19, 32], np.int64)
    tokens = rng.integers(0, cfg.vocab_size, (2, 32))
    page, num_pages, width, steps = 32, 8, 4, 4
    table = np.full((2, width), num_pages, np.int32)
    table[0, 0] = 5
    table[1, :2] = [2, 6]

    def run(c, p, dev, feed):
        """Prefill, place the prompt KV in pool pages, then ``steps``
        paged decode steps. ``feed`` holds each step's (2,) tokens; when
        empty, this run's own greedy tokens are appended to it."""
        record = not feed
        small = llama.init_cache(c, 2, 32, device=dev)
        logits, small, cache_len = llama.prefill(
            p, c, torch.as_tensor(tokens, device=dev), small,
            lengths=torch.as_tensor(lengths, device=dev))
        pool = {name: torch.zeros((c.n_layers, num_pages, page,
                                   c.n_kv_heads, c.head_dim),
                                  dtype=c.dtype, device=dev)
                for name in ("k", "v")}
        for name in ("k", "v"):
            pool[name][:, 5] = small[name][:, 0]
            pool[name][:, 2] = small[name][:, 1]
        table_t = torch.as_tensor(table, device=dev)
        active = torch.ones(2, dtype=torch.bool, device=dev)
        out = [logits.float().cpu()]
        for step in range(steps):
            if record:
                feed.append(logits.argmax(-1).cpu())
            logits, pool, cache_len = llama.decode_step_paged(
                p, c, feed[step].to(dev), pool, table_t, cache_len, active)
            out.append(logits.float().cpu())
        return out

    # the CPU reference picks the greedy tokens; the card is fed the same
    feed = []
    ref_out = run(ref_cfg, ref_params, "cpu", feed)
    card_out = run(cfg, params, "cuda", feed)
    rel, agree, total = [], 0, 0
    for ref, got in zip(ref_out, card_out):
        if not torch.isfinite(got).all():
            raise AssertionError("model check: non-finite card logits")
        rel.append(((got - ref).norm() / ref.norm()).item())
        agree += int((got.argmax(-1) == ref.argmax(-1)).sum())
        total += ref.shape[0]
    worst = max(rel)
    log(f"model: relative L2 logits error per step "
        f"{[round(r, 5) for r in rel]} (bound {MODEL_REL_TOL}); "
        f"top-1 agreement {agree}/{total}")
    results["model_check"] = dict(rel_l2=rel, top1_agree=agree,
                                  top1_total=total, bound=MODEL_REL_TOL)
    if worst > MODEL_REL_TOL:
        raise AssertionError(f"model check: relative error {worst} > "
                             f"{MODEL_REL_TOL}")
    del params, ref_params
    torch.cuda.empty_cache()


def phase_engine(torch, llama, generate, flash_mod, ragged_mod, seed,
                 n_layers, results):
    import numpy as np

    log(f"== phase 6: llama3-8b engine, {n_layers} layers, full width")
    if n_layers != 32:
        log(f"NOTE: depth cut to {n_layers} layers (width unchanged)")
    cfg = llama.config("llama3-8b", n_layers=n_layers, use_flash=True)
    t0 = time.monotonic()
    params = llama.init(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    log(f"random weights ({sum(_numel(params)) / 1e9:.2f} B params) in "
        f"{time.monotonic() - t0:.1f}s")
    engine = generate.GenerationEngine(
        cfg, params, max_slots=8, max_len=2048,
        prompt_buckets=(32, 128, 512), steps_per_tick=4, kv_page=32,
        device="cuda")
    rng = np.random.default_rng(seed)
    lengths = [5, 30, 64, 100, 128, 300, 480, 512]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    budget = 32

    async def serve():
        await engine.start()
        try:
            # warm-up (cuBLAS handles, allocator): not part of the run
            await engine.generate(prompts[0], 2)
            flash_mod.reset_launches()
            ragged_mod.reset_launches()
            prefills0, steps0 = engine.prefill_dispatches, engine.decode_steps
            engine.ttfts.clear()
            start = time.monotonic()
            samplings = [generate.Sampling() for _ in range(7)] + [
                generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]
            outs = await asyncio.wait_for(asyncio.gather(*[
                engine.generate(p, budget, sampling=s)
                for p, s in zip(prompts, samplings)]), 900)
            wall = time.monotonic() - start
            counts = dict(flash=flash_mod.launches,
                          ragged=ragged_mod.launches,
                          prefills=engine.prefill_dispatches - prefills0,
                          steps=engine.decode_steps - steps0)
            ttfts = sorted(engine.ttfts)
            stream = await engine.generate_stream(prompts[3], 8)
            streamed = [tok async for tok in stream]
            return outs, wall, counts, ttfts, streamed
        finally:
            await engine.stop()

    outs, wall, counts, ttfts, streamed = asyncio.run(serve())
    for n, out in zip(lengths, outs):
        if len(out) != budget or not all(0 <= t < cfg.vocab_size
                                         for t in out):
            raise AssertionError(f"prompt of {n}: bad completion {out}")
    if len(streamed) != 8:
        raise AssertionError(f"stream returned {len(streamed)} tokens")
    want_flash = n_layers * counts["prefills"]
    want_ragged = n_layers * counts["steps"]
    if counts["flash"] != want_flash or counts["ragged"] != want_ragged:
        raise AssertionError(f"launch counts {counts}: expected flash "
                             f"{want_flash}, ragged {want_ragged}")
    tokens = budget * len(outs)
    row = dict(n_layers=n_layers, requests=len(outs), new_tokens=tokens,
               wall_s=wall, tokens_per_s=tokens / wall,
               ttft_s=ttfts, ttft_p50_s=ttfts[len(ttfts) // 2],
               ttft_max_s=ttfts[-1], launches=counts,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    results["engine"] = row
    log(f"engine: {len(outs)} requests x {budget} tokens in {wall:.3f}s = "
        f"{row['tokens_per_s']:.1f} tok/s; TTFT p50 "
        f"{row['ttft_p50_s']:.3f}s max {row['ttft_max_s']:.3f}s; "
        f"{counts['prefills']} prefill dispatches, {counts['steps']} decode "
        f"steps; launches flash {counts['flash']} ragged {counts['ragged']}")
    del engine, params
    torch.cuda.empty_cache()
    return counts


def _numel(tree):
    if isinstance(tree, dict):
        for val in tree.values():
            yield from _numel(val)
    else:
        yield tree.numel()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--layers", type=int, default=32,
                        help="engine depth (width is always full)")
    parser.add_argument("--out", default="chiprun_out/chip_smoke.json")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops.cuda import _build
    from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod
    from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod
    from gofr_tpu_torch.tpu import generate

    results = {}
    log("== phase 1: card")
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")
    results["card"] = card

    log("== phase 2: build")
    t0 = time.monotonic()
    _build.build_all()
    build_s = time.monotonic() - t0
    log(f"built {list(_build.KERNELS)} in {build_s:.1f}s")
    results["build_s"] = build_s

    torch.backends.cuda.matmul.allow_tf32 = False
    timer = Timer(torch)
    flash_err = phase_flash(torch, flash_mod, timer, results)
    ragged = phase_ragged(torch, ragged_mod, timer, results)
    del timer
    torch.cuda.empty_cache()
    phase_model(torch, llama, args.seed, results)
    counts = phase_engine(torch, llama, generate, flash_mod, ragged_mod,
                          args.seed, args.layers, results)

    flash_main = next(r for r in results["flash"]
                      if r["B"] == 4 and r["S"] == 512)
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="gofr_tpu_torch/csrc/flash_attention.cu",
             replaces="gofr_tpu/ops/pallas/flash_attention.py:107",
             launches=counts["flash"], max_abs_err=flash_err,
             ms=flash_main["ms"], plain_ms=flash_main["plain_ms"],
             bound_ms=flash_main["bound_ms"],
             bound_by=flash_main["bound_by"],
             library_ms=flash_main["library_ms"]),
        dict(name="ragged_paged_decode_attention", route="cuda",
             source="gofr_tpu_torch/csrc/ragged_paged_attention.cu",
             replaces="gofr_tpu/ops/pallas/ragged_paged_attention.py:315",
             launches=counts["ragged"], max_abs_err=ragged["max_abs_err"],
             ms=ragged["ms"], plain_ms=ragged["plain_ms"],
             bound_ms=ragged["bound_ms"], bound_by=ragged["bound_by"],
             library_ms=None),
    ]
    results["kernels"] = kernels
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
