#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``gofr_tpu_torch``).

Drives the port's serving paths on one NVIDIA GPU at the full
``llama3-8b`` geometry (random weights from ``--seed``): the paged Llama
``/generate`` engine, with prefill through the hand-written
flash-attention kernel and every decode step through the hand-written
ragged paged attention kernel; the same engine with speculative decode,
whose 4-layer draft decodes through the hand-written flash-decode kernel
and whose target verifies G tokens at once through the ragged kernel's
G > 1 launch; and both again with ``kv_int8`` (int8 KV pool with float32
scale planes), whose decode and verify go through the ragged kernel's
int8 instantiation.
Phases, each of which raises (exit code != 0) on failure:

1. card identity (``nvidia-smi`` name and power limit, torch/CUDA);
2. kernel build (one ``nvcc`` per source, all at once) and its time,
   and how many 8-block clusters of each of the ragged kernel's 16
   instantiations the card keeps resident (verify at G 5);
3. flash kernel (bf16: both products on the tensor cores through wgmma)
   vs its plain version, bf16, Hq 32 / Hkv 8 / D 128, causal, S in
   {32, 128, 512, 2048}, B in {1, 4}; timed beside the plain version and
   ``scaled_dot_product_attention`` (a yardstick only), with its ratio to
   that call and its TFLOP/s;
4. ragged kernel (each slot's pages split across a cluster of 8
   blocks, which serves all of the slot's queries), decode (G = 1), vs its plain version, 8 slots, page 32, 64
   table columns, fills {0, 1, 31, 32, 33, 700, 2047, 512}, then the
   full-card shape (every fill 2047): over bf16 pools with every
   position no live entry references NaN, then over int8 pools (the same
   rows quantised) whose scale planes are NaN at every such position;
   each timed with its bound and GB/s;
5. ragged kernel, verify, vs its plain version on the same layouts, G in
   {2, 3, 5} with fills {0, 1, 31, 32, 33, 700, 2047 - G, 512}, then the
   full-card shape at G 5 (every fill 2042), bf16 then int8, and for each
   pool type the kernel's verify instantiation at G = 1 bit-identical to
   its decode instantiation;
6. flash-decode kernel (positions split across blocks in chunks of 256,
   then a combine) vs its plain version, bf16, 8 slots, T 2048, Hq 32 /
   Hkv 8, fills {0, 1, 127, 128, 129, 700, 1500, 2047}, every row past a
   fill NaN; timed beside ``scaled_dot_product_attention`` with a per-row
   mask (a yardstick only), with its ratio to that call and its GB/s;
7. a 2-layer full-width model: prefill + 4 paged decode steps through the
   kernels on the card (bf16) against the plain path on the CPU (f32),
   with a bf16 pool, then with ``kv_int8``;
8. perfect draft: the 2-layer model as its own draft (the draft through
   flash decode), then the ``kv_int8`` model with the same weights as its
   bf16 draft; each acceptance rate must be at least 0.5;
9. the full 32-layer engine answering 8 concurrent requests (prompts over
   every bucket, 32 new tokens each, one sampled), with the kernels'
   launch counts checked against the engine's prefill dispatches and
   decode steps, then one streamed request. Every engine of phases 9-12
   first captures its ticks as CUDA graphs (``warmup()``, its seconds and
   graph count printed), runs 2 ticks in flight (``max_inflight_ticks``),
   and must replay a graph for every tick of the burst, with 2 ticks in
   flight at some point of it; phase 9 then serves the burst again at
   ``max_inflight_ticks=1`` and its 7 greedy completions must be the
   same tokens;
10. the same engine with speculative decode (γ 4, a draft made of views of
    the target's first 4 layers, embedding and head) on the same 8
    requests, launch counts checked against its prefill dispatches, spec
    ticks, Σ(g + 1) draft steps and plain decode steps;
11. phase 9 with ``kv_int8`` (the same weights): launch counts, and the
    pool's bytes against phase 9's for the same page count;
12. phase 10 with a ``kv_int8`` target and the same bf16 draft;
13. the ragged kernel over identity page tables of a dense cache (the
    dense engine's target route): 8 slots, T 2048, page 32, every window
    rung 128 ... 2048, fills {0, 1, 31, 127, 128, 700, 1500} cut to the
    rung and one inactive row past it (2047), every position past a
    row's reach NaN; decode and verify at G 5, bf16 then int8, held to
    phases 4-5's gates and timed with the bound from the bytes;
14. the flash-decode kernel over window views of a T 2048 cache (the
    full cache's slot stride), rungs 128 ... 1024, against its plain
    version within phase 6's gate, timed;
15-18. the dense-cache engine (``paged_kv=False``, the default; the
    attention-window ladder 128 ... 1024 and the whole cache) in the
    four configurations of phases 9-12, on the same weights and the same
    burst: each captures its startup rungs (``warmup()``), every burst
    tick must replay a graph, the graphs and the burst's ticks are
    counted by rung, the launch counts are checked against its counters,
    one streamed request of 60 new tokens on a 100-token prompt must cross
    rung 128 to 256, and its 7 greedy completions must be the paged
    engine's tokens of the same configuration;
19. one ``{"kernels": [...]}`` line, then the card line, then the last
    line ``{"ok": true, "device": {...}}``.

Every engine burst (phases 9-12, 15-18) is served twice: counted, then
under ``torch.profiler`` for the device's idle share.

Run from the root of a checkout: ``python3 chip_smoke.py``. Details go to
``chiprun_out/chip_smoke.json``. Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor-core rate
FLASH_TOL = 3e-2                 # bf16: see phase 3
# ragged kernel (phases 4, 5), which keeps the plain version's bf16
# roundings: each element within 1.6e-2 (one ulp at |x| <= 2), and each
# output row (every head of one query of one slot) within relative L2
# 2^-8. A flipped rounding of a score or a partial sum is sparse (rows
# measured <= 1.3e-3 on an H100); a walk that drops even one position
# moves a row by >= 1.1e-2 at fills up to 2047.
RAGGED_TOL = 1.6e-2
RAGGED_ROW_TOL = 2.0 ** -8
# flash decode (phase 6) rounds once, at the output, after float32 sums in
# another order: at most one flipped rounding, one bf16 ulp of each
# element (of max(|x|, 2^-8)); one dropped position costs >= 90 ulps
FLASH_DECODE_ULPS = 1.0
MODEL_REL_TOL = 5e-2             # relative L2 logits error, see phase 7
MIN_PERFECT_ACCEPT = 0.5         # a broken verify accepts near 0, phase 8
Q_HEADS, KV_HEADS, HEAD_DIM = 32, 8, 128
SPEC_GAMMA, DRAFT_LAYERS = 4, 4
# int8 / bf16 pool bytes for one page (phase 11): (128 + 4) / 256 per
# K or V row and head
INT8_POOL_RATIO = 2_162_688 / 4_194_304


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
    (a decode layer or a prefill finds its operands cold in the 50 MB L2).
    A spin of about 0.5 ms queued after the flush keeps the card busy while
    the host enqueues the timed call, so the host's launch latency (tens of
    microseconds of Python, more on a loaded host) is not counted as the
    call's time."""

    PAD_CYCLES = 1_000_000

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
            torch.cuda._sleep(self.PAD_CYCLES)
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
                       sdpa_ratio=ms / lib_ms, bound_ms=bound * 1e3,
                       bound_by=("operations" if flops / BF16_FLOP_PER_S
                                 >= nbytes / HBM_BYTES_PER_S else "bytes"),
                       tflops=flops / (ms * 1e-3) / 1e12,
                       gb_per_s=nbytes / (ms * 1e-3) / 1e9)
            rows.append(row)
            log(f"flash B={batch} S={seq:5d} err={err:.3e} "
                f"kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
                f"sdpa={lib_ms:.4f}ms ({row['sdpa_ratio']:.3f}x sdpa) "
                f"bound={row['bound_ms']:.4f}ms "
                f"({row['tflops']:.1f} TFLOP/s, "
                f"{row['gb_per_s']:.1f} GB/s)")
    results["flash"] = rows
    return worst


def paged_scenario(torch, fills, g_len, seed):
    """bf16 pools of 8 KV heads, page 32, 64 table columns, pages of the
    slots scattered over the pool, every position no live entry
    references NaN; q (B,G,Hq,D) and k/v_new (B,G,Hkv,D)."""
    import numpy as np

    batch, page, width = len(fills), 32, 64
    num_pages = batch * width
    rng = np.random.default_rng(seed)
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
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    shape = (num_pages, page, KV_HEADS, HEAD_DIM)
    poison = torch.from_numpy(~live).cuda()[..., None, None]
    k_pages = torch.randn(shape, generator=gen, device="cuda").bfloat16() \
        .masked_fill(poison, float("nan"))
    v_pages = torch.randn(shape, generator=gen, device="cuda").bfloat16() \
        .masked_fill(poison, float("nan"))
    q = torch.randn((batch, g_len, Q_HEADS, HEAD_DIM), generator=gen,
                    device="cuda").bfloat16()
    k_new, v_new = (torch.randn((batch, g_len, KV_HEADS, HEAD_DIM),
                                generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
    return (q, k_pages, v_pages, torch.from_numpy(table).cuda(), k_new,
            v_new, torch.tensor(fills, dtype=torch.int32, device="cuda"))


def paged_scenario_int8(torch, fills, g_len, seed):
    """:func:`paged_scenario`'s layout with int8 pools: its rows
    quantised (``quantize_kv``) and every scale of a position no live
    entry references NaN (the int8 rows there are 0). Returns the
    wrapper's arguments, the two scale planes last."""
    from gofr_tpu_torch.ops.quant import quantize_kv

    q, k_pages, v_pages, table, k_new, v_new, lens = paged_scenario(
        torch, fills, g_len, seed)
    dead = k_pages[..., 0, 0].isnan()[..., None]        # (N, page, 1)
    (k8, ks), (v8, vs) = (quantize_kv(pages.nan_to_num())
                          for pages in (k_pages, v_pages))
    return (q, k8, v8, table, k_new, v_new, lens,
            ks.masked_fill(dead, float("nan")),
            vs.masked_fill(dead, float("nan")))


def paged_cost(fills, g_len, table_size, int8=False):
    """Bytes (each input read once, the output written once) and FLOPs of
    one ragged launch over these fills, G queries per slot; int8 pools
    read one byte an element plus a float32 scale per row and head."""
    batch, row = len(fills), Q_HEADS * HEAD_DIM
    row_bytes = HEAD_DIM + 4 if int8 else HEAD_DIM * 2
    kv_bytes = 2 * sum(fills) * KV_HEADS * row_bytes
    small_bytes = 2 * (2 * batch * g_len * row
                       + 2 * batch * g_len * KV_HEADS * HEAD_DIM) \
        + 4 * (table_size + batch)
    # query g attends the fill plus the new tokens u <= g
    pairs = sum(n + g + 1 for n in fills for g in range(g_len))
    return kv_bytes + small_bytes, 4.0 * pairs * row


def check_ragged(torch, out, ref, what):
    """Hold a ragged kernel output to its plain version (RAGGED_TOL per
    element, RAGGED_ROW_TOL per row). Returns both errors."""
    from gofr_tpu_torch.ops.cuda.tolerance import row_rel_l2

    err = (out.float() - ref.float()).abs().max().item()
    row_err = row_rel_l2(out, ref)
    if not torch.isfinite(ref).all() or not err <= RAGGED_TOL \
            or not row_err <= RAGGED_ROW_TOL:
        raise AssertionError(f"{what}: max|kernel-plain| {err} (bound "
                             f"{RAGGED_TOL}), row relative L2 {row_err} "
                             f"(bound {RAGGED_ROW_TOL})")
    return err, row_err


def _scenario(torch, int8, fills, g_len, seed):
    """The wrapper's arguments over bf16 or int8 pools."""
    if int8:
        return paged_scenario_int8(torch, fills, g_len, seed)
    return paged_scenario(torch, fills, g_len, seed)


def ragged_call(torch, ragged_mod, int8, fills, g_len, seed):
    """The wrapper's arguments over these fills, and the kernel and plain
    entry points that take them: decode at G = 1, verify above."""
    call = list(_scenario(torch, int8, fills, g_len, seed))
    if g_len == 1:
        call[4], call[5] = call[4][:, 0], call[5][:, 0]
        return (call, ragged_mod.ragged_paged_decode_attention,
                ragged_mod.ragged_paged_decode_attention_plain)
    return (call, ragged_mod.ragged_paged_verify_attention,
            ragged_mod.ragged_paged_verify_attention_plain)


def ragged_case(torch, ragged_mod, timer, int8, fills, g_len, seed, what):
    """One ragged launch over these fills: held to its plain version,
    output finite despite the NaN planted wherever no live entry points,
    timed beside the plain version, with its bound and GB/s. Returns the
    row."""
    call, kernel, plain = ragged_call(torch, ragged_mod, int8, fills, g_len,
                                      seed)
    out = kernel(*call)
    torch.cuda.synchronize()
    ref = plain(*call)
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: output is not finite: it read a "
                             "poisoned page")
    err, row_err = check_ragged(torch, out, ref, what)
    ms = timer(lambda: kernel(*call), iters=20)
    plain_ms = timer(lambda: plain(*call), iters=5)
    nbytes, flops = paged_cost(fills, g_len, call[3].numel(), int8)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
    row = dict(G=g_len, B=len(fills), fills=fills, page=32, table_width=64,
               pools="int8" if int8 else "bf16", max_abs_err=err,
               row_rel_l2=row_err, ms=ms, plain_ms=plain_ms,
               library_ms=None, bound_ms=bound * 1e3,
               bound_by=("operations" if flops / BF16_FLOP_PER_S
                         >= nbytes / HBM_BYTES_PER_S else "bytes"),
               gb_per_s=nbytes / (ms * 1e-3) / 1e9)
    log(f"{what} err={err:.3e} row={row_err:.3e} kernel={ms:.4f}ms "
        f"plain={plain_ms:.4f}ms bound={row['bound_ms']:.4f}ms "
        f"({row['gb_per_s']:.1f} GB/s) library=none")
    return row


# every slot at the engine's longest fill (decode; verify G 5 keeps room
# for its new tokens): the cluster's 8 blocks all busy on every slot
FULL_CARD_FILL = 2047


def phase_ragged(torch, ragged_mod, timer, results, int8=False):
    what = "ragged int8" if int8 else "ragged"
    log(f"== phase 4: ragged_paged_decode_attention kernel vs plain "
        f"({'int8 pools' if int8 else 'bf16'})")
    row = ragged_case(torch, ragged_mod, timer, int8,
                      [0, 1, 31, 32, 33, 700, 2047, 512], 1, 2,
                      f"{what} B=8")
    full = ragged_case(torch, ragged_mod, timer, int8,
                       [FULL_CARD_FILL] * 8, 1, 3, f"{what} full card B=8")
    results["ragged_int8" if int8 else "ragged"] = dict(row,
                                                        full_card=full)
    return row


def phase_verify(torch, ragged_mod, timer, results, int8=False):
    what = "verify int8" if int8 else "verify"
    log(f"== phase 5: ragged_paged_verify_attention kernel vs plain "
        f"({'int8 pools' if int8 else 'bf16'})")
    rows = [ragged_case(torch, ragged_mod, timer, int8,
                        [0, 1, 31, 32, 33, 700, 2047 - g_len, 512], g_len,
                        10 + g_len, f"{what} G={g_len}")
            for g_len in (2, 3, 5)]
    g_full = SPEC_GAMMA + 1
    full = ragged_case(torch, ragged_mod, timer, int8,
                       [FULL_CARD_FILL - g_full] * 8, g_full, 20,
                       f"{what} full card G={g_full}")
    # at G = 1 the verify instantiation (new-token bound MAX_NEW, the
    # causal fold's loops) must give the decode instantiation's bits
    fills = [0, 1, 31, 32, 33, 700, 2047, 512]
    q, k_pages, v_pages, table, k_new, v_new, lens, *scales = _scenario(
        torch, int8, fills, 1, 2)
    verify = ragged_mod.ragged_paged_verify_form_attention(
        q, k_pages, v_pages, table, k_new, v_new, lens, *scales)
    decode = ragged_mod.ragged_paged_decode_attention(
        q, k_pages, v_pages, table, k_new[:, 0].contiguous(),
        v_new[:, 0].contiguous(), lens, *scales)
    torch.cuda.synchronize()
    if not torch.equal(verify.view(torch.int16), decode.view(torch.int16)):
        raise AssertionError(f"{what}: the verify instantiation at G=1 is "
                             "not bit-identical to the decode "
                             "instantiation")
    log(f"{what}: verify instantiation at G=1 is bit-identical to the "
        f"decode instantiation")
    results["verify_int8" if int8 else "verify"] = dict(
        rows=rows, full_card=full, g1_bit_identical=True)
    return rows


def phase_flash_decode(torch, decode_mod, timer, results):
    import torch.nn.functional as F

    from gofr_tpu_torch.ops.cuda.tolerance import ulp_error

    log("== phase 6: flash_decode_attention kernel vs plain (bf16)")
    fills = [0, 1, 127, 128, 129, 700, 1500, 2047]
    batch, t_max = len(fills), 2048
    gen = torch.Generator(device="cuda").manual_seed(4)
    shape = (batch, t_max, KV_HEADS, HEAD_DIM)
    lens = torch.tensor(fills, dtype=torch.int32, device="cuda")
    dead = (torch.arange(t_max, device="cuda")[None, :]
            >= lens[:, None])[..., None, None]
    k_cache, v_cache = (torch.randn(shape, generator=gen, device="cuda")
                        .bfloat16().masked_fill(dead, float("nan"))
                        for _ in range(2))
    q = torch.randn((batch, 1, Q_HEADS, HEAD_DIM), generator=gen,
                    device="cuda").bfloat16()
    k_new, v_new = (torch.randn((batch, KV_HEADS, HEAD_DIM), generator=gen,
                                device="cuda").bfloat16() for _ in range(2))
    args = (q, k_cache, v_cache, k_new, v_new, lens)
    out = decode_mod.flash_decode_attention(*args)
    torch.cuda.synchronize()
    ref = decode_mod.flash_decode_attention_plain(*args)
    err = (out.float() - ref.float()).abs().max().item()
    ulps = ulp_error(out, ref)
    if not torch.isfinite(out).all():
        raise AssertionError("flash decode output is not finite: it read a "
                             "row past the fill")
    if not torch.isfinite(ref).all() or not ulps <= FLASH_DECODE_ULPS:
        raise AssertionError(f"flash decode: kernel-plain {ulps} bf16 ulps "
                             f"> {FLASH_DECODE_ULPS} (max abs {err})")
    ms = timer(lambda: decode_mod.flash_decode_attention(*args), iters=20)
    plain_ms = timer(lambda: decode_mod.flash_decode_attention_plain(*args),
                     iters=3)
    # the yardstick: one SDPA call over the cache plus the new token, GQA,
    # with a per-row mask (inputs laid out for it outside the timing)
    k_all = torch.cat([k_cache.nan_to_num(), k_new[:, None]], 1) \
        .transpose(1, 2).contiguous()
    v_all = torch.cat([v_cache.nan_to_num(), v_new[:, None]], 1) \
        .transpose(1, 2).contiguous()
    q_t = q.transpose(1, 2).contiguous()
    pos = torch.arange(t_max + 1, device="cuda")[None, :]
    mask = ((pos < lens[:, None]) | (pos == t_max))[:, None, None, :]
    lib_out = F.scaled_dot_product_attention(q_t, k_all, v_all,
                                             attn_mask=mask, enable_gqa=True)
    lib_err = (lib_out.transpose(1, 2).float() - ref.float()).abs().max()
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        q_t, k_all, v_all, attn_mask=mask, enable_gqa=True), iters=20)
    live = sum(fills)
    nbytes = 2 * live * KV_HEADS * HEAD_DIM * 2 \
        + 2 * (2 * q.numel() + k_new.numel() + v_new.numel()) + 4 * batch
    flops = 4.0 * (live + batch) * Q_HEADS * HEAD_DIM
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
    row = dict(B=batch, T=t_max, fills=fills, max_abs_err=err,
               max_ulps=ulps, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               sdpa_ratio=ms / lib_ms,
               library_max_abs_err=lib_err.item(), bound_ms=bound * 1e3,
               bound_by="bytes", gb_per_s=nbytes / (ms * 1e-3) / 1e9)
    results["flash_decode"] = row
    log(f"flash decode B={batch} T={t_max} err={err:.3e} ({ulps} ulps) "
        f"kernel={ms:.4f}ms plain={plain_ms:.4f}ms sdpa={lib_ms:.4f}ms "
        f"({row['sdpa_ratio']:.3f}x sdpa; sdpa vs plain "
        f"{row['library_max_abs_err']:.3e}) "
        f"bound={row['bound_ms']:.4f}ms ({row['gb_per_s']:.1f} GB/s)")
    return row


DENSE_T = 2048
DENSE_FILLS = [0, 1, 31, 127, 128, 700, 1500, 2047]


def dense_scenario(torch, llama, int8, rung, g_len, seed):
    """The ragged wrappers' arguments over a dense cache (8 slots, T
    2048, 8 KV heads) viewed as pages of 32 in slot order and the
    identity table of ``rung``: fills ``DENSE_FILLS`` cut to the rung with
    room for G new tokens, the last row (2047) an inactive one past the
    rung; every position past a row's reach (its fill, within the rung)
    NaN, in the int8 scale planes too. Returns (args, the fills the
    kernel reads)."""
    from gofr_tpu_torch.ops.quant import quantize_kv

    b, page, top = len(DENSE_FILLS), 32, rung or DENSE_T
    fills = [min(n, top - g_len) for n in DENSE_FILLS[:-1]] \
        + [DENSE_FILLS[-1]]
    reach = [min(n, top) for n in fills]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, DENSE_T, KV_HEADS, HEAD_DIM)
    k, v = (torch.randn(shape, generator=gen, device="cuda")
            for _ in range(2))
    q = torch.randn((b, g_len, Q_HEADS, HEAD_DIM), generator=gen,
                    device="cuda").bfloat16()
    k_new, v_new = (torch.randn((b, g_len, KV_HEADS, HEAD_DIM),
                                generator=gen, device="cuda").bfloat16()
                    for _ in range(2))
    dead = (torch.arange(DENSE_T, device="cuda")[None, :]
            >= torch.tensor(reach, device="cuda")[:, None])
    if int8:
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        pools = [k8, v8, ks.masked_fill(dead[..., None], float("nan")),
                 vs.masked_fill(dead[..., None], float("nan"))]
    else:
        pools = [x.bfloat16().masked_fill(dead[..., None, None], float("nan"))
                 for x in (k, v)]
    pools = [x.view(-1, page, *x.shape[2:]) for x in pools]
    table = llama.identity_table(b, DENSE_T, rung, device="cuda")
    lens = torch.tensor(fills, dtype=torch.int32, device="cuda")
    if g_len == 1:
        k_new, v_new = k_new[:, 0], v_new[:, 0]
    return [q, pools[0], pools[1], table, k_new, v_new, lens] + pools[2:], \
        reach


def phase_identity_ragged(torch, ragged_mod, timer, results):
    from gofr_tpu_torch.models import llama

    log("== phase 13: ragged kernel over identity tables of a dense cache "
        "(8 slots, T 2048, page 32), every window rung, decode and verify "
        "G 5, bf16 then int8")
    rows = []
    for int8 in (False, True):
        for g_len in (1, SPEC_GAMMA + 1):
            kernel, plain = (
                (ragged_mod.ragged_paged_decode_attention,
                 ragged_mod.ragged_paged_decode_attention_plain)
                if g_len == 1 else
                (ragged_mod.ragged_paged_verify_attention,
                 ragged_mod.ragged_paged_verify_attention_plain))
            for rung in (128, 256, 512, 1024, None):
                what = (f"identity {'int8' if int8 else 'bf16'} "
                        f"{'decode' if g_len == 1 else f'verify G={g_len}'} "
                        f"rung {rung or DENSE_T}")
                args, reach = dense_scenario(torch, llama, int8, rung, g_len,
                                             30 + g_len)
                out = kernel(*args)
                torch.cuda.synchronize()
                ref = plain(*args)
                if not torch.isfinite(out).all():
                    raise AssertionError(f"{what}: output is not finite: it "
                                         f"read past a row's reach")
                err, row_err = check_ragged(torch, out, ref, what)
                ms = timer(lambda: kernel(*args), iters=20)
                plain_ms = timer(lambda: plain(*args), iters=3)
                nbytes, flops = paged_cost(reach, g_len, args[3].numel(),
                                           int8)
                bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
                row = dict(rung=rung or DENSE_T, G=g_len, fills=reach,
                           pools="int8" if int8 else "bf16",
                           max_abs_err=err, row_rel_l2=row_err, ms=ms,
                           plain_ms=plain_ms, bound_ms=bound * 1e3,
                           bound_by=("operations" if flops / BF16_FLOP_PER_S
                                     >= nbytes / HBM_BYTES_PER_S
                                     else "bytes"),
                           gb_per_s=nbytes / (ms * 1e-3) / 1e9)
                rows.append(row)
                log(f"{what} err={err:.3e} row={row_err:.3e} "
                    f"kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
                    f"bound={row['bound_ms']:.4f}ms "
                    f"({row['gb_per_s']:.1f} GB/s)")
    results["identity_ragged"] = rows


def phase_window_flash_decode(torch, decode_mod, timer, results):
    from gofr_tpu_torch.ops.cuda.tolerance import ulp_error

    log("== phase 14: flash_decode_attention kernel over window views of a "
        "T 2048 cache vs plain")
    gen = torch.Generator(device="cuda").manual_seed(14)
    b = len(DENSE_FILLS)
    shape = (b, DENSE_T, KV_HEADS, HEAD_DIM)
    k_cache, v_cache = (torch.randn(shape, generator=gen, device="cuda")
                        .bfloat16() for _ in range(2))
    q = torch.randn((b, 1, Q_HEADS, HEAD_DIM), generator=gen,
                    device="cuda").bfloat16()
    k_new, v_new = (torch.randn((b, KV_HEADS, HEAD_DIM), generator=gen,
                                device="cuda").bfloat16() for _ in range(2))
    rows = []
    for rung in (128, 256, 512, 1024):
        fills = [min(n, rung - 1) for n in DENSE_FILLS[:-1]] \
            + [DENSE_FILLS[-1]]
        lens = torch.tensor(fills, dtype=torch.int32, device="cuda")
        reach = torch.clamp(lens, max=rung)
        dead = (torch.arange(DENSE_T, device="cuda")[None, :]
                >= reach[:, None])[..., None, None]
        kc, vc = (x.masked_fill(dead, float("nan")) for x in (k_cache,
                                                              v_cache))
        args = (q, kc[:, :rung], vc[:, :rung], k_new, v_new, lens)
        out = decode_mod.flash_decode_attention(*args)
        torch.cuda.synchronize()
        ref = decode_mod.flash_decode_attention_plain(*args)
        err = (out.float() - ref.float()).abs().max().item()
        ulps = ulp_error(out, ref)
        if not torch.isfinite(out).all() or not torch.isfinite(ref).all() \
                or not ulps <= FLASH_DECODE_ULPS:
            raise AssertionError(f"flash decode window {rung}: kernel-plain "
                                 f"{ulps} bf16 ulps > {FLASH_DECODE_ULPS} "
                                 f"(max abs {err}), or not finite")
        ms = timer(lambda: decode_mod.flash_decode_attention(*args),
                   iters=20)
        plain_ms = timer(lambda: decode_mod.flash_decode_attention_plain(
            *args), iters=3)
        live = int(reach.sum())
        nbytes = 2 * live * KV_HEADS * HEAD_DIM * 2 \
            + 2 * (2 * q.numel() + k_new.numel() + v_new.numel()) + 4 * b
        row = dict(rung=rung, fills=reach.tolist(), max_abs_err=err,
                   max_ulps=ulps, ms=ms, plain_ms=plain_ms,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                   gb_per_s=nbytes / (ms * 1e-3) / 1e9)
        rows.append(row)
        log(f"flash decode window {rung}: err={err:.3e} ({ulps} ulps) "
            f"kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
            f"bound={row['bound_ms']:.4f}ms ({row['gb_per_s']:.1f} GB/s)")
    results["window_flash_decode"] = rows


def phase_model(torch, llama, seed, results):
    import numpy as np

    from gofr_tpu_torch.tpu.page_pool import PagePool

    log("== phase 7: 2-layer llama3-8b width, kernels (card, bf16) vs "
        "plain (CPU, f32), bf16 pool then kv_int8")
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
        pool = PagePool(c, page=page, num_pages=num_pages,
                        device=dev).leaves
        for name in pool:
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

    for int8 in (False, True):
        c, rc = (dataclasses.replace(x, kv_int8=int8)
                 for x in (cfg, ref_cfg))
        # the CPU reference picks the greedy tokens; the card is fed the
        # same
        feed = []
        ref_out = run(rc, ref_params, "cpu", feed)
        card_out = run(c, params, "cuda", feed)
        rel, agree, total = [], 0, 0
        for ref, got in zip(ref_out, card_out):
            if not torch.isfinite(got).all():
                raise AssertionError("model check: non-finite card logits")
            rel.append(((got - ref).norm() / ref.norm()).item())
            agree += int((got.argmax(-1) == ref.argmax(-1)).sum())
            total += ref.shape[0]
        worst = max(rel)
        what = "model kv_int8" if int8 else "model"
        log(f"{what}: relative L2 logits error per step "
            f"{[round(r, 5) for r in rel]} (bound {MODEL_REL_TOL}); "
            f"top-1 agreement {agree}/{total}")
        results["model_check_int8" if int8 else "model_check"] = dict(
            rel_l2=rel, top1_agree=agree, top1_total=total,
            bound=MODEL_REL_TOL)
        if worst > MODEL_REL_TOL:
            raise AssertionError(f"{what} check: relative error {worst} > "
                                 f"{MODEL_REL_TOL}")
    del params, ref_params
    torch.cuda.empty_cache()


def device_times(torch, prof):
    """Device seconds and counts by name of every device event (kernels,
    copies, fills) of a profiled run, from the raw trace events (the
    aggregated ``key_averages()`` takes tens of seconds over the ~10^5
    events of an eager burst)."""
    by_kernel, calls = {}, {}
    cuda = torch.autograd.DeviceType.CUDA
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == cuda and evt.duration_ns() > 0:
            name = evt.name()
            by_kernel[name] = by_kernel.get(name, 0.0) \
                + evt.duration_ns() / 1e9
            calls[name] = calls.get(name, 0) + 1
    return by_kernel, calls


# the kernels each served path must launch at least once
PATH_KERNELS = {"engine": ("flash", "ragged"),
                "spec": ("flash", "verify", "flash_decode"),
                "perfect_draft": ("flash", "verify", "flash_decode"),
                "int8_engine": ("flash", "int8"),
                "int8_spec": ("flash", "int8_verify", "flash_decode"),
                "int8_perfect_draft": ("flash", "int8_verify",
                                       "flash_decode"),
                "dense": ("flash", "ragged"),
                "dense_spec": ("flash", "verify", "flash_decode"),
                "dense_int8": ("flash", "int8"),
                "dense_int8_spec": ("flash", "int8_verify", "flash_decode")}


def serve_burst(torch, engine, prompts, budget, samplings, mods, timeout,
                stream_tokens=8, profile=False):
    """Capture the engine's ticks (``warmup()``), warm it up with one
    request, set every kernel's count to 0, serve the burst concurrently
    and read the counts; with ``profile`` serve it again under
    ``torch.profiler`` for the device's idle share; then stream
    ``stream_tokens`` of ``prompts[3]`` alone. Fails unless every tick of
    the burst was a graph replay and 2 ticks were in flight at some point.
    Returns (outputs, wall seconds, launches by kernel, the burst's run
    counters, sorted TTFTs, figures: graphs, idle share, the stream's
    ticks by window rung)."""
    from torch.profiler import ProfilerActivity

    flash_mod, ragged_mod, decode_mod = mods
    # an earlier profiled burst leaves cyclic garbage that is slow to
    # collect: collect it now, not inside this engine's burst
    gc.collect()

    async def serve():
        t0 = time.monotonic()
        await engine.warmup()
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        await engine.start()
        try:
            # warm-up (cuBLAS handles, allocator; a spec engine's spec
            # tick too): not part of the run
            await engine.generate(prompts[0], 8)
            for mod in mods:
                mod.reset_launches()
            before = run_counters(engine)
            rungs = dict(engine.spec_rungs)
            windows0 = dict(engine.window_ticks)
            engine.ttfts.clear()
            torch.cuda.reset_peak_memory_stats()
            inflight = []

            async def watch():
                while True:
                    inflight.append(engine.stats()["ticks_inflight"])
                    await asyncio.sleep(0.0005)

            watcher = asyncio.get_running_loop().create_task(watch())
            start = time.monotonic()
            try:
                outs = await asyncio.wait_for(asyncio.gather(*[
                    engine.generate(p, budget, sampling=s)
                    for p, s in zip(prompts, samplings)]), timeout)
            finally:
                watcher.cancel()
            wall = time.monotonic() - start
            launches = dict(flash=flash_mod.launches,
                            ragged=ragged_mod.launches,
                            verify=ragged_mod.verify_launches,
                            int8=ragged_mod.int8_launches,
                            int8_verify=ragged_mod.int8_verify_launches,
                            flash_decode=decode_mod.launches)
            after = run_counters(engine)
            counters = {key: after[key] - before[key] for key in after}
            counters["ticks_by_gamma"] = {
                g: n - rungs.get(g, 0) for g, n in engine.spec_rungs.items()
                if n > rungs.get(g, 0)}
            counters["ticks_by_window"] = {
                w or engine.max_len: n - windows0.get(w, 0)
                for w, n in engine.window_ticks.items()
                if n > windows0.get(w, 0)}
            ttfts = sorted(engine.ttfts)
            idle = None
            if profile:
                prof = torch.profiler.profile(
                    activities=[ProfilerActivity.CUDA])
                with prof:
                    t1 = time.monotonic()
                    await asyncio.wait_for(asyncio.gather(*[
                        engine.generate(p, budget, sampling=s)
                        for p, s in zip(prompts, samplings)]), timeout)
                    torch.cuda.synchronize()
                    prof_wall = time.monotonic() - t1
                busy = sum(device_times(torch, prof)[0].values())
                idle = dict(device_busy_s=busy, profiled_wall_s=prof_wall,
                            device_idle_share=1.0 - busy / prof_wall)
            windows = dict(engine.window_ticks)
            stream = await engine.generate_stream(prompts[3], stream_tokens)
            streamed = [tok async for tok in stream]
            stream_windows = {w or engine.max_len: n - windows.get(w, 0)
                              for w, n in engine.window_ticks.items()
                              if n > windows.get(w, 0)}
            return (outs, wall, launches, counters, ttfts, streamed,
                    max(inflight), warm_s, idle, stream_windows)
        finally:
            await engine.stop()

    (outs, wall, launches, counters, ttfts, streamed, peak,
     warm_s, idle, stream_windows) = asyncio.run(serve())
    for out in outs:
        if len(out) != budget or not all(0 <= t < engine.cfg.vocab_size
                                         for t in out):
            raise AssertionError(f"bad completion {out}")
    if len(streamed) != stream_tokens:
        raise AssertionError(f"stream returned {len(streamed)} tokens")
    ticks = counters["ticks"] + counters["spec_ticks"]
    if counters["replays"] != ticks or counters["lazy_captures"]:
        raise AssertionError(
            f"{counters['replays']} graph replays for {ticks} ticks, "
            f"{counters['lazy_captures']} captures in the burst: every "
            f"tick must replay a graph warmup() captured")
    want = min(2, engine.max_inflight_ticks)
    if peak < want:
        raise AssertionError(f"at most {peak} ticks were in flight during "
                             f"the burst, expected {want}")
    graphs = engine.stats()["graphs"]
    figures = dict(warmup_s=warm_s, graphs=graphs["captured"],
                   graphs_by_window=graphs["by_window"],
                   capture_s=graphs["capture_s"], ticks_inflight_peak=peak,
                   max_inflight_ticks=engine.max_inflight_ticks,
                   stream_ticks_by_window=stream_windows, **(idle or {}))
    log(f"graphs: {graphs['captured']} captured in "
        f"{graphs['capture_s']:.2f}s (warmup {warm_s:.2f}s; by window "
        f"{graphs['by_window']}), {counters['replays']} replays for "
        f"{ticks} ticks (by window {counters['ticks_by_window']}), "
        f"{peak} ticks in flight at most (max_inflight_ticks "
        f"{engine.max_inflight_ticks})"
        + (f"; device idle share {idle['device_idle_share']:.4f} "
           f"(busy {idle['device_busy_s']:.4f}s of "
           f"{idle['profiled_wall_s']:.4f}s profiled)" if idle else ""))
    return outs, wall, launches, counters, ttfts, figures


def run_counters(engine):
    stats = engine.stats()
    spec = stats.get("speculative", {})
    return dict(prefills=engine.prefill_dispatches,
                steps=engine.decode_steps,
                ticks=engine.ticks,
                spec_ticks=engine.spec_dispatches,
                draft_steps=engine.draft_steps,
                replays=stats["graphs"]["replays"],
                lazy_captures=stats["graphs"]["lazy_captures"],
                proposed=spec.get("proposed", 0),
                accepted=spec.get("accepted", 0))


def acceptance(counters):
    return counters["accepted"] / max(counters["proposed"], 1)


def expected_launches(cfg, counters, draft_layers=0):
    """What each kernel must have launched over a burst of this engine:
    the target's layers per prefill, decode step and spec tick through
    the bf16 or int8 ragged instantiations, the draft's per prefill and
    draft step."""
    n = cfg.n_layers
    int8 = cfg.kv_int8
    decode = n * counters["steps"]
    verify = n * counters["spec_ticks"]
    return dict(flash=(n + draft_layers) * counters["prefills"],
                ragged=0 if int8 else decode,
                verify=0 if int8 else verify,
                int8=decode if int8 else 0,
                int8_verify=verify if int8 else 0,
                flash_decode=draft_layers * counters["draft_steps"])


def check_launches(launches, want, path):
    if launches != want:
        raise AssertionError(f"{path}: launch counts {launches}, expected "
                             f"{want}")
    idle = [name for name in PATH_KERNELS[path] if launches[name] == 0]
    if idle:
        raise AssertionError(f"{path}: kernels {idle} never launched")


def engine_prompts(cfg, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = [5, 30, 64, 100, 128, 300, 480, 512]
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]


def draft_view(llama, cfg, params, n_layers):
    """A bf16 draft made of the target's first ``n_layers`` layers
    (views, no copy) with its embedding, final norm and head; its dense
    cache is bf16 whatever the target's pool."""
    dcfg = llama.config("llama3-8b", n_layers=n_layers, dtype=cfg.dtype,
                        use_flash=True)
    dparams = dict(params, layers={name: w[:n_layers]
                                   for name, w in params["layers"].items()})
    return dcfg, dparams


def phase_perfect_draft(torch, llama, generate, mods, seed, results):
    log("== phase 8: perfect draft (2-layer full-width model as its own "
        "draft), bf16 pool then kv_int8 target")
    cfg = llama.config("llama3-8b", n_layers=2, use_flash=True)
    params = llama.init(cfg, seed + 1, device="cuda")
    dcfg, dparams = draft_view(llama, cfg, params, 2)
    for int8 in (False, True):
        tcfg = dataclasses.replace(cfg, kv_int8=int8)
        path = "int8_perfect_draft" if int8 else "perfect_draft"
        engine = generate.GenerationEngine(
            tcfg, params, max_slots=8, max_len=2048,
            prompt_buckets=(32, 128, 512), paged_kv=True, kv_page=32,
            draft_cfg=dcfg, draft_params=dparams, spec_gamma=SPEC_GAMMA,
            device="cuda")
        prompts = engine_prompts(cfg, seed)[:4]
        budget = 32
        _, _, launches, counters, _, _ = serve_burst(
            torch, engine, prompts, budget, [generate.Sampling()] * 4, mods,
            300)
        spec = engine.stats()["speculative"]
        rate = acceptance(counters)
        check_launches(launches, expected_launches(tcfg, counters, 2), path)
        results[path] = dict(acceptance_rate=rate, spec=spec,
                             launches=launches, counters=counters,
                             bound=MIN_PERFECT_ACCEPT)
        log(f"{path}: acceptance {counters['accepted']}/"
            f"{counters['proposed']} = "
            f"{rate:.4f} (bound >= {MIN_PERFECT_ACCEPT}); ticks by gamma "
            f"{counters['ticks_by_gamma']}; launches {launches}")
        if rate < MIN_PERFECT_ACCEPT:
            raise AssertionError(f"{path} accepted {rate} < "
                                 f"{MIN_PERFECT_ACCEPT}: verify is broken")
        del engine
    del params, dparams
    torch.cuda.empty_cache()


def engine_kind(cfg, paged, spec):
    """(path name, phase number) of an engine phase."""
    int8 = cfg.kv_int8
    if paged:
        return ("int8_" if int8 else "") + ("spec" if spec else "engine"), \
            9 + int(spec) + 2 * int8
    return "dense" + ("_int8" if int8 else "") + ("_spec" if spec else ""), \
        15 + int(spec) + 2 * int8


def check_dense(engine, outs, figures, path, paired, results):
    """A dense engine's checks beyond the paged ones: its 7 greedy
    completions are the paged engine's of the same configuration (the
    same kernel over the same K/V rows), and the streamed request crossed
    rung 128 to 256."""
    same = outs[:7] == results[paired]["greedy_outputs"]
    crossed = {128, 256} <= set(figures["stream_ticks_by_window"])
    log(f"{path}: 7 greedy completions identical to {paired}'s: {same}; "
        f"streamed request's ticks by window "
        f"{figures['stream_ticks_by_window']}")
    if not same:
        raise AssertionError(f"{path}: greedy completions differ from "
                             f"{paired}'s on the same weights")
    if not crossed:
        raise AssertionError(f"{path}: the streamed request did not cross "
                             f"window rung 128 to 256")
    return same


def kv_bytes(engine):
    stats = engine.stats()
    if engine.paged:
        return stats["kv_pool"]["pool_bytes"]
    return stats["kv_cache"]["cache_bytes"]


def phase_engine(torch, generate, mods, cfg, params, seed, results,
                 paged=True):
    int8 = cfg.kv_int8
    n_layers = cfg.n_layers
    path, number = engine_kind(cfg, paged, spec=False)
    log(f"== phase {number}: llama3-8b engine, {n_layers} layers, full "
        f"width, {'paged' if paged else 'dense cache'}"
        f"{', kv_int8' if int8 else ''}")
    prompts = engine_prompts(cfg, seed)
    budget = 32
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]

    def burst(inflight, profile=True):
        engine = generate.GenerationEngine(
            cfg, params, max_slots=8, max_len=2048,
            prompt_buckets=(32, 128, 512), steps_per_tick=4, paged_kv=paged,
            kv_page=32, max_inflight_ticks=inflight, device="cuda")
        got = serve_burst(torch, engine, prompts, budget, samplings, mods,
                          900, stream_tokens=8 if paged else 60,
                          profile=profile)
        check_launches(got[2], expected_launches(cfg, got[3]), path)
        return engine, got

    engine, (outs, wall, launches, counters, ttfts, figures) = burst(2)
    tokens = budget * len(outs)
    row = dict(n_layers=n_layers, kv_int8=int8, paged=paged,
               requests=len(outs), new_tokens=tokens,
               wall_s=wall, tokens_per_s=tokens / wall,
               ttft_s=ttfts, ttft_p50_s=ttfts[len(ttfts) // 2],
               ttft_max_s=ttfts[-1], launches=launches, counters=counters,
               kv_bytes=kv_bytes(engine), greedy_outputs=outs[:7],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               **figures)
    if paged:
        pool = engine.stats()["kv_pool"]
        row.update(num_pages=pool["num_pages"], page_bytes=pool["page_bytes"],
                   pool_bytes=pool["pool_bytes"])
    results[path] = row
    log(f"{path}: {len(outs)} requests x {budget} tokens in {wall:.3f}s = "
        f"{row['tokens_per_s']:.1f} tok/s; TTFT p50 "
        f"{row['ttft_p50_s']:.3f}s max {row['ttft_max_s']:.3f}s; "
        f"{counters['prefills']} prefill dispatches, {counters['steps']} "
        f"decode steps; launches {launches}; "
        f"{'pool' if paged else 'cache'} {row['kv_bytes'] / 1e9:.4f} GB; "
        f"capture {row['capture_s']:.2f}s; peak memory "
        f"{row['peak_mem_gb']:.2f} GB")
    if not paged:
        check_dense(engine, outs, figures, path,
                    engine_kind(cfg, True, spec=False)[0], results)
    del engine
    torch.cuda.empty_cache()
    if paged and not int8:
        # the same burst one tick at a time: the greedy completions must
        # not depend on the pipeline's depth (the decode GEMMs always run
        # every slot's row, so each row's numbers are the same)
        engine, (outs_m1, wall_m1, *_rest) = burst(1, profile=False)
        same = outs_m1[:7] == outs[:7]
        row["m1"] = dict(wall_s=wall_m1, tokens_per_s=tokens / wall_m1,
                         greedy_identical=same)
        log(f"{path} at max_inflight_ticks=1: {tokens / wall_m1:.1f} tok/s; "
            f"7 greedy completions identical to max_inflight_ticks=2: "
            f"{same}")
        if not same:
            raise AssertionError("greedy completions differ between "
                                 "max_inflight_ticks 1 and 2")
        del engine
        torch.cuda.empty_cache()
    if int8:
        bf16 = results[engine_kind(dataclasses.replace(cfg, kv_int8=False),
                                   paged, spec=False)[0]]
        ratio = row["kv_bytes"] / bf16["kv_bytes"]
        row["kv_ratio_to_bf16"] = ratio
        log(f"kv_int8 vs bf16 engine: {row['tokens_per_s']:.1f} vs "
            f"{bf16['tokens_per_s']:.1f} tok/s; TTFT p50 "
            f"{row['ttft_p50_s']:.3f} vs {bf16['ttft_p50_s']:.3f}s; peak "
            f"memory {row['peak_mem_gb']:.2f} vs {bf16['peak_mem_gb']:.2f} "
            f"GB; {'pool' if paged else 'cache'} {row['kv_bytes']} vs "
            f"{bf16['kv_bytes']} bytes = {ratio:.6f}x (expected "
            f"{INT8_POOL_RATIO:.6f})")
        if row.get("num_pages") != bf16.get("num_pages") \
                or abs(ratio - INT8_POOL_RATIO) > 1e-9:
            raise AssertionError(f"int8 KV is {ratio}x the bf16 KV's bytes, "
                                 f"expected {INT8_POOL_RATIO}")
    return launches


def phase_spec_engine(torch, llama, generate, mods, cfg, params, seed,
                      results, paged=True):
    int8 = cfg.kv_int8
    n_layers = cfg.n_layers
    path, number = engine_kind(cfg, paged, spec=True)
    log(f"== phase {number}: llama3-8b speculative engine, {n_layers} "
        f"layers, {'paged' if paged else 'dense cache'}"
        f"{', kv_int8' if int8 else ''}, bf16 draft {DRAFT_LAYERS} layers "
        f"(views of the target's), gamma {SPEC_GAMMA}")
    dcfg, dparams = draft_view(llama, cfg, params, DRAFT_LAYERS)
    engine = generate.GenerationEngine(
        cfg, params, max_slots=8, max_len=2048,
        prompt_buckets=(32, 128, 512), paged_kv=paged, kv_page=32,
        draft_cfg=dcfg, draft_params=dparams, spec_gamma=SPEC_GAMMA,
        max_inflight_ticks=2, device="cuda")
    prompts = engine_prompts(cfg, seed)
    budget = 32
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]
    outs, wall, launches, counters, ttfts, figures = serve_burst(
        torch, engine, prompts, budget, samplings, mods, 900,
        stream_tokens=8 if paged else 60, profile=True)
    check_launches(launches,
                   expected_launches(cfg, counters, DRAFT_LAYERS), path)
    spec = engine.stats()["speculative"]
    tokens = budget * len(outs)
    row = dict(n_layers=n_layers, kv_int8=int8, paged=paged,
               draft_layers=DRAFT_LAYERS, gamma=SPEC_GAMMA,
               requests=len(outs), new_tokens=tokens,
               wall_s=wall, tokens_per_s=tokens / wall, ttft_s=ttfts,
               ttft_p50_s=ttfts[len(ttfts) // 2], ttft_max_s=ttfts[-1],
               launches=launches, counters=counters, speculative=spec,
               kv_bytes=kv_bytes(engine), greedy_outputs=outs[:7],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               **figures)
    results[path + "_engine" if paged else path] = row
    log(f"{path} engine: {len(outs)} requests x {budget} tokens in "
        f"{wall:.3f}s = {row['tokens_per_s']:.1f} tok/s; TTFT p50 "
        f"{row['ttft_p50_s']:.3f}s max {row['ttft_max_s']:.3f}s; "
        f"{counters['spec_ticks']} spec ticks (by gamma "
        f"{counters['ticks_by_gamma']}), {counters['draft_steps']} draft "
        f"steps, "
        f"{counters['steps']} plain decode steps, {counters['prefills']} "
        f"prefill dispatches; proposed {counters['proposed']} accepted "
        f"{counters['accepted']} (rate {acceptance(counters):.4f}); final "
        f"gamma cap {spec['gamma_cap']}; launches {launches}; "
        f"{'pool' if paged else 'cache'} {row['kv_bytes'] / 1e9:.4f} GB; "
        f"capture {row['capture_s']:.2f}s; peak memory "
        f"{row['peak_mem_gb']:.2f} GB")
    if not paged:
        check_dense(engine, outs, figures, path,
                    engine_kind(cfg, True, spec=True)[0] + "_engine",
                    results)
    del engine, dparams
    torch.cuda.empty_cache()
    return launches


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
    from gofr_tpu_torch.ops.cuda import decode_attention as decode_mod
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
    # clusters of 8 blocks each ragged instantiation keeps resident at
    # the engine's table (64 columns of 32 positions), verify at G 5
    occupancy = {
        f"group {group} {'verify' if verify else 'decode'} "
        f"{'int8' if int8 else 'bf16'}":
            ragged_mod.cluster_occupancy(group, verify, int8,
                                         SPEC_GAMMA + 1 if verify else 1)
        for group in ragged_mod.SUPPORTED_GROUPS
        for verify in (False, True) for int8 in (False, True)}
    log(f"ragged kernel clusters resident: {occupancy}")
    results["ragged_cluster_occupancy"] = occupancy

    torch.backends.cuda.matmul.allow_tf32 = False
    timer = Timer(torch)
    flash_err = phase_flash(torch, flash_mod, timer, results)
    ragged = {int8: phase_ragged(torch, ragged_mod, timer, results, int8)
              for int8 in (False, True)}
    verify = {int8: phase_verify(torch, ragged_mod, timer, results, int8)
              for int8 in (False, True)}
    flash_decode = phase_flash_decode(torch, decode_mod, timer, results)
    del timer
    torch.cuda.empty_cache()
    phase_model(torch, llama, args.seed, results)
    mods = (flash_mod, ragged_mod, decode_mod)
    phase_perfect_draft(torch, llama, generate, mods, args.seed, results)

    cfg = llama.config("llama3-8b", n_layers=args.layers, use_flash=True)
    if args.layers != 32:
        log(f"NOTE: depth cut to {args.layers} layers (width unchanged)")
    t0 = time.monotonic()
    params = llama.init(cfg, args.seed, device="cuda")
    torch.cuda.synchronize()
    log(f"random weights ({sum(_numel(params)) / 1e9:.2f} B params) in "
        f"{time.monotonic() - t0:.1f}s")
    # one set of weights serves the eight engines: paged (phases 9-12),
    # then dense (15-18), each bf16 then kv_int8
    by_path = {}
    for paged in (True, False):
        if not paged:
            timer = Timer(torch)
            phase_identity_ragged(torch, ragged_mod, timer, results)
            phase_window_flash_decode(torch, decode_mod, timer, results)
            del timer
            torch.cuda.empty_cache()
        for int8 in (False, True):
            c = dataclasses.replace(cfg, kv_int8=int8)
            by_path[engine_kind(c, paged, False)[0]] = phase_engine(
                torch, generate, mods, c, params, args.seed, results, paged)
            by_path[engine_kind(c, paged, True)[0]] = phase_spec_engine(
                torch, llama, generate, mods, c, params, args.seed, results,
                paged)
    # launches on the main paths: each run counted from 0
    counts = {name: sum(run[name] for run in by_path.values())
              for name in by_path["engine"]}

    flash_main = next(r for r in results["flash"]
                      if r["B"] == 4 and r["S"] == 512)

    def ragged_row(name, int8, launches):
        row = ragged[int8]
        return dict(name=name, route="cuda",
                    source="gofr_tpu_torch/csrc/ragged_paged_attention.cu",
                    replaces="gofr_tpu/ops/pallas/"
                             "ragged_paged_attention.py:315",
                    launches=launches, max_abs_err=row["max_abs_err"],
                    ms=row["ms"], plain_ms=row["plain_ms"],
                    bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                    library_ms=None)

    def verify_row(name, int8, launches):
        rows = verify[int8]
        main_row = next(r for r in rows if r["G"] == SPEC_GAMMA + 1)
        return dict(name=name, route="cuda",
                    source="gofr_tpu_torch/csrc/ragged_paged_attention.cu",
                    replaces="gofr_tpu/ops/pallas/"
                             "ragged_paged_attention.py:315",
                    launches=launches,
                    max_abs_err=max(r["max_abs_err"] for r in rows),
                    ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                    bound_ms=main_row["bound_ms"],
                    bound_by=main_row["bound_by"], library_ms=None)

    kernels = [
        dict(name="flash_attention", route="cuda",
             source="gofr_tpu_torch/csrc/flash_attention.cu",
             replaces="gofr_tpu/ops/pallas/flash_attention.py:107",
             launches=counts["flash"], max_abs_err=flash_err,
             ms=flash_main["ms"], plain_ms=flash_main["plain_ms"],
             bound_ms=flash_main["bound_ms"],
             bound_by=flash_main["bound_by"],
             library_ms=flash_main["library_ms"]),
        ragged_row("ragged_paged_decode_attention", False,
                   counts["ragged"]),
        verify_row("ragged_paged_verify_attention", False,
                   counts["verify"]),
        dict(name="flash_decode_attention", route="cuda",
             source="gofr_tpu_torch/csrc/decode_attention.cu",
             replaces="gofr_tpu/ops/pallas/decode_attention.py:158",
             launches=counts["flash_decode"],
             max_abs_err=flash_decode["max_abs_err"], ms=flash_decode["ms"],
             plain_ms=flash_decode["plain_ms"],
             bound_ms=flash_decode["bound_ms"],
             bound_by=flash_decode["bound_by"],
             library_ms=flash_decode["library_ms"]),
        ragged_row("ragged_paged_decode_attention_int8", True,
                   counts["int8"]),
        verify_row("ragged_paged_verify_attention_int8", True,
                   counts["int8_verify"]),
    ]
    results["kernels"] = kernels
    results["launches_by_path"] = by_path
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
