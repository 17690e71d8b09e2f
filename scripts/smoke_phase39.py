#!/usr/bin/env python3
"""Phase 39 of ``chip_smoke.py`` (serving over a device mesh) alone, on
one card, with the unsharded runs it compares against made first:

- ``small`` (``CUT_SMALL_LAYERS`` of its 8 layers, phase 20's weights,
  seed + 2): its dense burst at the example's engine (phase 20's), then
  39c (tp 2, dp 2 x tp 1) and 39f (the pp 2 forward);
- ``llama3-8b`` (``--layers`` of 32, seed): phase 9's paged, phase 15's
  dense and phase 11's paged ``kv_int8`` engines, then 39a-b, the
  per-rank kernels (39d), ring attention (39e), the executor at dp 2
  (39g), the example's ``MESH`` (39h) and the distributed runtime (39i,
  39-multicard).

Run from the root of a checkout: ``python3 scripts/smoke_phase39.py``
(``--only small`` or ``--only llama3`` for one half). Details go to
``chiprun_out/phase39.json``; the card's name and power limit are
printed first.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def small_reference(torch, generate, mods, cfg, params, seed, results):
    """Phase 20's dense burst (the unsharded reference of 39c)."""
    prompts = cs.engine_prompts(cfg, seed)
    samplings = [generate.Sampling() for _ in range(7)] + [
        generate.Sampling(temperature=0.8, top_p=0.95, seed=seed)]
    engine = generate.GenerationEngine(cfg, params, device="cuda",
                                       **cs.SMALL_ENGINE)
    outs, wall, launches, counters, ttfts, figures = cs.serve_burst(
        torch, engine, prompts, 32, samplings, mods, 600, stream_tokens=8)
    cs.check_launches(launches, cs.expected_launches(cfg, counters), "small")
    results["small"] = dict(greedy_outputs=outs[:7], wall_s=wall,
                            tokens_per_s=32 * len(outs) / wall, **figures)
    cs.log(f"small (unsharded reference): {results['small']['tokens_per_s']:.1f}"
           f" tok/s")
    del engine
    torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--layers", type=int, default=8)
    parser.add_argument("--only", choices=("small", "llama3"))
    parser.add_argument("--out", default="chiprun_out/phase39.json")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("smoke_phase39: no CUDA device", file=sys.stderr)
        return 1
    from gofr_tpu_torch.models import llama, resnet
    from gofr_tpu_torch.ops.cuda import _build
    from gofr_tpu_torch.ops.cuda import decode_attention as decode_mod
    from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod
    from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod
    from gofr_tpu_torch.tpu import executor, generate

    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    _build.build_all()
    cs.log(f"built in {time.monotonic() - t0:.1f}s")
    mods = (flash_mod, ragged_mod, decode_mod)
    results = {"card": cs.card_line()}
    by_path = {}
    if args.only in (None, "small"):
        cfg = llama.config("small", use_flash=True,
                           n_layers=cs.CUT_SMALL_LAYERS)
        params = llama.init(cfg, args.seed + 2, device="cuda")
        small_reference(torch, generate, mods, cfg, params, args.seed,
                        results)
        by_path.update(cs.phase_mesh_small(torch, llama, generate, mods, cfg,
                                           params, args.seed, results))
        cs.phase_mesh_pp(torch, llama, params, cfg, results)
        del params
        torch.cuda.empty_cache()
    if args.only in (None, "llama3"):
        cfg = llama.config("llama3-8b", n_layers=args.layers, use_flash=True)
        params = llama.init(cfg, args.seed, device="cuda")
        for paged, int8 in ((True, False), (False, False), (True, True)):
            cs.phase_engine(torch, generate, mods,
                            dataclasses.replace(cfg, kv_int8=int8), params,
                            args.seed, results, paged)
        by_path.update(cs.phase_mesh_llama3(torch, llama, generate, mods, cfg,
                                            params, args.seed, results))
        del params
        torch.cuda.empty_cache()
        cs.phase_mesh_kernels(torch, mods, results)
        cs.phase_mesh_ring(torch, llama, results)
        cs.phase_mesh_executor(torch, executor, resnet, args.seed, results)
        cs.phase_mesh_app(torch, results)
        cs.phase_mesh_dist(torch, results)
    results["launches_by_path"] = by_path
    results["total_s"] = time.monotonic() - cs.T0
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1, default=str))
    cs.log(f"phase 39 passed in {results['total_s']:.1f}s")
    print(json.dumps({"ok": True, "phase": 39}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
