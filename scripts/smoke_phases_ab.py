#!/usr/bin/env python3
"""Two trees of the port in turns on ``chip_smoke.py``'s phase 20, phase
15 and phase 9 engines: the path an earlier slice served, before and
after a change.

- phase 20: ``small`` at full width and depth (random weights from
  ``--seed`` + 2) at the example app's engine (dense, max_len 1024, 8
  slots, 16 steps a tick, 4 in flight);
- phase 15: ``llama3-8b``, 32 layers (``--layers``), dense, max_len
  2048, buckets 32/128/512, 4 steps a tick, 2 in flight (weights from
  ``--seed``);
- phase 9: the same weights and settings, paged (page 32).

Each serves phase 9's burst (8 requests of 32 new tokens over prompts of
5..512 tokens, one sampled) through ``chip_smoke.serve_burst`` (every
prompt count warmed, every tick and prefill a replay, then the burst
again under ``torch.profiler`` for the device's idle share). The
measuring code is this tree's ``chip_smoke.py`` for both trees; the
package is the tree's. One subprocess per tree and turn, in the order
A B B A (``--turns`` 4); prints each run's tok/s, TTFT p50 and max and
idle share, warmup seconds and capture figures (``CAPTURE_FIGURES``), and
writes them to ``--out``.

    git archive PARENT | tar -x -C build/ab/parent
    python3 scripts/smoke_phases_ab.py build/ab/parent build/ab/change
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MARK = "SMOKE_PHASES_AB "
# the warmup's capture figures ``chip_smoke.serve_burst`` reports: seconds
# in tick and prefill captures, the reserved bytes the tick and prefill
# captures added, and the reserved bytes after the warmup
CAPTURE_FIGURES = ("capture_s", "prefill_capture_s", "tick_capture_bytes",
                   "prefill_capture_bytes", "reserved_after_warmup")


def worker(args) -> int:
    tree = Path(args.worker).resolve()
    sys.path.insert(0, str(tree))
    import torch

    import gofr_tpu_torch
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops.cuda import _build
    from gofr_tpu_torch.ops.cuda import decode_attention as decode_mod
    from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod
    from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod
    from gofr_tpu_torch.tpu import generate

    if not Path(gofr_tpu_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"gofr_tpu_torch came from "
                           f"{gofr_tpu_torch.__file__}, not {tree}")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    t0 = time.monotonic()
    _build.build_all()
    build_s = time.monotonic() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    mods = (flash_mod, ragged_mod, decode_mod)
    cells = {}
    llama3 = dict(max_slots=8, max_len=2048, prompt_buckets=(32, 128, 512),
                  steps_per_tick=4)
    params = None
    for name, preset, seed, engine_kw in (
            ("phase20_small", "small", args.seed + 2, smoke.SMALL_ENGINE),
            ("phase15_llama3", "llama3-8b", args.seed, llama3),
            ("phase9_llama3", "llama3-8b", args.seed,
             dict(llama3, paged_kv=True, kv_page=32))):
        over = {"n_layers": args.layers} if preset == "llama3-8b" else {}
        cfg = llama.config(preset, use_flash=True, **over)
        if name != "phase9_llama3":     # phase 9 takes phase 15's weights
            params = llama.init(cfg, seed, device="cuda")
        engine = generate.GenerationEngine(cfg, params, device="cuda",
                                           **engine_kw)
        prompts = smoke.engine_prompts(cfg, args.seed)
        budget = 32
        samplings = [generate.Sampling() for _ in range(7)] + [
            generate.Sampling(temperature=0.8, top_p=0.95, seed=args.seed)]
        outs, wall, launches, counters, ttfts, figures = smoke.serve_burst(
            torch, engine, prompts, budget, samplings, mods, 900,
            profile=True)
        cells[name] = dict(
            tokens_per_s=budget * len(outs) / wall,
            ttft_p50_s=ttfts[len(ttfts) // 2], ttft_max_s=ttfts[-1],
            device_idle_share=figures["device_idle_share"],
            warmup_s=figures["warmup_s"], launches=launches,
            **{key: figures[key] for key in CAPTURE_FIGURES},
            greedy_outputs=outs[:7])
        print(f"{tree.name} {name}: {cells[name]['tokens_per_s']:.1f} tok/s, "
              f"TTFT p50 {cells[name]['ttft_p50_s']:.4f}s max "
              f"{cells[name]['ttft_max_s']:.4f}s, idle "
              f"{cells[name]['device_idle_share']:.4f}", flush=True)
        del engine
        torch.cuda.empty_cache()
    print(MARK + json.dumps(dict(tree=str(tree), card=smoke.card_line(),
                                 build_s=build_s, cells=cells)), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="*", help="tree A, tree B")
    parser.add_argument("--turns", type=int, default=4)
    parser.add_argument("--layers", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--timeout", type=float, default=900.0)
    parser.add_argument("--out", default="chiprun_out/smoke_phases_ab.json")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        return worker(args)
    if len(args.trees) != 2:
        parser.error("give two trees")
    order = "ABBA" * ((args.turns + 3) // 4)
    runs = []
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for label in order[:args.turns]:
        tree = args.trees[0 if label == "A" else 1]
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker", tree,
             "--layers", str(args.layers), "--seed", str(args.seed)],
            capture_output=True, text=True, timeout=args.timeout)
        lines = [line for line in proc.stdout.splitlines()
                 if line.startswith(MARK)]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"worker for {tree} failed (exit "
                               f"{proc.returncode}):\n{proc.stdout[-4000:]}"
                               f"\n{proc.stderr[-8000:]}")
        run = json.loads(lines[-1][len(MARK):])
        run.update(label=label, process_s=time.monotonic() - t0)
        runs.append(run)
        for name, cell in run["cells"].items():
            print(f"{label} {name}: {cell['tokens_per_s']:.1f} tok/s, TTFT "
                  f"p50 {cell['ttft_p50_s']:.4f}s max "
                  f"{cell['ttft_max_s']:.4f}s, idle "
                  f"{cell['device_idle_share']:.4f}; warmup "
                  f"{cell['warmup_s']:.2f}s, "
                  + ", ".join(f"{key} {cell[key]}"
                              for key in CAPTURE_FIGURES)
                  + f" ({run['card']})", flush=True)
        out.write_text(json.dumps(dict(trees=args.trees, runs=runs),
                                  indent=1))
    for name in runs[0]["cells"]:
        greedy = {run["label"]: run["cells"][name]["greedy_outputs"]
                  for run in runs}
        print(f"{name}: greedy completions equal across trees: "
              f"{greedy['A'] == greedy['B']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
