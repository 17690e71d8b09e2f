#!/usr/bin/env python3
"""Two trees of the port against each other on the engine's burst, in turns.

``port_engine_profile.run_cell`` (8 concurrent requests of 32 new tokens
over prompts of 5..512 tokens, one sampled; an unprofiled burst for
tok/s, TTFT and peak memory, then a profiled one for the device's idle
share) is run for each cell (plain, spec, int8, int8 spec over the paged
pool; ``--dense`` adds the same four over the dense cache and its window
ladder) by one subprocess per tree, that tree's ``gofr_tpu_torch`` first
on its path.
Each pair runs both trees, A first in even pairs and B first in odd
ones. It prints, for each cell and metric, both trees' medians and the
per-pair ratios B / A with their median, min and max, and with
``--dense`` each dense cell's ratios to its paged cell within each
process; everything goes to ``--out``.

    git archive PARENT | tar -x -C build/ab/parent    # and so on
    python3 scripts/engine_ab.py build/ab/parent build/ab/change --pairs 10
    python3 scripts/engine_ab.py --merge OUT1.json OUT2.json  # pool runs

The measurement code is this tree's for both trees; an engine without
``warmup()`` or ``max_inflight_ticks`` (an older tree's) runs without
them. Needs a CUDA device (``--device cpu --preset tiny`` checks the
plumbing of the plain and int8 cells on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# cell: (kv_int8, spec_gamma, dense)
CELLS = {"plain": (False, 0, False), "spec": (False, 4, False),
         "int8": (True, 0, False), "int8_spec": (True, 4, False),
         "dense": (False, 0, True), "dense_spec": (False, 4, True),
         "dense_int8": (True, 0, True), "dense_int8_spec": (True, 4, True)}
PAGED_CELLS = ("plain", "spec", "int8", "int8_spec")
METRICS = ("tokens_per_s", "ttft_p50_s", "ttft_max_s", "device_idle_share",
           "device_busy_s", "peak_mem_gb", "warmup_s", "warmup_mem_gb")
MARK = "ENGINE_AB_RESULT "


def worker(args) -> int:
    tree = Path(args.worker).resolve()
    sys.path.insert(0, str(tree))
    import torch

    import gofr_tpu_torch
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops.cuda import _build
    from gofr_tpu_torch.tpu import generate

    if not Path(gofr_tpu_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"gofr_tpu_torch came from "
                           f"{gofr_tpu_torch.__file__}, not {tree}")
    # this tree's measurement code; the package stays the tree's
    import port_engine_profile as profile_mod
    from chip_smoke import card_line

    cuda = args.device == "cuda"
    if cuda:
        _build.build_all()
    over = {} if args.preset == "llama3-8b" else dict(max_seq_len=2048)
    cfg = llama.config(args.preset, n_layers=args.layers, use_flash=True,
                       **over)
    params = llama.init(cfg, args.seed, device=args.device)
    cells = {}
    for name in args.cells.split(","):
        int8, gamma, dense = CELLS[name]
        ccfg = dataclasses.replace(cfg, kv_int8=int8)
        engine = profile_mod.make_engine(
            generate, llama, ccfg, params, gamma, device=args.device,
            dense=dense, max_inflight_ticks=args.max_inflight_ticks)
        cells[name] = profile_mod.run_cell(
            torch, generate, engine, cfg.vocab_size, args.seed,
            profile=cuda)
        # collect the cell's garbage now, not inside the next cell's burst:
        # a profiled burst leaves cyclic garbage that is slow to collect
        del engine
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    print(MARK + json.dumps({
        "tree": str(tree), "card": card_line() if cuda else "cpu",
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "cells": cells}), flush=True)
    return 0


def run_worker(tree: str, args) -> dict:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", tree,
           "--cells", args.cells, "--layers", str(args.layers), "--seed",
           str(args.seed), "--device", args.device, "--preset", args.preset,
           "--max-inflight-ticks", str(args.max_inflight_ticks)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=args.timeout)
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith(MARK)]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"worker for {tree} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-8000:]}")
    out = json.loads(lines[-1][len(MARK):])
    out["process_s"] = time.monotonic() - t0
    return out


def summarize(runs, cells):
    """Per cell and metric: each tree's median and the per-pair ratios
    B / A with their median, min and max."""
    table = {}
    for cell in cells:
        rows = {}
        for metric in METRICS:
            a = [pair["A"]["cells"][cell].get(metric) for pair in runs]
            b = [pair["B"]["cells"][cell].get(metric) for pair in runs]
            if any(x is None for x in a + b):
                continue
            ratios = [y / x for x, y in zip(a, b) if x]
            rows[metric] = dict(
                a_median=statistics.median(a), b_median=statistics.median(b),
                a_min=min(a), a_max=max(a), b_min=min(b), b_max=max(b),
                ratios=ratios,
                ratio_median=statistics.median(ratios) if ratios else None,
                ratio_min=min(ratios) if ratios else None,
                ratio_max=max(ratios) if ratios else None)
        table[cell] = rows
    return table


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="*", help="tree A, tree B")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--cells", default=",".join(PAGED_CELLS))
    parser.add_argument("--dense", action="store_true",
                        help="add the dense-cache cells (dense, dense_spec, "
                             "dense_int8, dense_int8_spec) to --cells")
    parser.add_argument("--layers", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-inflight-ticks", type=int, default=2,
                        help="passed to engines that take it")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--preset", default="llama3-8b")
    parser.add_argument("--timeout", type=float, default=600.0,
                        help="seconds a worker may take")
    parser.add_argument("--out", default="chiprun_out/engine_ab.json")
    parser.add_argument("--merge", nargs="+", metavar="JSON",
                        help="summarize the pairs of earlier --out files "
                             "of the same two trees together")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        return worker(args)
    if args.merge:
        runs = [pair for path in args.merge
                for pair in json.loads(Path(path).read_text())["runs"]]
        cells = list(runs[0]["A"]["cells"])
        return report(runs, cells, [runs[0]["A"]["tree"],
                                    runs[0]["B"]["tree"]], args.out)
    if len(args.trees) != 2:
        parser.error("give two trees")
    if args.dense:
        args.cells = ",".join([args.cells] + [name for name in CELLS
                                              if name.startswith("dense")])
    cells = args.cells.split(",")
    tree_a, tree_b = args.trees
    runs = []
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for i in range(args.pairs):
        order = (("A", tree_a), ("B", tree_b))
        if i % 2:
            order = order[::-1]
        pair = {"first": order[0][0]}
        for label, tree in order:
            pair[label] = run_worker(tree, args)
            first = pair[label]["cells"][cells[0]]
            print(f"pair {i} {label} ({tree}): {cells[0]} "
                  f"{first['tokens_per_s']:.2f} tok/s in "
                  f"{pair[label]['process_s']:.1f}s", flush=True)
        runs.append(pair)
        out.write_text(json.dumps(dict(trees=[tree_a, tree_b], runs=runs),
                                  indent=1))
    return report(runs, cells, [tree_a, tree_b], args.out)


def dense_vs_paged(runs, cells):
    """Per dense cell whose paged cell also ran: the ratios dense / paged
    of each metric within each worker process (both trees, every pair),
    with their median, min and max."""
    table = {}
    for cell in cells:
        paged = cell[len("dense_"):] if cell != "dense" else "plain"
        if not cell.startswith("dense") or paged not in cells:
            continue
        rows = {}
        for metric in METRICS:
            ratios = [run["cells"][cell][metric] / run["cells"][paged][metric]
                      for pair in runs for run in (pair["A"], pair["B"])
                      if run["cells"][cell].get(metric)
                      and run["cells"][paged].get(metric)]
            if ratios:
                rows[metric] = dict(ratios=ratios,
                                    median=statistics.median(ratios),
                                    min=min(ratios), max=max(ratios))
        table[cell] = rows
    return table


def report(runs, cells, trees, out_path) -> int:
    """Print and write the summary of ``runs``."""
    table = summarize(runs, cells)
    versus = dense_vs_paged(runs, cells)
    for cell, rows in table.items():
        for metric, row in rows.items():
            print(f"{cell:9s} {metric:18s} A {row['a_median']:.6g} "
                  f"[{row['a_min']:.6g}, {row['a_max']:.6g}]  B "
                  f"{row['b_median']:.6g} [{row['b_min']:.6g}, "
                  f"{row['b_max']:.6g}]  B/A median "
                  f"{row['ratio_median']:.4f} [{row['ratio_min']:.4f}, "
                  f"{row['ratio_max']:.4f}]", flush=True)
    for cell, rows in versus.items():
        for metric, row in rows.items():
            print(f"{cell} / paged {metric:18s} median {row['median']:.4f} "
                  f"[{row['min']:.4f}, {row['max']:.4f}] over "
                  f"{len(row['ratios'])} processes", flush=True)
    result = dict(trees=trees, pairs=len(runs), card=runs[0]["A"]["card"],
                  summary=table, dense_vs_paged=versus, runs=runs)
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(dict(card=result["card"], summary={
        cell: {m: dict(a=r["a_median"], b=r["b_median"],
                       ratio=r["ratio_median"], lo=r["ratio_min"],
                       hi=r["ratio_max"]) for m, r in rows.items()}
        for cell, rows in table.items()})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
