#!/usr/bin/env python3
"""Whether a suffix prefill over cached prefix pages reproduces a full
prefill's bits on the card (prefix KV reuse, ``gofr_tpu_torch``).

Two probes, on one CUDA device, random weights from a seed:

1. cuBLAS row invariance: for each projection of the ``small`` and
   ``llama3-8b`` presets (in -> out features), a bf16 GEMM of m rows
   against the first m rows of the same 4096-row GEMM, bit for bit; the
   row counts whose bits differ are where cuBLAS splits the sums by row
   count (what ``generate.CUDA_MIN_PREFILL_ROWS`` keeps prefills above).
2. The suffix rows themselves: ``small`` at full width and depth, 8
   prompts of a 256-token system prompt and suffixes of 5-200 tokens.
   A full prefill of all 8 (8 x 512 rows) is the reference; each suffix
   bucket group is then prefilled over the full prefill's system-prompt
   K/V, through the mask form (``prefix_prefill_attention``, the JAX
   reference's route) and through the flash kernel over zero queries
   (the port's route with ``use_flash``), at the engine's row minimum
   and at the bare group size. Per row: logits and suffix K bit-equal to
   the full prefill's, the largest logit difference, the argmax.

Run from the root of a checkout on the GPU host:
``python3 scripts/prefix_identity_probe.py``; the results also go to
``chiprun_out/prefix_identity_probe.json``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SHAPES = {"small": [(1024, 1024), (1024, 2816), (2816, 1024),
                    (1024, 32000)],
          "llama3-8b": [(4096, 4096), (4096, 1024), (4096, 14336),
                        (14336, 4096), (4096, 128256)]}
ROWS = (1, 2, 8, 32, 64, 96, 128, 192, 256, 512, 2048)
SUFFIX_LENS = (5, 17, 40, 64, 100, 129, 170, 200)
GROUPS = (((0, 1), 32), ((2, 3, 4), 128), ((5, 6, 7), 512))


def gemm_rows(torch):
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for preset, shapes in SHAPES.items():
        for k, n in shapes:
            m = 4096 if n < 100_000 else 256     # the head: rows of logits
            x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            w = (torch.randn(k, n, generator=gen, device="cuda")
                 / k ** 0.5).bfloat16()
            full = x @ w
            differ = [rows for rows in ROWS if rows < m
                      and not torch.equal(x[:rows] @ w, full[:rows])]
            out[f"{preset} {k}->{n}"] = differ
            print(f"gemm {preset} {k} -> {n}: rows whose bits differ from "
                  f"the {m}-row GEMM's: {differ}", flush=True)
    return out


def suffix_rows(torch, llama, seed):
    import numpy as np

    from gofr_tpu_torch.tpu.generate import CUDA_MIN_PREFILL_ROWS

    cfg = llama.config("small", use_flash=True)
    params = llama.init(cfg, seed, device="cuda")
    rng = np.random.default_rng(seed + 24)
    system = rng.integers(0, cfg.vocab_size, 256).tolist()
    prompts = [system + rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SUFFIX_LENS]
    tokens = torch.zeros((8, 512), dtype=torch.long, device="cuda")
    for row, prompt in enumerate(prompts):
        tokens[row, :len(prompt)] = torch.tensor(prompt)
    lengths = torch.tensor([len(p) for p in prompts], device="cuda")
    full = llama.init_cache(cfg, 8, 512, device="cuda")
    logits_full, full, _ = llama.prefill(params, cfg, tokens, full,
                                         lengths=lengths)
    out = []
    for route, use_flash in (("mask", False), ("flash", True)):
        c = dataclasses.replace(cfg, use_flash=use_flash)
        for rows, bucket in GROUPS:
            minimum = -(-CUDA_MIN_PREFILL_ROWS // bucket)
            for nb in sorted({max(len(rows), minimum), len(rows)}):
                suf = torch.zeros((nb, bucket), dtype=torch.long,
                                  device="cuda")
                lens = torch.ones((nb,), dtype=torch.long, device="cuda")
                for i, r in enumerate(rows):
                    suf[i, :SUFFIX_LENS[r]] = torch.tensor(prompts[r][256:])
                    lens[i] = SUFFIX_LENS[r]
                prefix = {n: leaf[:, [rows[0]] * nb, :256].contiguous()
                          for n, leaf in full.items()}
                small = llama.init_cache(c, nb, bucket, device="cuda")
                logits, small, _ = llama.prefill(
                    params, c, suf, small, lengths=lens, prefix=prefix,
                    prefix_len=256)
                for i, r in enumerate(rows):
                    n = SUFFIX_LENS[r]
                    row = dict(route=route, bucket=bucket, rows=nb * bucket,
                               request=r,
                               logits_equal=torch.equal(logits[i],
                                                         logits_full[r]),
                               k_equal=torch.equal(
                                   small["k"][:, i, :n],
                                   full["k"][:, r, 256:256 + n]),
                               max_logit_diff=(logits[i] - logits_full[r])
                               .abs().max().item(),
                               argmax_equal=int(logits[i].argmax())
                               == int(logits_full[r].argmax()))
                    out.append(row)
                    print(f"suffix {route} bucket {bucket} rows "
                          f"{nb * bucket} request {r}: logits bit-equal "
                          f"{row['logits_equal']}, suffix K bit-equal "
                          f"{row['k_equal']}, max logit diff "
                          f"{row['max_logit_diff']:.6f}", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("prefix_identity_probe: no CUDA device", file=sys.stderr)
        return 1
    from gofr_tpu_torch.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    results = dict(card=card, torch=torch.__version__,
                   gemm_rows_differ=gemm_rows(torch),
                   suffix=suffix_rows(torch, llama, 2))
    out = Path("chiprun_out/prefix_identity_probe.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
