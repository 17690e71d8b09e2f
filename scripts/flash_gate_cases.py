#!/usr/bin/env python3
"""The flash-prefill outputs that miss ``chip_smoke.FLASH_TOL`` against the
plain version, over the seeds of ``scripts/kernel_tolerance_sweep.py``,
with the inputs each one depends on, so they can be recomputed off the
card.

The sweep's inputs are re-drawn exactly (the same generator, seeded
per seed, the flash-decode draws consumed first), at its prefill shapes
(causal, bf16, Hq 32 / Hkv 8, D 128; B 1 and 4 at S 32, 128, 512, 2048).
For every element (b, s, h, d) of the bf16 kernel's output farther than
``FLASH_TOL`` from the plain version's, it keeps the kernel's and the
plain version's values and what a causal output row s depends on: q's
row (b, s, h) and the K/V rows 0..s of (b, h's KV head), as bf16 bits.
Written to ``--out`` (``.npz``: arrays ``meta`` (n, 9) int64 = seed, B,
S, b, s, h, d, offset, rows; ``values`` (n, 2) float32 = kernel, plain;
``q`` (n, 128) and ``kv`` (Σ rows, 2, 128) uint16); a JSON summary is
printed. ``tests/test_torch_flash_gate.py`` recomputes them through the
JAX package's Pallas kernel, its oracle and the port's plain version.

Run from the root of a checkout on a CUDA host:
``python3 scripts/flash_gate_cases.py [--seeds 40]``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import FLASH_TOL, KV_HEADS, Q_HEADS, card_line  # noqa: E402
from kernel_tolerance_sweep import DECODE_FILLS, FLASH_SHAPES  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=40)
    parser.add_argument("--out", default="chiprun_out/flash_gate_cases.npz")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("flash_gate_cases: no CUDA device", file=sys.stderr)
        return 1
    from gofr_tpu_torch.ops.cuda import _build
    from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod

    _build.build_all()
    group = Q_HEADS // KV_HEADS
    meta, values, qs, kvs, offset = [], [], [], [], 0
    worst = {}
    for seed in range(args.seeds):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for _ in DECODE_FILLS:             # the sweep's flash-decode draws
            for shape in ((8, 2048, KV_HEADS, 128),) * 2 + (
                    (8, 1, Q_HEADS, 128),) + ((8, KV_HEADS, 128),) * 2:
                torch.randn(shape, generator=gen, device="cuda")
        for batch, seq in FLASH_SHAPES:
            q = torch.randn((batch, seq, Q_HEADS, 128), generator=gen,
                            device="cuda").bfloat16()
            k, v = (torch.randn((batch, seq, KV_HEADS, 128), generator=gen,
                                device="cuda").bfloat16() for _ in range(2))
            out = flash_mod.flash_attention(q, k, v)
            ref = flash_mod.flash_attention_plain(q, k, v)
            diff = (out.float() - ref.float()).abs()
            kind = f"B{batch} S{seq}"
            worst[kind] = max(worst.get(kind, 0.0), diff.max().item())
            for b, s, h, d in (diff > FLASH_TOL).nonzero().tolist():
                meta.append([seed, batch, seq, b, s, h, d, offset, s + 1])
                values.append([out[b, s, h, d].float().item(),
                               ref[b, s, h, d].float().item()])
                qs.append(q[b, s, h].view(torch.int16).cpu().numpy())
                rows = torch.stack([k[b, :s + 1, h // group],
                                    v[b, :s + 1, h // group]], dim=1)
                kvs.append(rows.view(torch.int16).cpu().numpy())
                offset += s + 1
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        out_path, meta=np.array(meta, np.int64).reshape(-1, 9),
        values=np.array(values, np.float32).reshape(-1, 2),
        q=np.array(qs, np.int16).reshape(-1, 128).view(np.uint16),
        kv=(np.concatenate(kvs) if kvs else np.zeros((0, 2, 128), np.int16))
        .view(np.uint16))
    print(json.dumps(dict(card=card_line(), seeds=args.seeds, tol=FLASH_TOL,
                          worst_by_shape=worst, cases=[
                              dict(seed=m[0], B=m[1], S=m[2], b=m[3],
                                   s=m[4], h=m[5], d=m[6], kernel=val[0],
                                   plain=val[1])
                              for m, val in zip(meta, values)])),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
