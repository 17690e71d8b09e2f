#!/usr/bin/env python3
"""How far the ragged, flash-decode and flash-prefill kernels land from
their plain versions over many seeds, beside what a kernel that drops one
position would score: the evidence for the limits ``chip_smoke.py`` holds
them to.

For each seed, at ``chip_smoke.py``'s shapes (phases 3-6: bf16 queries,
32/8 heads, D 128; ragged pools of 8 slots, page 32 and 64 table columns
with every unreferenced row NaN, bf16 or int8 with NaN scales there,
at phase 4's fills and at fills on the cluster's chunk edges;
flash decode over 8 slots of T 2048 with every row past a fill NaN, at
phase 6's fills and at fills on the 256-position chunk edges; causal
flash prefill at S 32, 128, 512 and 2048, B 1 and 4): the ragged decode
launch, the verify launch at G 2, 3 and 5, each over bf16 and over int8
pools, the flash-decode launch and the flash-prefill launch, each
against its plain version. Reported, worst over seeds: max |kernel -
plain|, bf16 ulps of max(|plain|, 2^-8) (``tolerance.ulp_error``) and the
largest per-row relative L2 (``tolerance.row_rel_l2``). Then the same
measures for the plain version run with one position dropped, smallest
over seeds: for the decode-shaped kernels every fill one short (a walk
that skips the last position; slots with a fill > 1), for flash prefill
key S // 2 masked from every query row. Prints one JSON object (also
written to ``--out``).

Run from the root of a checkout on a CUDA host:
``python3 scripts/kernel_tolerance_sweep.py [--seeds 40]``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (FLASH_DECODE_ULPS, FLASH_TOL,  # noqa: E402
                        KV_HEADS, Q_HEADS, RAGGED_ROW_TOL, RAGGED_TOL,
                        card_line, paged_scenario, paged_scenario_int8)

RAGGED_FILLS = {"": [0, 1, 31, 32, 33, 700, 2047, 512],
                # page 32: one page a cluster rank at 256, two at 257-512
                " chunk edges": [0, 1, 255, 256, 257, 511, 513, 2047]}
DECODE_FILLS = {"flash decode": [0, 1, 127, 128, 129, 700, 1500, 2047],
                "flash decode chunk edges": [0, 1, 255, 256, 257, 511,
                                             1792, 2047]}
FLASH_SHAPES = [(b, s) for b in (1, 4) for s in (32, 128, 512, 2048)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=40)
    parser.add_argument("--out",
                        default="chiprun_out/kernel_tolerance_sweep.json")
    args = parser.parse_args()

    import torch

    from gofr_tpu_torch.ops.cuda import _build
    from gofr_tpu_torch.ops import attention as plain_attention
    from gofr_tpu_torch.ops.cuda import decode_attention as decode_mod
    from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod
    from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod
    from gofr_tpu_torch.ops.cuda.tolerance import row_rel_l2, ulp_error

    if not torch.cuda.is_available():
        print("kernel_tolerance_sweep: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all()
    worst, drop = {}, {}

    def note(kind, out, ref):
        row = worst.setdefault(kind, dict(max_abs=0.0, ulps=0.0, row=0.0))
        row["max_abs"] = max(row["max_abs"],
                             (out.float() - ref.float()).abs().max().item())
        row["ulps"] = max(row["ulps"], ulp_error(out, ref))
        row["row"] = max(row["row"], row_rel_l2(out, ref))

    def note_drop(kind, short, ref, fills):
        """The smallest measures over slots whose fill was cut."""
        cut = [i for i, n in enumerate(fills) if n > 1]
        row = drop.setdefault(kind, dict(ulps=float("inf"),
                                         row=float("inf")))
        for i in cut:
            row["ulps"] = min(row["ulps"], ulp_error(short[i], ref[i]))
            row["row"] = min(row["row"], row_rel_l2(short[i:i + 1],
                                                    ref[i:i + 1]))

    def one_short(fills):
        return torch.tensor([max(n - 1, 0) if n > 1 else n for n in fills],
                            dtype=torch.int32, device="cuda")

    for seed in range(args.seeds):
        for int8, g_len, edges in [(i, g, e) for i in (False, True)
                                   for g in (1, 2, 3, 5)
                                   for e in RAGGED_FILLS]:
            fills = [min(n, 2047 - g_len + 1) for n in RAGGED_FILLS[edges]]
            scenario = paged_scenario_int8 if int8 else paged_scenario
            q, kp, vp, table, kn, vn, lens, *scales = scenario(
                torch, fills, g_len, 1000 * g_len + seed)
            pools = "int8 " if int8 else ""
            if g_len == 1:
                call = (q, kp, vp, table, kn[:, 0].contiguous(),
                        vn[:, 0].contiguous())
                kernel = ragged_mod.ragged_paged_decode_attention
                plain = ragged_mod.ragged_paged_decode_attention_plain
                kind = f"ragged {pools}decode{edges}"
            else:
                call = (q, kp, vp, table, kn, vn)
                kernel = ragged_mod.ragged_paged_verify_attention
                plain = ragged_mod.ragged_paged_verify_attention_plain
                kind = f"ragged {pools}verify G{g_len}{edges}"
            ref = plain(*call, lens, *scales)
            note(kind, kernel(*call, lens, *scales), ref)
            note_drop(kind, plain(*call, one_short(fills), *scales), ref,
                      fills)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for kind, fills in DECODE_FILLS.items():
            lens = torch.tensor(fills, dtype=torch.int32, device="cuda")
            dead = (torch.arange(2048, device="cuda")[None, :]
                    >= lens[:, None])[..., None, None]
            k, v = (torch.randn((8, 2048, KV_HEADS, 128), generator=gen,
                                device="cuda").bfloat16()
                    .masked_fill(dead, float("nan")) for _ in range(2))
            q = torch.randn((8, 1, Q_HEADS, 128), generator=gen,
                            device="cuda").bfloat16()
            kn, vn = (torch.randn((8, KV_HEADS, 128), generator=gen,
                                  device="cuda").bfloat16()
                      for _ in range(2))
            call = (q, k, v, kn, vn)
            ref = decode_mod.flash_decode_attention_plain(*call, lens)
            note(kind, decode_mod.flash_decode_attention(*call, lens), ref)
            note_drop(kind, decode_mod.flash_decode_attention_plain(
                *call, one_short(fills)), ref, fills)
        for batch, seq in FLASH_SHAPES:
            q = torch.randn((batch, seq, Q_HEADS, 128), generator=gen,
                            device="cuda").bfloat16()
            k, v = (torch.randn((batch, seq, KV_HEADS, 128), generator=gen,
                                device="cuda").bfloat16() for _ in range(2))
            kind = f"flash prefill B{batch} S{seq}"
            ref = flash_mod.flash_attention_plain(q, k, v)
            note(kind, flash_mod.flash_attention(q, k, v), ref)
            mask = plain_attention.causal_mask(seq, device="cuda")
            mask[:, seq // 2] = False
            short = plain_attention.attention(q, k, v,
                                              mask[None, None, None])
            row = drop.setdefault(kind, dict(max_abs=float("inf")))
            row["max_abs"] = min(row["max_abs"], (short.float() - ref.float())
                                 .abs().max().item())
    result = dict(card=card_line(), seeds=args.seeds, kernel_vs_plain=worst,
                  one_position_dropped=drop,
                  limits=dict(ragged_max_abs=RAGGED_TOL,
                              ragged_row_rel_l2=RAGGED_ROW_TOL,
                              flash_decode_ulps=FLASH_DECODE_ULPS,
                              flash_max_abs=FLASH_TOL))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
