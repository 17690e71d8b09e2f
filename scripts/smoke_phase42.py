#!/usr/bin/env python3
"""Phase 42 of ``chip_smoke.py`` (the examples at their own defaults)
alone, on one card: ``http_server`` (ResNet-50 ``/classify`` over HTTP
against the app's batcher), ``grpc_server`` (BERT-base over gRPC),
``using_subscriber`` over ``scripts/wire_brokers.py``'s Kafka, the ``cmd``
example in processes of its own, ``websocket_chat`` and the framework
examples. No example path launches a hand-written kernel, so none is
built; their launch counts in the phase are recorded all the same.

Run from the root of a checkout: ``python3 scripts/smoke_phase42.py``
(``--cpu`` rehearses it on the CPU at the tiny presets). Details go to
``chiprun_out/phase42.json``; the card's name and power limit are printed
first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true",
                        help="rehearse on the CPU at the tiny presets")
    parser.add_argument("--out", default="chiprun_out/phase42.json")
    args = parser.parse_args()

    import torch

    results = {}
    mods = None
    if not args.cpu:
        if not torch.cuda.is_available():
            print("smoke_phase42: no CUDA device", file=sys.stderr)
            return 1
        from gofr_tpu_torch.ops.cuda import decode_attention as decode_mod
        from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod
        from gofr_tpu_torch.ops.cuda import (ragged_paged_attention as
                                             ragged_mod)

        print(cs.card_line(), flush=True)
        results["card"] = cs.card_line()
        mods = (flash_mod, ragged_mod, decode_mod)
    cs.phase_examples(torch, args.seed, results,
                      device="cpu" if args.cpu else "cuda", tiny=args.cpu,
                      mods=mods)
    results["total_s"] = time.monotonic() - cs.T0
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1, default=str))
    cs.log(f"phase 42 passed; {results['total_s']:.1f}s in all")
    print(json.dumps({"ok": True, "phase": 42}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
