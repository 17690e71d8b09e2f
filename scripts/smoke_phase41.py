#!/usr/bin/env python3
"""Phase 41 of ``chip_smoke.py`` (the datasources on the card) alone, on
one card: the example app at its defaults with ``PUBSUB_BACKEND=KAFKA``,
sqlite on a file and Redis over RESP2 against ``scripts/wire_brokers.py``'s
in-process servers, its batch lane fed over Kafka beside an HTTP burst,
then a lane over MQTT on the same engine. The kernels are built first.

Run from the root of a checkout: ``python3 scripts/smoke_phase41.py``.
Details go to ``chiprun_out/phase41.json``; the card's name and power
limit are printed first.
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
    parser.add_argument("--out", default="chiprun_out/phase41.json")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("smoke_phase41: no CUDA device", file=sys.stderr)
        return 1
    from gofr_tpu_torch.ops.cuda import _build
    from gofr_tpu_torch.ops.cuda import decode_attention as decode_mod
    from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod
    from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod
    from gofr_tpu_torch.tpu import generate

    print(cs.card_line(), flush=True)
    t0 = time.monotonic()
    _build.build_all()
    cs.log(f"built in {time.monotonic() - t0:.1f}s")
    mods = (flash_mod, ragged_mod, decode_mod)
    results = {"card": cs.card_line()}
    results["launches_by_path"] = cs.phase_lane_wire(
        torch, generate, mods, args.seed, results)
    results["total_s"] = time.monotonic() - cs.T0
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1, default=str))
    cs.log(f"phase 41 passed; {results['total_s']:.1f}s in all")
    print(json.dumps({"ok": True, "phase": 41}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
