#!/usr/bin/env python3
"""Phase 40 of ``chip_smoke.py`` (training over a device mesh) alone, on
one card: ``small`` whole over dp 2 x tp 2 x sp 2 (40a) and its
checkpoints (40d), ``llama3-8b``'s width at 2 layers over tp 2 and tp 4
with the eval through the flash kernel (40b), ``moe-small`` over ep 2
and ep 2 x tp 2 (40c), then dp 2 over two cards where the host has two
(40-multicard). The kernels are built first (40b's eval launches the
flash kernel).

Run from the root of a checkout: ``python3 scripts/smoke_phase40.py``.
Details go to ``chiprun_out/phase40.json``; the card's name and power
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
    parser.add_argument("--out", default="chiprun_out/phase40.json")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("smoke_phase40: no CUDA device", file=sys.stderr)
        return 1
    from gofr_tpu_torch.models import llama, moe
    from gofr_tpu_torch.ops.cuda import _build
    from gofr_tpu_torch.ops.cuda import decode_attention as decode_mod
    from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod
    from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod
    from gofr_tpu_torch.parallel import train
    from gofr_tpu_torch.utils import checkpoint

    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    _build.build_all()
    cs.log(f"built in {time.monotonic() - t0:.1f}s")
    mods = (flash_mod, ragged_mod, decode_mod)
    results = {"card": cs.card_line()}
    results["launches_by_path"] = cs.phase_train_mesh(
        torch, llama, moe, train, checkpoint, mods, args.seed, results)
    results["total_s"] = time.monotonic() - cs.T0
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1, default=str))
    cs.log(f"phase 40 passed; {results['total_s']:.1f}s in all")
    print(json.dumps({"ok": True, "phase": 40}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
