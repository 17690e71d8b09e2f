#!/usr/bin/env python3
"""The ragged paged decode kernel at D 128 (``chip_smoke.py`` phases 4
and 5: bf16 and int8 pools, B 8, the llama3-8b geometry) timed in turns
int8, bf16, int8 within one process, each turn against its plain version
as the smoke does. It tells a slow reading of one smoke run from a
change of the kernel.

Run from the root of a checkout on the GPU host:
``python3 scripts/ragged_turns.py``. Prints the card's name and power
limit first, then one JSON object of the main case's kernel ms by turn.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ragged_turns: no CUDA device", file=sys.stderr)
        return 1
    from gofr_tpu_torch.ops.cuda import _build
    from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod

    print(cs.card_line(), flush=True)
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for turn, int8 in enumerate((True, False, True)):
        timer = cs.Timer(torch)
        row = cs.phase_ragged(torch, ragged_mod, timer, {}, int8)
        out[f"{turn}_{'int8' if int8 else 'bf16'}"] = row["ms"]
        del timer
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
