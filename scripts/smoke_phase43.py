#!/usr/bin/env python3
"""Phase 43 of ``chip_smoke.py`` (the port's static analyzer) alone, on
one card: 43a runs ``python -m gofr_tpu_torch.analysis --no-cache`` over
this checkout in a process of its own (here with nothing beside it) and
requires exit 0; 43b holds the premises of the three CUDA-graph rules
(GT004, GT003, GT015) on the card through ``capture.record``. No
hand-written kernel runs, so none is built.

Run from the root of a checkout: ``python3 scripts/smoke_phase43.py``.
Details go to ``chiprun_out/phase43.json``; the card's name and power
limit are printed first.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chiprun_out/phase43.json")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("smoke_phase43: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    results = {"card": card}
    analysis = cs.start_analysis()
    analysis.wait(timeout=600)   # alone: the phase below reads it at once
    cs.phase_analysis(torch, analysis, results)
    results["total_s"] = time.monotonic() - cs.T0
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1, default=str))
    print(json.dumps(results["analysis"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
