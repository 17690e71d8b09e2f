#!/usr/bin/env python3
"""The ragged paged attention kernel of another source tree (a parent
commit's ``gofr_tpu_torch/csrc``) against this checkout's, timed in one
process on one card, in turns (other, this, this, other, ...), at
``chip_smoke.py``'s shapes: phase 4's decode (8 slots, page 32, 64 table
columns, fills 0/1/31/32/33/700/2047/512), phase 5's verify at G 5
(fills 0/1/31/32/33/700/2042/512), and the full-card shape (8 slots at
fill 2047 for decode, 2042 for verify G 5), each over bf16 and int8
pools. Both kernels are held to the plain version (``chip_smoke``'s
ragged limits) before they are timed. Timing is ``chip_smoke.Timer``
(per-launch CUDA events, L2 flushed before each launch). The C entry
points are the same on both sides, so the other tree's library is bound
by the same wrapper.

Prints one JSON object (also written to ``--out``): per case, each
side's times in the order taken, the bound (bytes, each input read once)
and GB/s of the best time.

Run from the root of a checkout on a CUDA host:
``python3 scripts/ragged_ab.py OTHER_CSRC [--rounds 2]``, e.g. after
``git archive <parent> gofr_tpu_torch/csrc | tar -x -C build/parent``
with ``OTHER_CSRC`` = ``build/parent/gofr_tpu_torch/csrc``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (BF16_FLOP_PER_S, HBM_BYTES_PER_S,  # noqa: E402
                        Timer, card_line, check_ragged, paged_cost,
                        ragged_call)

PHASE_FILLS = [0, 1, 31, 32, 33, 700, 2047, 512]
CASES = [(f"{shape} {pools} {form}", pools == "int8", g_len,
          [min(n, 2047 if g_len == 1 else 2047 - g_len) for n in fills])
         for shape, fills in (("phase 4/5", PHASE_FILLS),
                              ("full card", [2047] * 8))
         for pools in ("bf16", "int8")
         for form, g_len in (("decode", 1), ("verify G5", 5))]


def build_other(csrc: Path, nvcc: str, flags: list) -> ctypes.CDLL:
    """The other tree's ragged kernel, built into ``build/ragged_ab``."""
    src = csrc / "ragged_paged_attention.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.read_bytes())
    out = Path("build/ragged_ab") / f"other-{digest.hexdigest()[:16]}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([nvcc, *flags, "-o", str(out), str(src)], check=True)
    return ctypes.CDLL(str(out.resolve()))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", help="the other tree's csrc directory")
    parser.add_argument("--rounds", type=int, default=2,
                        help="(other, this, this, other) rounds per case")
    parser.add_argument("--out", default="chiprun_out/ragged_ab.json")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ragged_ab: no CUDA device", file=sys.stderr)
        return 1
    from gofr_tpu_torch.ops.cuda import _build
    from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod

    libs = {"this": _build.load(ragged_mod.NAME),
            "other": build_other(Path(args.other), _build.find_nvcc(),
                                 _build.NVCC_FLAGS)}
    timer = Timer(torch)
    order = ["other", "this", "this", "other"] * args.rounds
    cases = []
    for name, int8, g_len, fills in CASES:
        call, kernel, plain = ragged_call(torch, ragged_mod, int8, fills,
                                          g_len, 2 + g_len)
        ref = plain(*call)
        times = {"other": [], "this": []}
        errors = {}
        for side in order:
            _build._libs[ragged_mod.NAME] = libs[side]
            if side not in errors:
                out = kernel(*call)
                torch.cuda.synchronize()
                errors[side] = check_ragged(torch, out, ref,
                                            f"{name} ({side})")
            times[side].append(timer(lambda: kernel(*call), iters=20))
        _build._libs[ragged_mod.NAME] = libs["this"]
        nbytes, flops = paged_cost(fills, g_len, call[3].numel(), int8)
        bound_s = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
        row = dict(case=name, fills=fills, g_len=g_len, times_ms=times,
                   max_abs_err={k: v[0] for k, v in errors.items()},
                   row_rel_l2={k: v[1] for k, v in errors.items()},
                   bytes=nbytes, bound_ms=bound_s * 1e3, bound_by="bytes",
                   gb_per_s={k: nbytes / (min(v) * 1e-3) / 1e9
                             for k, v in times.items()},
                   speedup=min(times["other"]) / min(times["this"]))
        cases.append(row)
        print(f"{name}: other {[round(t, 4) for t in times['other']]} ms, "
              f"this {[round(t, 4) for t in times['this']]} ms, bound "
              f"{row['bound_ms']:.4f} ms, this "
              f"{row['gb_per_s']['this']:.1f} GB/s, "
              f"{row['speedup']:.2f}x", flush=True)
    result = dict(card=card_line(), device=torch.cuda.get_device_name(0),
                  other=args.other, cases=cases)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
