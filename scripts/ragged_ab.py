#!/usr/bin/env python3
"""The ragged paged attention kernel of another source tree (a parent
commit's ``gofr_tpu_torch/csrc``) against this checkout's, timed in one
process on one card, in turns (other, this, this, other, ...), at
``chip_smoke.py``'s shapes:

- head_dim 128 (``llama3-8b``): phase 4's decode (8 slots, page 32, 64
  table columns, fills 0/1/31/32/33/700/2047/512), phase 5's verify at
  G 5 (fills 0/1/31/32/33/700/2042/512), and the full-card shape (8
  slots at fill 2047 for decode, 2042 for verify G 5);
- head_dim 64 (``small``: Hq = Hkv = 16): phase 19's paged decode and
  verify G 5 (32 table columns, fills 0/1/31/32/33/500/1023/512, verify
  1018 for the longest), and the identity tables of a 1024-position
  dense cache at rungs 128, 256, 512 and 1024 (phase 19's), decode and
  verify G 5, each timed beside one ``scaled_dot_product_attention``
  call with a per-row length mask (bf16; a yardstick only);

each over bf16 and int8 pools. Both kernels are held to the plain version
(``chip_smoke``'s ragged limits) before they are timed, and their outputs
are compared bit for bit (``--same-bits 128`` fails the run unless they
are equal at that head_dim). Timing is ``chip_smoke.Timer`` (per-launch
CUDA events, L2 flushed before each launch). The C entry points are the
same on both sides, so the other tree's library is bound by the same
wrapper.

Prints one JSON object (also written to ``--out``): per case, each
side's times in the order taken, the bound (bytes, each input read once),
GB/s of the best time, SDPA's time and the ratios.

Run from the root of a checkout on a CUDA host:
``python3 scripts/ragged_ab.py OTHER_CSRC [--rounds 2] [--head-dims 64
128] [--same-bits 128]``, e.g. after
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
                        LLAMA3, SMALL, SPEC_GAMMA, Timer, card_line,
                        check_ragged, dense_scenario, identity_sdpa_ms,
                        paged_cost, ragged_call)

PHASE_FILLS = [0, 1, 31, 32, 33, 700, 2047, 512]
SMALL_FILLS = [0, 1, 31, 32, 33, 500, 1023, 512]
G5 = SPEC_GAMMA + 1


def cases(head_dims):
    """(name, head_dim, geometry, int8, g_len, fills, identity rung or
    None) of every case."""
    out = []
    for pools in ("bf16", "int8"):
        for form, g_len in (("decode", 1), (f"verify G{G5}", G5)):
            int8 = pools == "int8"
            if 128 in head_dims:
                for shape, fills in (("phase 4/5", PHASE_FILLS),
                                     ("full card", [2047] * 8)):
                    out.append((f"D128 {shape} {pools} {form}", 128, LLAMA3,
                                int8, g_len,
                                [min(n, 2047 if g_len == 1 else 2047 - g_len)
                                 for n in fills], None))
            if 64 in head_dims:
                out.append((f"D64 phase 19 {pools} {form}", 64, SMALL, int8,
                            g_len, [min(n, 1023 if g_len == 1
                                        else 1023 - g_len)
                                    for n in SMALL_FILLS], None))
                for rung in (128, 256, 512, 1024):
                    out.append((f"D64 identity {rung} {pools} {form}", 64,
                                SMALL, int8, g_len, None, rung))
    return out


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
    parser.add_argument("--head-dims", type=int, nargs="+",
                        default=[64, 128])
    parser.add_argument("--same-bits", type=int, nargs="*", default=[],
                        help="head dims at which both sides must give the "
                             "same bits")
    parser.add_argument("--out", default="chiprun_out/ragged_ab.json")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ragged_ab: no CUDA device", file=sys.stderr)
        return 1
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops.cuda import _build
    from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod

    libs = {"this": _build.load(ragged_mod.NAME),
            "other": build_other(Path(args.other), _build.find_nvcc(),
                                 _build.NVCC_FLAGS)}
    timer = Timer(torch)
    order = ["other", "this", "this", "other"] * args.rounds
    rows = []
    unequal = []
    for name, d, geom, int8, g_len, fills, rung in cases(args.head_dims):
        if rung is None:
            call, kernel, plain = ragged_call(torch, ragged_mod, int8, fills,
                                              g_len, 2 + g_len, geom)
            reach = fills
        else:
            call, reach = dense_scenario(torch, llama, int8, rung, g_len,
                                         30 + g_len, geom)
            kernel, plain = (
                (ragged_mod.ragged_paged_decode_attention,
                 ragged_mod.ragged_paged_decode_attention_plain)
                if g_len == 1 else
                (ragged_mod.ragged_paged_verify_attention,
                 ragged_mod.ragged_paged_verify_attention_plain))
        ref = plain(*call)
        times = {"other": [], "this": []}
        errors, outs = {}, {}
        for side in order:
            _build._libs[ragged_mod.NAME] = libs[side]
            if side not in errors:
                outs[side] = kernel(*call)
                torch.cuda.synchronize()
                errors[side] = check_ragged(torch, outs[side], ref,
                                            f"{name} ({side})")
            times[side].append(timer(lambda: kernel(*call), iters=20))
        _build._libs[ragged_mod.NAME] = libs["this"]
        same = torch.equal(outs["this"].view(torch.int16),
                           outs["other"].view(torch.int16))
        if d in args.same_bits and not same:
            unequal.append(name)
        lib_ms = None
        if rung is not None and not int8:
            lib_ms = identity_sdpa_ms(torch, timer, call, reach, geom, rung,
                                      outs["this"].float())[0]
        nbytes, flops = paged_cost(reach, g_len, call[3].numel(), int8,
                                   geom)
        bound_s = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
        best = {k: min(v) for k, v in times.items()}
        row = dict(case=name, head_dim=d, fills=reach, g_len=g_len,
                   rung=rung, times_ms=times, same_bits=same,
                   max_abs_err={k: v[0] for k, v in errors.items()},
                   row_rel_l2={k: v[1] for k, v in errors.items()},
                   bytes=nbytes, bound_ms=bound_s * 1e3, bound_by="bytes",
                   gb_per_s={k: nbytes / (v * 1e-3) / 1e9
                             for k, v in best.items()},
                   speedup=best["other"] / best["this"], sdpa_ms=lib_ms,
                   sdpa_ratio=({k: v / lib_ms for k, v in best.items()}
                               if lib_ms else None))
        rows.append(row)
        print(f"{name}: other {[round(t, 4) for t in times['other']]} ms, "
              f"this {[round(t, 4) for t in times['this']]} ms, bound "
              f"{row['bound_ms']:.5f} ms, this "
              f"{row['gb_per_s']['this']:.1f} GB/s, "
              f"{row['speedup']:.2f}x, same bits {same}"
              + (f", sdpa {lib_ms:.4f} ms (this "
                 f"{row['sdpa_ratio']['this']:.3f}x, other "
                 f"{row['sdpa_ratio']['other']:.3f}x)" if lib_ms else ""),
              flush=True)
    result = dict(card=card_line(), device=torch.cuda.get_device_name(0),
                  other=args.other, cases=rows, unequal_bits=unequal)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    if unequal:
        print(f"ragged_ab: the two sides' bits differ at {unequal}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
