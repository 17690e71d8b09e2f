#!/usr/bin/env python3
"""Where the ragged kernel's cluster-of-8 body spends its cycles, phase
by phase.

Copies ``gofr_tpu_torch/csrc/ragged_paged_attention.cu`` (or ``--csrc``'s,
another tree's) into
``build/ragged_phase_clocks/`` with a ``clock64()`` stamp written by
thread 0 of every block at each phase boundary (found by the comment
lines that open the phases), builds it beside the real kernel, and runs
it through the same wrapper at ``chip_smoke.py``'s shapes: phase 4's
decode, phase 5's verify at G 5 (bf16 and int8 pools) and the full-card
verify (every fill 2042). Prints, for KV head 0 of the slots named in
``--slots``, each rank's cycles per phase (``loads``, ``pass1``,
``snew`` (the new tokens' scores and pass 2's first V loads),
``stats_fold`` (the chunk's max and sum, the cluster barrier and fold),
``psweep`` (the probabilities), ``pass2``, ``combine`` (barrier and the
output), ``end`` (the last barrier)), and the kernel time of the stamped
and of the real kernel (``chip_smoke.Timer``), with the card's clock.
With ``--small`` the cases are ``small``'s head_dim 64 shapes (Hq = Hkv =
16) instead: phase 19's paged decode and verify G 5 (32 table columns)
and the decode over the identity table of rung 128 (4 columns). The
stamps are in the cluster-of-8 body only: give ``--csrc`` a tree whose
head_dim-64 launches take it (one before the head_dim-64 body).

Run from the root of a checkout on a CUDA host:
``python3 scripts/ragged_phase_clocks.py [--slots 0 5 6] [--small]
[--csrc OTHER_CSRC]``.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (LLAMA3, SMALL, Timer, card_line,  # noqa: E402
                        check_ragged, dense_scenario, ragged_call)

PHASES = ["loads", "pass1", "snew", "stats_fold", "psweep", "pass2",
          "combine", "end"]
# (text of a line in the kernel, stamp index, stamp before or after it)
ANCHORS = [
    ("  cg::cluster_group cluster = cg::this_cluster();\n", 0, "after"),
    ("  // -- pass 1: every query's chunk scores into shared memory", 1,
     "before"),
    ("  // the new tokens' scores: their K rows are one tile", 2, "before"),
    ("  // -- the chunk's statistics of each (query, row)", 3, "before"),
    ("  gather(cluster, rank_ml, all, 2 * rows, tid);\n", 4, "after"),
    ("  // -- pass 2: P.V in float32, query by query", 5, "before"),
    ("  // -- the output, an eighth on each rank", 6, "before"),
    ("  cluster.sync();     // no rank exits while another reads", 7,
     "before"),
]
STAMPS = 16          # stamp slots a block
CASES = [("phase 4 decode bf16", False, 1,
          [0, 1, 31, 32, 33, 700, 2047, 512]),
         ("phase 5 verify G5 bf16", False, 5,
          [0, 1, 31, 32, 33, 700, 2042, 512]),
         ("phase 5 verify G5 int8", True, 5,
          [0, 1, 31, 32, 33, 700, 2042, 512]),
         ("full card verify G5 bf16", False, 5, [2042] * 8)]
SMALL_CASES = [("D64 phase 19 decode bf16", False, 1,
                [0, 1, 31, 32, 33, 500, 1023, 512]),
               ("D64 phase 19 verify G5 bf16", False, 5,
                [0, 1, 31, 32, 33, 500, 1018, 512]),
               ("D64 identity 128 decode bf16", False, 1, 128)]


def stamped_source(src: str) -> str:
    """The kernel source with a clock64 stamp at each phase boundary."""
    stamp = ("if (threadIdx.x == 0) g_clocks[((long)blockIdx.y * gridDim.x "
             "+ blockIdx.x) * %d + %%d] = clock64();\n" % STAMPS)
    for text, k, where in ANCHORS:
        at = src.index(text)
        if where == "after":
            at += len(text)
        else:
            at = src.rindex("\n", 0, at) + 1
        src = src[:at] + stamp % k + src[at:]
    end = "  cluster.sync();     // no rank exits while another reads"
    close = src.index("\n}\n", src.index(end))
    src = src[:close + 1] + stamp % (len(PHASES)) + src[close + 1:]
    src = src.replace("namespace cg = cooperative_groups;",
                      "namespace cg = cooperative_groups;\n"
                      "__device__ long long g_clocks[1 << 16];")
    return src + ('\nextern "C" int gofr_read_clocks(void* host, int n) {\n'
                  '  return (int)cudaMemcpyFromSymbol(host, g_clocks,\n'
                  '                                   sizeof(long long) * n);'
                  '\n}\n')


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--slots", type=int, nargs="+", default=[0, 5, 6])
    parser.add_argument("--small", action="store_true",
                        help="small's head_dim 64 cases")
    parser.add_argument("--csrc", help="stamp this tree's kernel source")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ragged_phase_clocks: no CUDA device", file=sys.stderr)
        return 1
    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops.cuda import _build
    from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod

    out_dir = Path("build/ragged_phase_clocks")
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = Path(args.csrc) if args.csrc else _build.CSRC
    src = (csrc / "ragged_paged_attention.cu").read_text()
    (out_dir / "ragged_paged_attention.cu").write_text(stamped_source(src))
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, out_dir)
    lib_path = out_dir / "stamped.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                    str(lib_path), str(out_dir / "ragged_paged_attention.cu")],
                   check=True)
    unstamped = out_dir / "unstamped.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                    str(unstamped), str(csrc / "ragged_paged_attention.cu")],
                   check=True)
    libs = {"kernel": ctypes.CDLL(str(unstamped.resolve())),
            "stamped": ctypes.CDLL(str(lib_path.resolve()))}
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card_line(), "| SM clock now, max:", clock.strip(), flush=True)
    timer = Timer(torch)
    for name, int8, g_len, fills in (SMALL_CASES if args.small else CASES):
        if isinstance(fills, int):           # an identity rung
            call, fills = dense_scenario(torch, llama, int8, fills, g_len,
                                         31, SMALL)
            kernel = ragged_mod.ragged_paged_decode_attention
            plain = ragged_mod.ragged_paged_decode_attention_plain
        else:
            call, kernel, plain = ragged_call(
                torch, ragged_mod, int8, fills, g_len, 7,
                SMALL if args.small else LLAMA3)
        ref = plain(*call)
        times = {}
        for side, lib in libs.items():
            _build._libs[ragged_mod.NAME] = lib
            out = kernel(*call)
            torch.cuda.synchronize()
            check_ragged(torch, out, ref, f"{name} ({side})")
            times[side] = timer(lambda: kernel(*call), iters=20)
        print(f"{name}: kernel {times['kernel']:.4f} ms, stamped "
              f"{times['stamped']:.4f} ms", flush=True)
        _build._libs[ragged_mod.NAME] = libs["stamped"]
        kernel(*call)
        torch.cuda.synchronize()
        blocks = len(fills) * call[1].shape[2] * ragged_mod.CLUSTER
        buf = (ctypes.c_longlong * (blocks * STAMPS))()
        if libs["stamped"].gofr_read_clocks(buf, blocks * STAMPS) != 0:
            raise RuntimeError("reading the clock stamps failed")
        stamps = np.frombuffer(buf, dtype=np.int64).reshape(
            len(fills), -1, STAMPS)[:, :, :len(PHASES) + 1]
        for slot in args.slots:
            print(f"  slot {slot} (fill {fills[slot]}), KV head 0: cycles "
                  f"per phase, rank 0..7", flush=True)
            for rank in range(ragged_mod.CLUSTER):
                row = stamps[slot, rank]
                cycles = np.diff(row)
                print(f"    rank {rank}: " + " ".join(
                    f"{p}={c}" for p, c in zip(PHASES, cycles))
                    + f" total={row[-1] - row[0]}", flush=True)
        _build._libs[ragged_mod.NAME] = libs["kernel"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
