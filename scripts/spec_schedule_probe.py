"""Whether the speculative engines' greedy completions follow the
host's pace: chip_smoke.py's phase 10 and 16 engines (``llama3-8b`` at 8
layers, bf16, paged and dense), alone, with one or two threads that
hold the GIL 3 ms of every 5 through the pipelined burst, and with one
that stalls the interpreter about 40 ms every 20 ms, each through
``phase_spec_engine`` and so through its dense check. Prints, per run, the ticks dispatched in the
burst (kind, rung, slots) and the check's verdict, then which greedy
completions equal the first paged run's, pipelined and at one tick in
flight. Needs a CUDA card; run from the repository root:

    python3 scripts/spec_schedule_probe.py

and writes ``chiprun_out/spec_schedule_probe.json``.
"""
import json
import os
import sys
import threading
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.ops.cuda import _build
from gofr_tpu_torch.ops.cuda import decode_attention as decode_mod
from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod
from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod
from gofr_tpu_torch.tpu import generate

print(cs.card_line(), flush=True)
_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
mods = (flash_mod, ragged_mod, decode_mod)
cfg = llama.config("llama3-8b", n_layers=8, use_flash=True)
params = llama.init(cfg, 0, device="cuda")
prompts = cs.engine_prompts(cfg, 0)


def hog(until):
    """Hold the GIL 3 ms of every 5 until ``until`` (monotonic seconds)."""
    while time.monotonic() < until:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.003:
            pass
        time.sleep(0.002)


def stall(until):
    """Hold the GIL in one C call (a sort, about 40 ms) every 20 ms until
    ``until``, as a pause of the collector would."""
    import random
    rng = random.Random(0)
    values = [rng.random() for _ in range(100000)]
    while time.monotonic() < until:
        t0 = time.perf_counter()
        sorted(values)
        STALLS.append(time.perf_counter() - t0)
        time.sleep(0.02)


STALLS = []
record = cs.record_dispatches


def hogged(n):
    """``record_dispatches`` (called as the burst starts) that also starts
    ``n`` hogs (``-n``: stalls) for the next 3 seconds: the burst takes
    about 0.5 s alone."""
    def run(engine):
        until = time.monotonic() + 3.0
        for _ in range(abs(n)):
            threading.Thread(target=hog if n > 0 else stall, args=(until,),
                             daemon=True).start()
        return record(engine)
    return run


runs = {}
for name, paged, hogs in (("P", True, 0), ("D", False, 0), ("Dh", False, 1),
                          ("Ph", True, 1), ("Dh2", False, 2), ("D2", False, 0),
                          ("Ds", False, -1), ("Ps", True, -1),
                          ("Ds2", False, -1)):
    cs.record_dispatches = hogged(hogs) if hogs else record
    results = {}
    ref = runs.get({"D2": "Ph", "Dh2": "Ph", "Ds2": "Ps"}.get(name, "P"))
    if not paged:
        results["spec_engine"] = ref
    err = None
    try:
        cs.phase_spec_engine(torch, llama, generate, mods, cfg, params, 0,
                             results, paged)
    except AssertionError as exc:
        err = str(exc)[:300]
    cs.record_dispatches = record
    time.sleep(3.0)
    row = results["spec_engine" if paged else "dense_spec"]
    runs[name] = row
    print(json.dumps(dict(run=name, hogs=hogs, err=err,
                          ticks=[d[:2] + [len(d[3])] for d in row["dispatches"]],
                          by_gamma=row["counters"]["ticks_by_gamma"])),
          flush=True)
base = runs["P"]
for name, row in runs.items():
    print(name, "pipelined same as P:",
          [a == b for a, b in zip(row["greedy_outputs"], base["greedy_outputs"])],
          "ticks same:", row["dispatches"] == base["dispatches"],
          "one-in-flight same as P:",
          [a == b for a, b in zip(row["extra"][:7], base["extra"][:7])],
          "one-in-flight = pipelined:",
          [a == b for a, b in zip(row["extra"][:7], row["greedy_outputs"])],
          flush=True)
if STALLS:
    print(f"stalls: {len(STALLS)}, {min(STALLS) * 1e3:.1f}-"
          f"{max(STALLS) * 1e3:.1f} ms", flush=True)
os.makedirs("chiprun_out", exist_ok=True)
with open("chiprun_out/spec_schedule_probe.json", "w") as f:
    json.dump(runs, f, default=str)
