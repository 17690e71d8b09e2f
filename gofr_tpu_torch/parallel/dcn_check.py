"""Two-process DCN check: ``torch.distributed`` over a real coordinator
(counterpart of ``gofr_tpu/parallel/dcn_check.py``).

This module is both the child program and the parent-side launcher of a
2-process check that runs the multi-process path end to end:

- each process joins the group through ``initialize_distributed`` (the
  same env contract a k8s deployment would use),
- ``hybrid_mesh`` lays out a dcn-outermost × ici-innermost mesh, each
  process's coordinates on its ``local_devices`` shards of ``device``,
- one value a mesh coordinate (``arange`` over the global mesh, sharded
  ``P(("dp_outer", "dp"))``) is summed over the local shards
  (``parallel/collectives.all_reduce``) and then across the process
  boundary (one ``torch.distributed.all_reduce``), and both processes
  check the global sum.

On one card two processes cannot both join an NCCL group (NCCL refuses
two ranks on one GPU); gloo serves there, staging the CUDA tensor
through the host for its all-reduce. Each child reports the backend
that served.

Run standalone:  python -m gofr_tpu_torch.parallel.dcn_check [cuda|cpu]
(parent mode: spawns both children, prints their reports; the card
unless ``cpu`` is given).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from typing import Dict, List, Optional

_CHILD_ENV_FLAG = "GOFR_DCN_CHECK_CHILD"


def _child() -> None:
    """One process of the 2-process job."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gofr_tpu_torch.parallel import collectives, multihost
    from gofr_tpu_torch.parallel.sharding import P, shard_slices

    device = torch.device(os.environ.get("GOFR_DCN_DEVICE", "cuda"))
    local_devices = int(os.environ.get("GOFR_DCN_LOCAL_DEVICES", "4"))
    backend = os.environ.get("GOFR_DCN_BACKEND") or "gloo"
    started = multihost.initialize_distributed(backend=backend)
    assert started, "initialize_distributed must start with JAX_COORDINATOR"
    try:
        mesh = multihost.hybrid_mesh(
            {"dp": local_devices}, {"dp_outer": dist.get_world_size()},
            devices=[device] * local_devices)
        n_global = mesh.size
        data = np.arange(n_global, dtype=np.float32)
        spec = P(("dp_outer", "dp"))
        me = dist.get_rank()
        coords = [c for c in mesh.coords() if mesh.processes[c] == me]
        parts = [torch.from_numpy(
                    data[shard_slices((n_global,), mesh, spec, c)])
                 .to(mesh.devices[c]).sum() for c in coords]
        local = collectives.all_reduce(parts, [mesh.devices[c]
                                               for c in coords])[0]
        total = local.clone()
        dist.all_reduce(total)
        reduced = float(total.item())
        expected = float(data.sum())
        report = {
            "process": me,
            "process_count": dist.get_world_size(),
            "local_devices": len(coords),
            "global_devices": n_global,
            "psum": reduced,
            "expected": expected,
            "ok": abs(reduced - expected) < 1e-6,
            "backend": dist.get_backend(),
            "device": str(total.device),
        }
    finally:
        dist.destroy_process_group()
    print(json.dumps(report), flush=True)
    assert report["ok"], report


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def run_two_process_check(local_devices: int = 4, timeout: float = 180.0,
                          device: str = "cuda",
                          backend: Optional[str] = None) -> List[Dict]:
    """Spawn the 2-process job; returns both children's reports (the
    parent asserts nothing itself — callers check ``ok``/``psum``).
    ``device`` is each child's, the card by default (raises without
    CUDA, as every entry point of the port does; ``device="cpu"`` asks
    for the CPU); ``backend`` the process group's (default gloo, which
    serves both). The one divergence from JAX's check, which pins its
    children to the CPU: the port's runs where its caller's device is."""
    import tempfile

    from gofr_tpu_torch.device import resolve_device

    device = str(resolve_device(device).type)

    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    children = []
    for process_id in range(2):
        env = dict(os.environ)
        env[_CHILD_ENV_FLAG] = "1"
        env["JAX_COORDINATOR"] = f"127.0.0.1:{port}"
        env["JAX_NUM_PROCESSES"] = "2"
        env["JAX_PROCESS_ID"] = str(process_id)
        env["GOFR_DCN_DEVICE"] = device
        env["GOFR_DCN_LOCAL_DEVICES"] = str(local_devices)
        env["GOFR_DCN_BACKEND"] = backend or ""
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH",
                                                             "")
        # stderr → a temp file: both children must reach the collective
        # for either to exit, so an undrained stderr PIPE filling up
        # would deadlock the pair (and eat the diagnostics)
        errfile = tempfile.TemporaryFile(mode="w+")
        child = subprocess.Popen(
            [sys.executable, "-m", "gofr_tpu_torch.parallel.dcn_check"],
            env=env, stdout=subprocess.PIPE, stderr=errfile, text=True)
        children.append((child, errfile))
    reports = []
    try:
        for child, errfile in children:
            try:
                out, _ = child.communicate(timeout=timeout)
            finally:
                errfile.seek(0)
                err = errfile.read()
            if child.returncode != 0:
                raise RuntimeError(
                    f"dcn check child failed rc={child.returncode}:\n"
                    f"{err[-2000:]}")
            reports.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for child, errfile in children:
            if child.poll() is None:
                child.kill()
                child.wait()
            errfile.close()
    return reports


if __name__ == "__main__":
    if os.environ.get(_CHILD_ENV_FLAG):
        _child()
    else:
        for entry in run_two_process_check(
                device=sys.argv[1] if len(sys.argv) > 1 else "cuda"):
            print(json.dumps(entry))
