"""Multi-process runtime: DCN × ICI hybrid meshes (counterpart of
``gofr_tpu/parallel/multihost.py``).

Every process runs the same program; :func:`initialize_distributed`
joins them through ``torch.distributed`` from the app's configuration
contract, JAX's keys (k8s-friendly, env-first):

  JAX_COORDINATOR=host:port  JAX_NUM_PROCESSES=N  JAX_PROCESS_ID=i

The coordinator address becomes ``init_process_group``'s
``tcp://host:port`` (process 0 hosts the store there). The backend is
NCCL on the card and gloo on the CPU unless the caller names one.

:func:`hybrid_mesh` lays the mesh out DCN-outermost: the dcn axes index
processes, the ici axes each process's local devices. The mesh is each
process's view: its own coordinates hold its devices, every other
process's the ``meta`` device (``Mesh.processes`` says whose each is).
A collective across the dcn axes is a ``torch.distributed`` call
(``parallel/dcn_check``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from gofr_tpu_torch.device import devices as visible_devices
from gofr_tpu_torch.parallel.mesh import Mesh


def _dist():
    import torch.distributed as dist
    return dist


def initialize_distributed(config=None, backend: Optional[str] = None
                           ) -> bool:
    """Join the process group from env/config; returns True if a
    multi-process runtime was started (no coordinator: a no-op, False).
    ``backend`` defaults to ``nccl`` with CUDA and ``gloo`` without."""
    def get(key: str, default: str = "") -> str:
        if config is not None:
            return config.get_or_default(key, default)
        return os.environ.get(key, default)

    coordinator = get("JAX_COORDINATOR")
    if not coordinator:
        return False
    num_processes = int(get("JAX_NUM_PROCESSES", "1"))
    process_id = int(get("JAX_PROCESS_ID", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    _dist().init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id)
    return True


def _process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def _process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def hybrid_mesh(ici_axes: Dict[str, int],
                dcn_axes: Optional[Dict[str, int]] = None,
                devices: Optional[Sequence] = None) -> Mesh:
    """Mesh with DCN axes outermost and ICI axes innermost.

    ``hybrid_mesh({"dp": 4, "tp": 2}, {"dp_outer": 2})`` on 2 processes ×
    8 devices: data parallelism splits over DCN first (a gradient
    all-reduce crosses processes once), while tp all-reduces stay local.
    ``devices`` are this process's (default: its visible CUDA devices);
    the ici axes take them all. On a single process every dcn axis must
    be 1 (validated)."""
    dcn_axes = dcn_axes or {}
    num_slices = max(1, _process_count())
    dcn_total = 1
    for size in dcn_axes.values():
        dcn_total *= size
    if dcn_total > num_slices:
        raise ValueError(
            f"dcn axes {dcn_axes} need {dcn_total} processes, have "
            f"{num_slices}")
    local = [torch.device(d) for d in
             (devices if devices is not None else visible_devices())]
    ici_shape = tuple(ici_axes.values())
    ici_total = int(np.prod(ici_shape)) if ici_shape else 1
    if ici_total != len(local):
        raise ValueError(f"ici axes {ici_axes} need {ici_total} devices, "
                         f"have {len(local)}")
    dcn_shape = tuple(dcn_axes.values())
    me = _process_index()
    grid = np.empty(dcn_shape + ici_shape, dtype=object)
    procs = np.zeros(grid.shape, np.int64)
    for outer in np.ndindex(*dcn_shape):
        proc = int(np.ravel_multi_index(outer, dcn_shape)) if dcn_shape \
            else 0
        for i, inner in enumerate(np.ndindex(*ici_shape)):
            grid[outer + inner] = local[i] if proc == me \
                else torch.device("meta")
            procs[outer + inner] = proc
    return Mesh(grid, tuple(dcn_axes) + tuple(ici_axes), procs)


def process_info() -> Dict[str, int]:
    """This process's view of the job (for logs/health endpoints)."""
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    count = _process_count()
    return {
        "process_index": _process_index(),
        "process_count": count,
        "local_devices": local,
        "global_devices": local * count,
    }
