"""Device meshes (counterpart of ``gofr_tpu/parallel/mesh.py``).

The port's mesh is single-controller, as JAX's is: one Python process
holds a named grid of devices and one object per sharded tensor, and
every collective between shards is an explicit call
(``parallel/collectives``) where JAX lets XLA insert it.

- :class:`Mesh` is axis names, their sizes (``mesh.shape``, an ordered
  dict as JAX's) and a numpy grid of ``torch.device``s.
- A device may repeat in the grid: ``make_mesh({"tp": 2},
  [torch.device("cuda:0")] * 2)`` runs two tensor-parallel shards on one
  card, each at its own shapes, and a list of CPU devices stands for
  JAX's virtual CPU devices in the tests.
- ``make_mesh`` keeps JAX's ``-1`` rule and its "needs N devices, have
  M" error; its default devices are the visible CUDA devices
  (:func:`gofr_tpu_torch.device.devices`), and it raises without CUDA.
- ``device_mesh`` is how a ``MESH`` / ``TPU_MESH`` spec maps onto
  devices, for the example and the executor alike.

Axis names across the framework: dp (batch), tp (heads / hidden), sp
(sequence), ep (experts), pp (pipeline stages).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gofr_tpu_torch.device import devices as visible_devices
from gofr_tpu_torch.device import resolve_device


class Mesh:
    """A named grid of devices: ``devices`` an object ndarray of
    ``torch.device`` whose axes are ``axis_names``. ``processes`` (same
    shape) is the process each coordinate belongs to (``hybrid_mesh``
    across processes; all 0 otherwise); a coordinate of another process
    holds the ``meta`` device, which this process cannot address."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 processes: Optional[np.ndarray] = None):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh devices {devices.shape} do not match "
                             f"axes {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.processes = (np.zeros(devices.shape, np.int64)
                          if processes is None else np.asarray(processes))

    @property
    def process_count(self) -> int:
        return len(np.unique(self.processes))

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self):
        """Every mesh coordinate, in row-major order."""
        return list(np.ndindex(*self.devices.shape))

    def axis_coords(self, axis: str) -> List[List[Tuple[int, ...]]]:
        """The coordinates in lines along ``axis``: one line for each
        coordinate of the other axes (row-major), holding its
        coordinates in ``axis`` order; an axis the mesh lacks gives
        lines of one."""
        if axis not in self.axis_names:
            return [[c] for c in self.coords()]
        at = self.axis_names.index(axis)
        return [[c[:at] + (r,) + c[at + 1:]
                 for r in range(self.devices.shape[at])]
                for c in self.coords() if c[at] == 0]

    @property
    def distinct_devices(self) -> int:
        """Distinct devices in the grid (1 when every shard shares one)."""
        return len({str(d) for d in self.devices.flat})

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={self.distinct_devices})"


def check_one_card(mesh, device: torch.device, owner: str) -> None:
    """Raise ValueError unless ``mesh`` is a :class:`Mesh` of ``device``'s
    type whose shards, on the card, all sit on ``device`` itself: a
    serving engine's tick and an executor's bucket are one CUDA graph on
    one device, so their shards share the card (``owner`` names the
    caller in the message)."""
    if not isinstance(mesh, Mesh):
        raise ValueError(f"mesh: expected a gofr_tpu_torch.parallel.mesh."
                         f"Mesh (make_mesh), got {type(mesh).__name__}")
    devs = {str(resolve_device(d) if d.type == "cuda" and d.index is None
                else d) for d in map(torch.device, mesh.devices.flat)}
    if any(torch.device(d).type != device.type for d in devs):
        raise ValueError(f"mesh: its devices {sorted(devs)} are not of the "
                         f"{owner}'s device type {device.type}")
    if device.type == "cuda" and devs != {str(device)}:
        raise ValueError(
            f"mesh: devices {sorted(devs)}; the {owner}'s work on the card "
            f"is a CUDA graph on {device}, so its shards must share that "
            f"card (repeat the device in the mesh)")


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a mesh from ``{"dp": 2, "tp": 4}``-style axis sizes.

    ``-1`` for at most one axis means "all remaining devices". Default is
    a pure data-parallel mesh over every given device; ``devices``
    defaults to the visible CUDA devices (raises without CUDA; pass
    ``[torch.device("cpu")] * n`` for n CPU shards)."""
    devices = list(devices if devices is not None else visible_devices())
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if not axes:
        axes = {"dp": n}
    names = tuple(axes.keys())
    sizes = list(axes.values())
    if -1 in sizes:
        known = 1
        for s in sizes:
            if s != -1:
                known *= s
        sizes[sizes.index(-1)] = max(1, n // known)
    total = 1
    for s in sizes:
        total *= s
    if total > n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {n}")
    grid = np.empty((total,), dtype=object)
    for i, dev in enumerate(devices[:total]):
        grid[i] = dev
    return Mesh(grid.reshape(tuple(sizes)), names)


def device_mesh(axes: Dict[str, int], device) -> Mesh:
    """The mesh of a ``MESH`` / ``TPU_MESH`` spec for an owner (an
    engine, an executor) on ``device``: on the CPU over as many CPU
    devices as the spec needs, as JAX's tests force that many host
    devices (a ``-1`` axis is then 1); on the card over the visible
    cards."""
    if torch.device(device).type == "cpu":
        need = int(np.prod([s for s in axes.values() if s > 0] or [1]))
        return make_mesh(axes, [torch.device("cpu")] * need)
    return make_mesh(axes)


def parse_mesh_spec(spec: Optional[str]) -> Optional[Dict[str, int]]:
    """Parse the ``MESH`` knob into ``make_mesh`` axis sizes.

    Accepted forms: ``"dp:2,tp:4"`` (explicit axes), ``"tp:8"`` (one
    axis, dp fills the rest), a bare integer ``"8"`` (shorthand for
    ``tp:<n>`` — the common "shard the model N ways" intent), and
    ``"auto"`` (tp over every addressable device, dp:1). Returns None
    for empty/absent specs; malformed axis sizes raise ``ValueError``
    because a typo'd topology must fail at startup."""
    spec = (spec or "").strip().lower()
    if not spec:
        return None
    if spec == "auto":
        return {"dp": 1, "tp": -1}
    if spec.isdigit():
        return {"dp": -1, "tp": int(spec)}
    axes: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        axis, sep, size = part.partition(":")
        if not sep or not axis.strip():
            raise ValueError(
                f"MESH entry {part!r}: expected axis:size (e.g. tp:4)")
        try:
            axes[axis.strip()] = int(size)
        except ValueError:
            raise ValueError(
                f"MESH entry {part!r}: size must be an integer") from None
    if len(axes) == 1 and "tp" in axes:
        axes = {"dp": -1, "tp": axes["tp"]}
    return axes or None


def serving_mesh(tp: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """dp×tp mesh: shard the model tp-ways, data-parallel over the rest."""
    return make_mesh({"dp": -1, "tp": tp}, devices)
