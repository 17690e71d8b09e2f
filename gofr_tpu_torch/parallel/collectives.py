"""Explicit collectives between the shards of a single-controller mesh.

JAX has no such module: GSPMD inserts the collectives from the shardings.
The port's mesh (``parallel/mesh``) is one process holding one tensor a
mesh coordinate, so the model code calls these between its shards:

- :func:`all_reduce` (``psum``): the sum of every shard's part, on every
  shard's device. Parts are summed in float32 in rank order and rounded
  once to their dtype, so a bf16 row-parallel sum rounds once where a
  chain of bf16 adds would round at each step; one part is returned as
  it is (a group of one is the unsharded arithmetic, bit for bit).
- :func:`all_gather`: the parts concatenated along a dim, on every
  shard's device.
- :func:`ppermute`: each shard's part moved one step along the ring
  (rank i's to rank i + shift).
- :func:`broadcast`: one tensor onto every shard's device.

Between shards on one device (the CPU tests' meshes, several shards on
one card) each is plain tensor ops on that device, which a CUDA graph
captures with the rest of a tick. Between distinct CUDA devices the
route is peer copies: ``Tensor.to`` of the part onto the reducing or
receiving device (``cudaMemcpyPeerAsync`` under PyTorch's cross-device
copy, which orders the two devices' streams), then the same ops there.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def broadcast(x: torch.Tensor,
              devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x`` on each of ``devices`` (the same tensor where it is there
    already)."""
    return [x.to(dev) for dev in devices]


def all_reduce(parts: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The sum of ``parts`` (one a rank, ``devices[r]`` holding part r),
    on every rank's device: float32 accumulation in rank order, one
    rounding to the parts' dtype; a single part comes back unchanged."""
    if len(parts) == 1:
        return [parts[0]]
    home = parts[0].device
    total = parts[0].float()
    for part in parts[1:]:
        total = total + part.to(home).float()
    total = total.to(parts[0].dtype)
    return broadcast(total, devices)


psum = all_reduce


def all_gather(parts: Sequence[torch.Tensor],
               devices: Sequence[torch.device],
               dim: int = -1) -> List[torch.Tensor]:
    """``parts`` concatenated along ``dim`` in rank order, on every rank's
    device; a single part comes back unchanged."""
    if len(parts) == 1:
        return [parts[0]]
    home = parts[0].device
    full = torch.cat([part.to(home) for part in parts], dim=dim)
    return broadcast(full, devices)


def ppermute(parts: Sequence[torch.Tensor],
             devices: Sequence[torch.device],
             shift: int = 1) -> List[torch.Tensor]:
    """Rotate the parts one ring step: rank ``(i + shift) % n`` receives
    rank i's part, on its own device (``lax.ppermute`` with the ring
    permutation ``[(i, (i + shift) % n)]``)."""
    n = len(parts)
    return [parts[(r - shift) % n].to(devices[r]) for r in range(n)]


class Group:
    """The shards along one mesh axis (the others fixed): a tp group of
    one dp row, the sp ring of ring attention. ``devices[r]`` is rank
    r's device; the methods are the module's collectives over it."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = [torch.device(d) for d in devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    def broadcast(self, x: torch.Tensor) -> List[torch.Tensor]:
        return broadcast(x, self.devices)

    def all_reduce(self, parts) -> List[torch.Tensor]:
        return all_reduce(parts, self.devices)

    def all_gather(self, parts, dim: int = -1) -> List[torch.Tensor]:
        return all_gather(parts, self.devices, dim)

    def ppermute(self, parts, shift: int = 1) -> List[torch.Tensor]:
        return ppermute(parts, self.devices, shift)

    def __repr__(self) -> str:
        return f"Group({[str(d) for d in self.devices]})"
