"""Device resolution shared by every entry point of the port.

The port runs on the card unless the caller asks for the CPU: a default
``device="cuda"`` on a host without CUDA raises instead of moving on to
the CPU by itself. torch is imported at the first call, so importing the
package (a CLI command that runs no model) loads no torch.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Union

if TYPE_CHECKING:
    import torch


def devices() -> List[torch.device]:
    """The visible CUDA devices, in index order (``jax.devices()``'s
    counterpart); raises RuntimeError without CUDA, as the entry points
    do."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "gofr_tpu_torch: CUDA is not available; pass CPU devices "
            "(torch.device('cpu')) to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises RuntimeError for a CUDA
    device when CUDA is unavailable and ValueError for any device type
    other than ``cuda`` or ``cpu``."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gofr_tpu_torch: CUDA is not available; pass device='cpu' "
                "to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"gofr_tpu_torch: unsupported device {dev}")
    return dev
