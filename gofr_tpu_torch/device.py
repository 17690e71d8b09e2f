"""Device resolution shared by every entry point of the port.

The port runs on the card unless the caller asks for the CPU: a default
``device="cuda"`` on a host without CUDA raises instead of moving on to
the CPU by itself.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises RuntimeError for a CUDA
    device when CUDA is unavailable and ValueError for any device type
    other than ``cuda`` or ``cpu``."""
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
