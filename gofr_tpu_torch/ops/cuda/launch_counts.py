"""The kernel wrappers' launch counters, read and moved together.

Each wrapper adds one to its counter where it launches its kernel. A
replayed CUDA graph launches its kernels without a Python call, so the
engine records each graph's counter deltas at capture (:func:`read`
before and after, then :func:`write` back: a capture launches nothing)
and adds them on every replay with :func:`add`.
"""

from __future__ import annotations

from typing import Dict

from gofr_tpu_torch.ops.cuda import decode_attention as _decode
from gofr_tpu_torch.ops.cuda import flash_attention as _flash
from gofr_tpu_torch.ops.cuda import ragged_paged_attention as _ragged

_COUNTERS = ((_flash, "launches"), (_ragged, "launches"),
             (_ragged, "verify_launches"), (_ragged, "int8_launches"),
             (_ragged, "int8_verify_launches"), (_decode, "launches"))


def _name(module, attr: str) -> str:
    return f"{module.NAME}.{attr}"


def read() -> Dict[str, int]:
    """Every counter, by ``<kernel>.<counter>``."""
    return {_name(mod, attr): getattr(mod, attr) for mod, attr in _COUNTERS}


def write(values: Dict[str, int]) -> None:
    """Set every counter to ``values`` (a :func:`read`)."""
    for mod, attr in _COUNTERS:
        setattr(mod, attr, values[_name(mod, attr)])


def diff(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    """The launches between two :func:`read`s."""
    return {key: after[key] - before[key] for key in after}


def add(delta: Dict[str, int]) -> None:
    """Count a replay's launches: ``delta`` from :func:`diff`."""
    for mod, attr in _COUNTERS:
        setattr(mod, attr, getattr(mod, attr) + delta[_name(mod, attr)])
