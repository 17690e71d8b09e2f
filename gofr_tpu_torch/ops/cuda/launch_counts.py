"""The kernel wrappers' launch counters, read and moved together.

Each wrapper adds one to its counter where it launches its kernel. A
replayed CUDA graph launches its kernels without a Python call, so the
engine records each graph's counter deltas at capture (:func:`capture`:
a capture launches nothing) and adds them on every replay with
:func:`add`. Captures take turns (one in the process at a time), but
other engines' threads replay meanwhile: their :func:`add` calls are
held aside while a capture counts, and land when it ends.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional

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


_LOCK = threading.Lock()
# while a capture counts: the launches other threads' replays added
_held: Optional[Dict[str, int]] = None


@contextlib.contextmanager
def capture() -> Iterator[Dict[str, int]]:
    """Count the launches the calling thread makes inside the block (a
    graph capture: the wrappers it calls add to the counters): the dict
    yielded holds them once the block ends, and the counters are left as
    they were before it, plus the replays other threads added
    meanwhile."""
    global _held
    with _LOCK:
        before = read()
        _held = dict.fromkeys(before, 0)
    launches: Dict[str, int] = {}
    try:
        yield launches
    finally:
        with _LOCK:
            launches.update(diff(read(), before))
            held, _held = _held, None
            write({key: before[key] + held[key] for key in before})


def add(delta: Dict[str, int]) -> None:
    """Count a replay's launches: ``delta`` from :func:`diff`."""
    with _LOCK:
        if _held is not None:
            for key, n in delta.items():
                _held[key] += n
            return
        for mod, attr in _COUNTERS:
            setattr(mod, attr, getattr(mod, attr) + delta[_name(mod, attr)])
