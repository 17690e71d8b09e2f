"""The process's one CUDA-graph capture turn, its side stream, and the
capture itself, shared by every capturer of the port: the generation
engine's ticks and prefill rungs and the executor's buckets.

- :data:`_CAPTURE_TURN`: captures take turns process-wide.
  ``torch.cuda.graph`` synchronizes the device as it begins a capture,
  and a device sync while another thread's stream captures fails
  (``cudaErrorStreamCaptureUnsupported``), so two capturers (engines of
  a fleet, a shadow clone beside its source, an executor beside an
  engine) never capture at once.
- :func:`side_stream`: the one stream every capture on a device runs its
  eager run and its capture on. cuBLAS keeps a workspace for each
  (thread's handle, stream) pair it meets, so a stream a capture would
  leave it dozens of MiB each.
- :func:`no_collection`: the turn, with Python's cyclic collector off
  inside it. A collection run inside a capture, on the capturing thread,
  could free another object's graphs mid-capture, which invalidates the
  capture.
- :func:`record`: an eager run on the side stream under
  ``set_sync_debug_mode("error")`` (kernels built and their attributes
  set, cuBLAS / cuDNN algorithms and workspaces chosen outside the
  capture, and a host sync raises), then the capture on the same stream,
  in the turn; the capture's launch counts become the graph's.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Any, Callable, Dict, Tuple

import torch

from gofr_tpu_torch.ops.cuda import launch_counts

__all__ = ["no_collection", "record", "side_stream"]

# the process's one capture turn (any capturer, any thread: one at a
# time), and whether a capture is open: set while the turn holds the
# cyclic collector off, a window inside the one the turn's lock is held
_CAPTURE_TURN = threading.Lock()
_CAPTURES = {"open": 0}
# the side stream every capture runs on, by device index
_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one stream the captures on ``device`` run their eager run and
    their capture on (taken in the capture turn)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = _SIDE_STREAMS.get(index)
    if stream is None:
        stream = _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return stream


@contextlib.contextmanager
def no_collection():
    """Hold the process's one capture turn, with Python's cyclic collector
    off (see the module docstring)."""
    with _CAPTURE_TURN:
        enabled = gc.isenabled()
        gc.disable()
        _CAPTURES["open"] = 1
        try:
            yield
        finally:
            _CAPTURES["open"] = 0
            if enabled:
                gc.enable()


def record(device: torch.device, pool: Any, eager: Callable[[], Any],
           body: Callable[[], Any], after: "torch.cuda.Stream" = None
           ) -> Tuple["torch.cuda.CUDAGraph", Any, Dict[str, int]]:
    """Capture ``body()`` as a CUDA graph into the graph pool ``pool``, in
    the capture turn on the side stream, after ``eager()`` ran there under
    ``set_sync_debug_mode("error")``. The side stream first waits for
    ``after`` (default: ``device``'s current stream), and ``after`` waits
    for the eager run, so the capture sees the state the caller's stream
    left and the caller's next work sees the eager run's. Returns (graph,
    its static output, the launches the capture counted)."""
    after = after if after is not None else torch.cuda.current_stream(device)
    with no_collection():
        side = side_stream(device)
        side.wait_stream(after)
        with torch.cuda.stream(side):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                eager()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        after.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with launch_counts.capture() as launches, torch.cuda.graph(
                graph, pool=pool, stream=side,
                capture_error_mode="thread_local"):
            out = body()
    return graph, out, launches
