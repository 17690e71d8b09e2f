"""PyTorch/CUDA port of gofr_tpu: the microservice framework (``App``:
HTTP, gRPC, the CLI, websockets, pub/sub and cron around one
``Container``), the Llama ``/generate`` engine, the executor path and
training, with the examples under ``examples/``.

A second package beside ``gofr_tpu`` (the JAX reference, left as it is).
It imports ``torch`` and never ``jax`` or anything of ``gofr_tpu``: what it
needs from there it keeps as its own copy. Every entry point takes an
explicit ``device`` that defaults to ``"cuda"`` and raises when CUDA is
missing; the CPU is used only when the caller asks for it, as the tests
do. Each TPU Pallas kernel on the path has a hand-written CUDA C++ kernel
for Hopper (``csrc/``), with its plain PyTorch version beside the wrapper
(``ops/cuda/``). Importing the package touches no card and builds nothing.
"""

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.version import FRAMEWORK_VERSION
from gofr_tpu_torch.app import App, new_app, new_cmd
from gofr_tpu_torch.context import Context

__all__ = ["App", "Context", "new_app", "new_cmd", "FRAMEWORK_VERSION",
           "resolve_device"]
__version__ = FRAMEWORK_VERSION
