"""PyTorch/CUDA port of the gofr_tpu Llama ``/generate`` path.

A second package beside ``gofr_tpu`` (the JAX reference, left as it is).
It imports ``torch`` and never ``jax`` or anything of ``gofr_tpu``: what it
needs from there it keeps as its own copy. Every entry point takes an
explicit ``device`` that defaults to ``"cuda"`` and raises when CUDA is
missing; the CPU is used only when the caller asks for it, as the tests
do. Each TPU Pallas kernel on the path has a hand-written CUDA C++ kernel
for Hopper (``csrc/``), with its plain PyTorch version beside the wrapper
(``ops/cuda/``).
"""

from gofr_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
