"""Hand-written CUDA kernels for Hopper (counterpart of
``gofr_tpu/ops/pallas``): one module per kernel holding its wrapper, its
plain PyTorch version and its launch count, and ``_build`` which compiles
``gofr_tpu_torch/csrc`` at first use. Import the modules themselves (their
names are not shadowed by re-exported functions here)."""
