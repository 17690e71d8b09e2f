"""Neural-net ops in plain PyTorch: norms, rotary embeddings, attention,
int8 matmul and sampling (counterpart of ``gofr_tpu/ops``). The CUDA
kernels and their wrappers live in ``gofr_tpu_torch.ops.cuda``."""
