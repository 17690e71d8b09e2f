"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked ``cuda``: each test skips itself on a host without a CUDA
device (they cannot run anywhere else — a CUDA kernel has no interpret
mode). Run them on the GPU host with
``python -m pytest tests/test_torch_cuda_kernels.py -q``.

Bounds: bf16 outputs within 2e-2 absolute of the plain version (one
bf16 ulp at |x| <= 2, plus float32 sum-order noise); float32 within 2e-5.
"""

import numpy as np
import pytest
import torch

from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod
from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("seq", [1, 37, 128, 300])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 2e-5)])
def test_flash_kernel_matches_plain(cuda, seq, causal, dtype, tol):
    gen = torch.Generator(device=cuda).manual_seed(seq)
    q, k, v = (torch.randn((2, seq, heads, 128), generator=gen, device=cuda)
               .to(dtype) for heads in (8, 2, 2))
    before = flash_mod.launches
    out = flash_mod.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_mod.launches == before + 1
    ref = flash_mod.flash_attention_plain(q, k, v, causal=causal)
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_ragged_kernel_matches_plain_and_skips_poison(cuda):
    num_pages, page, hkv, group, width = 40, 32, 2, 4, 8
    fills = [0, 1, 31, 32, 33, 100, 255]
    gen = torch.Generator(device=cuda).manual_seed(0)
    shape = (num_pages, page, hkv, 128)
    k_pages = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    v_pages = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    b = len(fills)
    q = torch.randn((b, 1, hkv * group, 128), generator=gen,
                    device=cuda).bfloat16()
    k_new, v_new = (torch.randn((b, hkv, 128), generator=gen, device=cuda)
                    .bfloat16() for _ in range(2))
    table = np.full((b, width), num_pages, np.int32)
    nxt = 0
    live = np.zeros((num_pages, page), bool)
    for row, n in enumerate(fills):
        for col in range(-(-n // page)):
            table[row, col] = nxt
            live[nxt, :min(page, n - col * page)] = True
            nxt += 1
    poison = torch.from_numpy(~live).to(cuda)[..., None, None]
    k_pages = k_pages.masked_fill(poison, float("nan"))
    v_pages = v_pages.masked_fill(poison, float("nan"))
    args = (q, k_pages, v_pages, torch.from_numpy(table).to(cuda), k_new,
            v_new, torch.tensor(fills, dtype=torch.int32, device=cuda))
    out = ragged_mod.ragged_paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = ragged_mod.ragged_paged_decode_attention_plain(*args)
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
