"""The measures the card checks hold the kernels to
(``gofr_tpu_torch/ops/cuda/tolerance.py``), on the CPU: what one flipped
bf16 rounding and what a dropped position score on each. The limits are
those of ``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``: one
bf16 ulp for flash decode, relative L2 2^-8 per row for the ragged kernel.
"""

import math

import numpy as np
import pytest
import torch

from gofr_tpu_torch.ops.cuda import decode_attention as decode_mod
from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod
from gofr_tpu_torch.ops.cuda.tolerance import row_rel_l2, ulp_error

FLASH_DECODE_ULPS = 1.0
RAGGED_ROW_TOL = 2.0 ** -8


def _next_bf16(x: torch.Tensor) -> torch.Tensor:
    """Each element's bf16 neighbour away from zero."""
    bits = x.bfloat16().view(torch.int16)
    return (bits + 1).view(torch.bfloat16)


def test_ulp_error_counts_one_flipped_rounding_as_one_ulp():
    ref = torch.tensor([0.75, -0.3, 1.5, 3.0, 0.02]).bfloat16()
    assert ulp_error(ref, ref) == 0.0
    assert ulp_error(_next_bf16(ref), ref) == 1.0
    # below the floor, the floor's ulp is the unit
    tiny = torch.tensor([1e-4]).bfloat16()
    assert ulp_error(tiny + 2.0 ** -15, tiny) == pytest.approx(1.0, rel=0.1)
    assert math.isnan(ulp_error(torch.tensor([float("nan")]), ref[:1]))


def test_row_rel_l2_is_per_row():
    ref = torch.ones((2, 1, 4, 8))
    out = ref.clone()
    out[1, 0, 0, 0] += 0.5        # one element of the second row
    assert row_rel_l2(out, ref) == pytest.approx(0.5 / math.sqrt(32))
    assert row_rel_l2(ref, ref) == 0.0


@pytest.mark.parametrize("fill", [129, 700, 2047])
def test_a_dropped_position_fails_the_ragged_row_limit(fill):
    """The ragged plain version at ``fill - 1`` is what a kernel that skips
    the last position gives: it must fail the row limit."""
    page, hkv, hq, width = 32, 8, 32, 64
    n_pages = -(-fill // page)
    gen = torch.Generator().manual_seed(fill)
    k_pages, v_pages = (torch.randn((n_pages + 1, page, hkv, 128),
                                    generator=gen).bfloat16()
                        for _ in range(2))
    q = torch.randn((1, 5, hq, 128), generator=gen).bfloat16()
    k_new, v_new = (torch.randn((1, 5, hkv, 128), generator=gen).bfloat16()
                    for _ in range(2))
    table = np.full((1, width), n_pages + 1, np.int32)
    table[0, :n_pages] = np.arange(n_pages)
    args = (q, k_pages, v_pages, torch.from_numpy(table), k_new, v_new)
    ref = ragged_mod.ragged_paged_verify_attention_plain(
        *args, torch.tensor([fill], dtype=torch.int32))
    short = ragged_mod.ragged_paged_verify_attention_plain(
        *args, torch.tensor([fill - 1], dtype=torch.int32))
    assert row_rel_l2(short, ref) > RAGGED_ROW_TOL


@pytest.mark.parametrize("fill", [129, 1500, 2047])
def test_a_dropped_position_fails_the_flash_decode_limit(fill):
    gen = torch.Generator().manual_seed(fill)
    k, v = (torch.randn((1, 2048, 8, 128), generator=gen).bfloat16()
            for _ in range(2))
    q = torch.randn((1, 1, 32, 128), generator=gen).bfloat16()
    k_new, v_new = (torch.randn((1, 8, 128), generator=gen).bfloat16()
                    for _ in range(2))
    ref = decode_mod.flash_decode_attention_plain(
        q, k, v, k_new, v_new, torch.tensor([fill], dtype=torch.int32))
    short = decode_mod.flash_decode_attention_plain(
        q, k, v, k_new, v_new, torch.tensor([fill - 1], dtype=torch.int32))
    assert ulp_error(short, ref) > FLASH_DECODE_ULPS
