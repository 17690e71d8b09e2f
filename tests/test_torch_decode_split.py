"""The flash-decode kernel's split of the positions across blocks, on the
CPU: the wrapper's chunk size, split count and scratch shape
(``decode_attention.split_plan`` / ``scratch_shape``), and the split
algorithm itself written out in plain PyTorch (each chunk's online
softmax from a fresh state, then the combine in chunk order and the new
token last, as ``csrc/decode_attention.cu`` does) against the unsplit
plain version ``flash_decode_attention_plain``.

Bound for the split algorithm: ``atol=rtol=2e-6`` at float32 (the same
sums regrouped by chunk: float32 rounding noise only).
"""

import numpy as np
import pytest
import torch

from gofr_tpu_torch.ops.cuda import decode_attention as decode_mod
from gofr_tpu_torch.ops.cuda.decode_attention import (
    BLOCK_K, CHUNK, MAX_SPLITS, SUPPORTED_HEAD_DIMS,
    flash_decode_attention_plain, scratch_shape, split_plan)

HEAD_DIM = 128

WIDTHS = {128: (256, 1), 129: (256, 1), 2048: (256, 8), 4096: (256, 16)}


@pytest.mark.parametrize("t_max", sorted(WIDTHS))
def test_split_plan_at_the_engine_widths(t_max):
    assert split_plan(t_max) == WIDTHS[t_max]


@pytest.mark.parametrize("t_max", [1, 127, 128, 129, 255, 256, 257, 1000,
                                   2047, 2048, 2049, 4096, 4097, 8192,
                                   32768])
def test_split_plan_covers_the_width_in_whole_blocks(t_max):
    chunk, splits = split_plan(t_max)
    assert chunk % BLOCK_K == 0 and chunk >= CHUNK
    assert 1 <= splits <= MAX_SPLITS
    # every chunk starts inside the width, and together they cover it
    assert (splits - 1) * chunk < t_max <= splits * chunk
    if splits * CHUNK >= t_max and t_max <= MAX_SPLITS * CHUNK:
        assert chunk == CHUNK          # the default whenever it fits


@pytest.mark.parametrize("head_dim", SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("t_max", sorted(WIDTHS))
@pytest.mark.parametrize("group", [1, 4, 8])
def test_scratch_shape_holds_one_partial_per_chunk(t_max, group, head_dim):
    shape = scratch_shape(8, t_max, 8, group, head_dim)
    assert shape == (8, 8, WIDTHS[t_max][1], group, head_dim + 2)


def test_split_plan_refuses_an_empty_cache():
    with pytest.raises(ValueError, match="positive"):
        split_plan(0)


def _split_decode(q, k_cache, v_cache, k_new, v_new, cache_len):
    """The kernel's split algorithm in plain PyTorch (float32)."""
    batch, _, q_heads, head_dim = q.shape
    t_max, kv_heads = k_cache.shape[1], k_cache.shape[2]
    group = q_heads // kv_heads
    chunk, splits = split_plan(t_max)
    qs = q[:, 0].float().reshape(batch, kv_heads, group, head_dim) \
        * head_dim ** -0.5
    out = torch.empty(batch, kv_heads, group, head_dim)
    for b in range(batch):
        n = int(cache_len[b])
        parts = []                                   # (m, l, acc) by chunk
        for first in range(0, min(n, t_max), chunk):
            m = torch.full((kv_heads, group, 1), -1e30)
            l = torch.zeros((kv_heads, group, 1))
            acc = torch.zeros((kv_heads, group, head_dim))
            for start in range(first, min(first + chunk, n), BLOCK_K):
                stop = min(start + BLOCK_K, n)
                k_blk = k_cache[b, start:stop].float()         # (t, Hkv, D)
                v_blk = v_cache[b, start:stop].float()
                scores = torch.einsum("kgd,tkd->kgt", qs[b], k_blk)
                m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
                p = torch.exp(scores - m_new)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + torch.einsum("kgt,tkd->kgd", p, v_blk)
                m = m_new
            parts.append((m, l, acc))
        assert len(parts) <= splits
        m_all = torch.full((kv_heads, group, 1), -1e30)
        for m, _, _ in parts:
            m_all = torch.maximum(m_all, m)
        l_all = torch.zeros((kv_heads, group, 1))
        acc_all = torch.zeros((kv_heads, group, head_dim))
        for m, l, acc in parts:
            e = torch.exp(m - m_all)
            l_all = l_all + l * e
            acc_all = acc_all + acc * e
        s_new = (qs[b] * k_new[b].float()[:, None, :]).sum(-1, keepdim=True)
        m_fin = torch.maximum(m_all, s_new)
        c = torch.exp(m_all - m_fin)
        p_new = torch.exp(s_new - m_fin)
        l_fin = torch.clamp_min(l_all * c + p_new, 1e-30)
        out[b] = (acc_all * c + p_new * v_new[b].float()[:, None, :]) / l_fin
    return out.reshape(batch, 1, q_heads, head_dim)


def _scenario(t_max, fills, seed=0, hq=8, hkv=2, head_dim=HEAD_DIM):
    rng = np.random.default_rng(seed)
    b = len(fills)
    q = torch.from_numpy(rng.standard_normal((b, 1, hq, head_dim))
                         .astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, t_max, hkv, head_dim))
                             .astype(np.float32)) for _ in range(2))
    lens = torch.tensor(fills, dtype=torch.int32)
    for row, n in enumerate(fills):       # rows past each fill poisoned
        k[row, n:] = float("nan")
        v[row, n:] = float("nan")
    k_new, v_new = (torch.from_numpy(rng.standard_normal((b, hkv, head_dim))
                                     .astype(np.float32)) for _ in range(2))
    return q, k, v, k_new, v_new, lens


@pytest.mark.parametrize("t_max,fills", [
    (128, [0, 1, 127, 128]),
    (129, [0, 128, 129, 64]),
    (2048, [0, 255, 256, 257, 2047, 2048]),
    (4096, [1, 2048, 4000, 4096])])
@pytest.mark.parametrize("head_dim", SUPPORTED_HEAD_DIMS)
def test_split_algorithm_matches_the_plain_version(t_max, fills, head_dim):
    args = _scenario(t_max, fills, seed=t_max, head_dim=head_dim)
    want = flash_decode_attention_plain(*args)
    got = _split_decode(*args)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-6, rtol=2e-6)


def test_wrapper_on_cpu_allocates_no_scratch_and_launches_nothing():
    args = _scenario(300, [0, 1, 299], seed=3)
    before = decode_mod.launches
    out = decode_mod.flash_decode_attention(*args)
    assert decode_mod.launches == before
    torch.testing.assert_close(out, flash_decode_attention_plain(*args),
                               rtol=0, atol=0)
