"""The ragged kernel's split of each slot's positions across a cluster of
8 blocks, on the CPU: the chunk rule (``ragged_paged_attention.rank_pages``,
the kernel's ``rank_chunk`` in Python), and the split algorithm written
out in plain PyTorch as ``csrc/ragged_paged_attention.cu`` computes it —
each rank's scores, max ``m_r`` and sum of ``exp(s - m_r)``, the ranks'
statistics folded in rank order with the new tokens' scores,
``exp(s - m) / l`` once a score with the oracle's rounding, each rank's
P·V and the rank-order combine with the oracle's roundings — against the unsplit
plain version ``ragged_paged_verify_attention_plain``, over bf16 and int8
pools, and at one small case against the JAX package's Pallas kernel
(interpret mode).

Bounds: float32 ``atol=rtol=2e-6`` (the same sums regrouped by rank:
float32 rounding noise only); bf16 and int8 pools, the card checks'
limits (``chip_smoke.RAGGED_TOL`` per element, ``RAGGED_ROW_TOL``
relative L2 per output row), since a regrouped float32 sum can flip one
of the oracle's bf16 roundings.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import RAGGED_ROW_TOL, RAGGED_TOL
from gofr_tpu.ops.pallas import ragged_paged_verify_attention as jax_verify
from gofr_tpu_torch.ops.attention import _snap
from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod
from gofr_tpu_torch.ops.cuda.ragged_paged_attention import (
    CLUSTER, rank_pages, ragged_paged_verify_attention_plain)
from gofr_tpu_torch.ops.cuda.tolerance import row_rel_l2
from gofr_tpu_torch.ops.quant import quantize_kv

LENS = [0, 1, 7, 8, 9, 31, 32, 33, 255, 256, 257, 2047, 2048]
PAGES = [16, 32]
NEG_INF = -1e30


@pytest.mark.parametrize("page", PAGES)
@pytest.mark.parametrize("length", LENS)
def test_rank_pages_cover_the_fill_once_in_whole_pages(length, page):
    chunks = rank_pages(length, page)
    assert len(chunks) == CLUSTER
    pages = -(-length // page)
    # page-aligned runs in rank order, together every live page once
    assert [p for chunk in chunks for p in chunk] == list(range(pages))
    per_rank = -(-pages // CLUSTER)
    for rank, chunk in enumerate(chunks):
        assert len(chunk) <= per_rank
        if len(chunk):
            assert chunk.start == rank * per_rank
    # positions: [start * page, min(stop * page, length)) cover [0, length)
    covered = [t for chunk in chunks
               for t in range(chunk.start * page,
                              min(chunk.stop * page, length))]
    assert covered == list(range(length))
    # ranks past the fill are empty, and only they
    busy = [len(chunk) > 0 for chunk in chunks]
    assert busy == sorted(busy, reverse=True)
    assert sum(busy) == (-(-pages // per_rank) if pages else 0)


def test_rank_pages_at_the_engine_fills():
    """Page 32: fill 2047 gives 8 pages a rank; a 544-token slot keeps 6
    ranks busy; fill 33 keeps 2."""
    assert [len(c) for c in rank_pages(2047, 32)] == [8] * 8
    assert [len(c) for c in rank_pages(544, 32)] == [3, 3, 3, 3, 3, 2, 0, 0]
    assert [len(c) for c in rank_pages(33, 32)] == [1, 1, 0, 0, 0, 0, 0, 0]
    assert all(len(c) == 0 for c in rank_pages(0, 32))


def _split_verify(q, k_pages, v_pages, table, k_new, v_new, cache_len,
                  k_scale=None, v_scale=None):
    """The kernel's split algorithm in plain PyTorch, float32 with the
    oracle's rounding points at q's dtype."""
    batch, g_len, q_heads, head_dim = q.shape
    num_pages, page, kv_heads, _ = k_pages.shape
    group = q_heads // kv_heads
    dt = q.dtype
    scale = head_dim ** -0.5
    qg = q.float().reshape(batch, g_len, kv_heads, group, head_dim)
    causal = torch.arange(g_len)[None, :] <= torch.arange(g_len)[:, None]
    out = torch.empty(batch, g_len, kv_heads, group, head_dim)
    for b in range(batch):
        n = min(int(cache_len[b]), table.shape[1] * page)
        ids = table[b].long().clamp(0, num_pages - 1)
        ranks = []                       # (scores, V rows, V scales)
        for chunk in rank_pages(n, page):
            pos = torch.tensor(range(chunk.start * page,
                                     min(chunk.stop * page, n)),
                               dtype=torch.long)
            pid, off = ids[pos // page], pos % page
            s = _snap(torch.einsum("skgd,tkd->kgst", qg[b],
                                   k_pages[pid, off].float()), dt) * scale
            vs = None
            if k_scale is not None:
                s = s * k_scale[pid, off].T[:, None, None, :]
                vs = v_scale[pid, off].T[:, None, None, :]
            ranks.append((s, v_pages[pid, off].float(), vs))
        s_new = _snap(torch.einsum("skgd,ukd->kgsu", qg[b],
                                   k_new[b].float()), dt) * scale
        s_new = torch.where(causal, s_new, NEG_INF)
        # each rank's statistics: its max m_r (empty: -1e30) and the sum
        # of exp(s - m_r); the final max: the ranks', then the new keys'
        stats = []
        for s, _, _ in ranks:
            m_r = s.amax(-1) if s.shape[-1] else torch.full(
                (kv_heads, group, g_len), NEG_INF)
            stats.append((m_r, torch.exp(s - m_r[..., None]).sum(-1)))
        m = torch.full((kv_heads, group, g_len), NEG_INF)
        for m_r, _ in stats:
            m = torch.maximum(m, m_r)
        m = torch.maximum(m, s_new.amax(-1))
        # the final sum: the ranks' rescaled in rank order, then the new
        # keys' terms; exp(s - m) once a score
        l_sum = torch.zeros_like(m)
        for m_r, l_r in stats:
            l_sum = l_sum + l_r * torch.exp(m_r - m)
        e_new = torch.exp(s_new - m[..., None])
        l_sum = l_sum + e_new.sum(-1)
        exps = [torch.exp(s - m[..., None]) for s, _, _ in ranks]
        # each rank's P.V, summed in rank order
        cache = torch.zeros(kv_heads, group, g_len, head_dim)
        for e, (_, v, vs) in zip(exps, ranks):
            p = e / l_sum[..., None]
            p = _snap(p, dt) if vs is None else p * vs
            cache = cache + torch.einsum("kgst,tkd->kgsd", p, v)
        p_new = _snap(e_new / l_sum[..., None], dt)
        new = _snap(torch.einsum("kgsu,ukd->kgsd", p_new, v_new[b].float()),
                    dt)
        out[b] = _snap(_snap(cache, dt) + new, dt).permute(2, 0, 1, 3)
    return out.reshape(batch, g_len, q_heads, head_dim).to(dt)


def _scenario(fills, g_len, group, page, pools, seed=0, kv_heads=2,
              head_dim=32, width=None):
    """Numpy inputs from a seed: pools with each slot's pages scattered,
    sentinel table tails, and NaN in every row no live position
    references (and in its scales, for int8 pools). ``pools`` is "f32",
    "bf16" or "int8" (int8 K/V with bf16 queries and new tokens)."""
    rng = np.random.default_rng(seed)
    batch = len(fills)
    width = width or -(-max(fills + [1]) // page)
    used = sum(-(-n // page) for n in fills)
    num_pages = used + 3
    table = np.full((batch, width), num_pages, np.int32)
    live = np.zeros((num_pages, page), bool)
    order = rng.permutation(num_pages)
    nxt = 0
    for row, n in enumerate(fills):
        for col in range(-(-n // page)):
            pid = int(order[nxt])
            nxt += 1
            table[row, col] = pid
            live[pid, :min(page, n - col * page)] = True
    shape = (num_pages, page, kv_heads, head_dim)
    k_pages, v_pages = (rng.standard_normal(shape).astype(np.float32)
                        for _ in range(2))
    q = rng.standard_normal((batch, g_len, kv_heads * group, head_dim))
    k_new, v_new = (rng.standard_normal((batch, g_len, kv_heads, head_dim))
                    for _ in range(2))
    dt = torch.float32 if pools == "f32" else torch.bfloat16
    q, k_new, v_new = (torch.from_numpy(x.astype(np.float32)).to(dt)
                       for x in (q, k_new, v_new))
    dead = torch.from_numpy(~live)
    scales = []
    if pools == "int8":
        (kp, ks), (vp, vs) = (quantize_kv(torch.from_numpy(x))
                              for x in (k_pages, v_pages))
        scales = [s.masked_fill(dead[..., None], float("nan"))
                  for s in (ks, vs)]
    else:
        kp, vp = (torch.from_numpy(x).to(dt).masked_fill(
            dead[..., None, None], float("nan")) for x in (k_pages, v_pages))
    return [q, kp, vp, torch.from_numpy(table), k_new, v_new,
            torch.tensor(fills, dtype=torch.int32)] + scales


def _fills(page):
    """LENS and the chunk edges of this page size (8 pages: one a rank)."""
    edge = CLUSTER * page
    return sorted(set(LENS) | {edge - 1, edge, edge + 1})


@pytest.mark.parametrize("page", PAGES)
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("g_len", [1, 2, 5])
def test_split_algorithm_matches_the_plain_version_f32(g_len, group, page):
    args = _scenario(_fills(page), g_len, group, page, "f32",
                     seed=g_len * 10 + group)
    want = ragged_paged_verify_attention_plain(*args)
    got = _split_verify(*args)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("page", PAGES)
@pytest.mark.parametrize("pools", ["bf16", "int8"])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("g_len", [1, 2, 5])
def test_split_algorithm_matches_the_plain_version(g_len, group, pools,
                                                   page):
    args = _scenario(_fills(page), g_len, group, page, pools,
                     seed=100 + g_len * 10 + group)
    want = ragged_paged_verify_attention_plain(*args)
    got = _split_verify(*args)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= RAGGED_TOL
    assert row_rel_l2(got, want) <= RAGGED_ROW_TOL


def test_split_algorithm_matches_the_pallas_kernel():
    """One small case against the JAX package's kernel in interpret mode
    (bf16, G 2, group 2, page 16, fills on the chunk edges): whole pages
    no slot references are NaN, the only poisoning the JAX kernel is safe
    from."""
    page, fills = 16, [0, 1, 17, 127, 128, 129, 256]
    args = _scenario(fills, 2, 2, page, "bf16", seed=7, head_dim=16)
    q, kp, vp, table, kn, vn, lens = args
    pages = torch.zeros(kp.shape[0], dtype=torch.bool)
    pages[table[table < kp.shape[0]].long()] = True
    kp, vp = (x.nan_to_num().masked_fill(~pages[:, None, None, None],
                                         float("nan")) for x in (kp, vp))
    got = _split_verify(q, kp, vp, table, kn, vn, lens)
    to_jax = [jnp.asarray(x.float().numpy(), jnp.bfloat16)
              for x in (q, kp, vp)]
    kernel = jax_verify(*to_jax, jnp.asarray(table.numpy()),
                        *[jnp.asarray(x.float().numpy(), jnp.bfloat16)
                          for x in (kn, vn)],
                        jnp.asarray(lens.numpy()), interpret=True)
    ref = torch.from_numpy(np.asarray(kernel, np.float32))
    assert torch.isfinite(ref).all() and torch.isfinite(got).all()
    assert (got.float() - ref).abs().max().item() <= RAGGED_TOL
    assert row_rel_l2(got, ref) <= RAGGED_ROW_TOL


def test_wrapper_refuses_a_table_whose_chunk_does_not_fit_shared_memory():
    """A rank keeps its chunk's scores in shared memory: the wrapper
    refuses a table too wide for it before any launch."""
    args = _scenario([40], 1, 8, 32, "bf16", head_dim=128, width=2)
    q, kp, vp, _, kn, vn, lens = args
    width = 8 * (ragged_mod.MAX_DYN_SMEM // (32 * 8 * 4)) + 8
    table = torch.full((1, width), kp.shape[0], dtype=torch.int32)
    assert ragged_mod.dyn_smem_bytes(width, 32, 8, 1, 128) \
        > ragged_mod.MAX_DYN_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        ragged_mod._check(q, kp, vp, table, kn, vn, lens)
