"""The ragged kernel's head_dim-64 body, on the CPU: its split
(``ragged_paged_attention.d64_ranks`` and ``d64_rank_sweeps``, the
kernel's ``d64::ranks_for`` and rank walk in Python), which body a launch
takes (``d64_body``), and the split algorithm written out in plain
PyTorch as ``csrc/ragged_paged_attention.cu`` computes it — a cluster of
``ceil(P * page / 512)`` blocks (at most 8) sized by the table; sweep
``k`` of a slot is positions ``[512 k, 512 (k + 1))`` below the fill, and
rank ``r`` walks sweeps ``r, r + ranks, ...``; each sweep's max and sum
of ``exp(s - m)``, folded into the rank's ``(M, L)`` in sweep order; the
ranks' folded in rank order, then the new tokens' scores;
``exp(s - m) / l`` once a score with the oracle's rounding; the sweeps'
P·V summed into the rank's partial, the ranks' partials in rank order,
and the oracle's roundings — against the unsplit plain version
``ragged_paged_verify_attention_plain``. The split depends on the fill,
not the table's width: the model gives the same bits over a dense
cache's identity table and a paged table. A launch of more than 8 query
rows a KV head (group x G > 8) takes the cluster-of-8 body
(``rank_pages``, one sweep a rank), and the same model checks that
split. One small case is held to the JAX package's Pallas kernel
(interpret mode).

Bounds: float32 ``atol=rtol=2e-6`` (the same sums regrouped by rank and
sweep: float32 rounding noise only); bf16 and int8 pools, the card
checks' limits (``chip_smoke.RAGGED_TOL`` per element, ``RAGGED_ROW_TOL``
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
    D64_MAX_RANKS, D64_MAX_ROWS, D64_SPAN, d64_body, d64_rank_sweeps,
    d64_ranks, rank_pages, ragged_paged_verify_attention_plain)
from gofr_tpu_torch.ops.cuda.tolerance import row_rel_l2
from gofr_tpu_torch.ops.quant import quantize_kv

NEG_INF = -1e30
HEAD_DIM = 64
# table widths at each page: `small`'s paged table (1024 positions, 2
# ranks of one sweep), one wider than 4096 positions (8 ranks, the first
# of two sweeps) and the dense engine's rung 256 (one rank)
TABLES = {16: (64, 288, 16), 32: (32, 144, 8)}


def _edges(page, width):
    """Fills at the page and sweep edges of this table, and its last
    position and its whole width."""
    cap = width * page
    edges = {0, 1, page - 1, page, page + 1, cap - 1, cap}
    for k in (1, 2, 8):
        edges |= {k * D64_SPAN - 1, k * D64_SPAN, k * D64_SPAN + 1}
    return sorted(n for n in edges if n <= cap)


@pytest.mark.parametrize("width,page,ranks", [
    (4, 32, 1), (8, 32, 1), (16, 32, 1), (17, 32, 2), (32, 32, 2),
    (64, 32, 4), (72, 32, 5), (144, 32, 8), (640, 32, 8), (1, 16, 1),
    (32, 16, 1), (64, 16, 2), (63, 16, 2), (288, 16, 8), (3, 24, 1),
    (22, 24, 2)])
def test_d64_ranks_follow_the_table_not_the_fill(width, page, ranks):
    """One block per 512 positions of the table, 1 to 8: the dense
    engine's rungs 128-512 (4-16 columns of 32) take one block, `small`'s
    whole table (32 of 32) two."""
    assert d64_ranks(width, page) == ranks
    assert len(d64_rank_sweeps(0, page, width)) == ranks
    assert len(d64_rank_sweeps(width * page, page, width)) == ranks


@pytest.mark.parametrize("page", [16, 24, 32])
@pytest.mark.parametrize("width", [4, 9, 16, 32, 63, 72, 144, 288])
def test_d64_rank_sweeps_cover_the_fill_once(width, page):
    ranks = d64_ranks(width, page)
    for fill in _edges(page, width):
        by_rank = d64_rank_sweeps(fill, page, width)
        # sweep k is [512 k, 512 (k + 1)) below the fill, on rank k mod
        # ranks, each rank's in increasing order
        by_index = {}
        for rank, sweeps in enumerate(by_rank):
            starts = [sw.start for sw in sweeps]
            assert starts == sorted(starts)
            for sw in sweeps:
                k = sw.start // D64_SPAN
                assert sw.start == k * D64_SPAN and k % ranks == rank
                assert len(sw) == min(D64_SPAN, fill - sw.start) > 0
                by_index[k] = sw
        covered = [t for k in sorted(by_index) for t in by_index[k]]
        assert covered == list(range(fill))
        # one sweep a rank while the table holds at most 8 of them
        if width * page <= D64_MAX_RANKS * D64_SPAN:
            assert all(len(sweeps) <= 1 for sweeps in by_rank)


@pytest.mark.parametrize("fill", [0, 1, 300, 511, 512, 513, 1000, 1024])
def test_d64_split_depends_on_the_fill_not_the_table(fill):
    """The sweeps a slot's positions fall in, and their order, are the
    same over every table the fill fits (a dense engine's rung and the
    paged table): the ranks past the fill walk none."""
    page = 32
    widths = [w for w in (4, 8, 16, 32, 64, 128) if w * page >= fill]

    def order(width):
        by_rank = d64_rank_sweeps(fill, page, width)
        return [list(sw) for rank in by_rank for sw in rank]
    assert all(order(w) == order(widths[0]) for w in widths)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("g_len", [1, 2, 3, 5, 8])
def test_body_choice_and_shared_memory(group, g_len):
    """Every decode and every verify of at most 8 rows a KV head takes
    the head_dim-64 body, which takes no dynamic shared memory (no table
    is too wide for it); the rest, and all of head_dim 128, the
    cluster-of-8 body, whose bound is unchanged."""
    rows = group * g_len
    assert d64_body(64, group, g_len) == (rows <= D64_MAX_ROWS)
    assert not d64_body(128, group, g_len)
    if rows <= D64_MAX_ROWS:
        assert ragged_mod.dyn_smem_bytes(4096, 32, group, g_len, 64) == 0
    else:
        per_rank = -(-4096 // ragged_mod.CLUSTER)
        assert ragged_mod.dyn_smem_bytes(4096, 32, group, g_len, 64) == \
            rows * 64 * 6 + rows * per_rank * 32 * 4 + per_rank * 4
    assert ragged_mod.dyn_smem_bytes(64, 32, group, g_len, 128) > 0


def _split_model(q, k_pages, v_pages, table, k_new, v_new, cache_len,
                 k_scale=None, v_scale=None):
    """The kernel's split algorithm for this launch's body, in plain
    PyTorch: float32 with the oracle's rounding points at q's dtype."""
    batch, g_len, q_heads, head_dim = q.shape
    num_pages, page, kv_heads, _ = k_pages.shape
    width = table.shape[1]
    group = q_heads // kv_heads
    dt = q.dtype
    scale = head_dim ** -0.5
    if d64_body(head_dim, group, g_len):
        def ranks_of(n):
            return d64_rank_sweeps(n, page, width)
    else:                            # one sweep a rank, its page chunk
        def ranks_of(n):
            return [[range(c.start * page, min(c.stop * page, n))]
                    if len(c) else [] for c in rank_pages(n, page)]
    qg = q.float().reshape(batch, g_len, kv_heads, group, head_dim)
    causal = torch.arange(g_len)[None, :] <= torch.arange(g_len)[:, None]
    stat_shape = (kv_heads, group, g_len)
    out = torch.empty(batch, g_len, kv_heads, group, head_dim)
    for b in range(batch):
        n = min(int(cache_len[b]), width * page)
        ids = table[b].long().clamp(0, num_pages - 1)
        # every live position's score and V row (each score's dot is its
        # own), then cut into the ranks' sweeps
        pos = torch.arange(n)
        pid, off = ids[pos // page], pos % page
        s_all = _snap(torch.einsum("skgd,tkd->kgst", qg[b],
                                   k_pages[pid, off].float()), dt) * scale
        v_all, vs_all = v_pages[pid, off].float(), None
        if k_scale is not None:
            s_all = s_all * k_scale[pid, off].T[:, None, None, :]
            vs_all = v_scale[pid, off].T[:, None, None, :]
        ranks = []              # (M, L, [(scores, V rows, V scales)])
        for rank in ranks_of(n):
            m_rank = torch.full(stat_shape, NEG_INF)
            l_rank = torch.zeros(stat_shape)
            sweeps = []
            for sweep in rank:
                cut = slice(sweep.start, sweep.stop)
                s = s_all[..., cut]
                # the sweep's (m_s, l_s), folded into the rank's (M, L)
                m_s = s.amax(-1)
                l_s = torch.exp(s - m_s[..., None]).sum(-1)
                m2 = torch.maximum(m_rank, m_s)
                l_rank = l_rank * torch.exp(m_rank - m2) \
                    + l_s * torch.exp(m_s - m2)
                m_rank = m2
                sweeps.append((s, v_all[cut],
                               None if vs_all is None else vs_all[..., cut]))
            ranks.append((m_rank, l_rank, sweeps))
        s_new = _snap(torch.einsum("skgd,ukd->kgsu", qg[b],
                                   k_new[b].float()), dt) * scale
        s_new = torch.where(causal, s_new, NEG_INF)
        # the ranks' in rank order, then the new keys'
        m = torch.full(stat_shape, NEG_INF)
        for m_rank, _, _ in ranks:
            m = torch.maximum(m, m_rank)
        m = torch.maximum(m, s_new.amax(-1))
        l_sum = torch.zeros(stat_shape)
        for m_rank, l_rank, _ in ranks:
            l_sum = l_sum + l_rank * torch.exp(m_rank - m)
        e_new = torch.exp(s_new - m[..., None])
        l_sum = l_sum + e_new.sum(-1)
        # each rank's P.V over its sweeps, the ranks summed in rank order
        cache = torch.zeros(kv_heads, group, g_len, head_dim)
        for _, _, sweeps in ranks:
            part = torch.zeros_like(cache)
            for s, v, vs in sweeps:
                p = torch.exp(s - m[..., None]) / l_sum[..., None]
                p = _snap(p, dt) if vs is None else p * vs
                part = part + torch.einsum("kgst,tkd->kgsd", p, v)
            cache = cache + part
        p_new = _snap(e_new / l_sum[..., None], dt)
        new = _snap(torch.einsum("kgsu,ukd->kgsd", p_new, v_new[b].float()),
                    dt)
        out[b] = _snap(_snap(cache, dt) + new, dt).permute(2, 0, 1, 3)
    return out.reshape(batch, g_len, q_heads, head_dim).to(dt)


def _scenario(fills, g_len, group, page, width, pools, seed=0, kv_heads=1,
              head_dim=HEAD_DIM):
    """Numpy inputs from a seed: pools with each slot's pages scattered,
    sentinel table tails, and NaN in every row no live position references
    (and in its scales, for int8 pools). ``pools`` is "f32", "bf16" or
    "int8" (int8 K/V with bf16 queries and new tokens)."""
    rng = np.random.default_rng(seed)
    batch = len(fills)
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


def _check_split(args):
    want = ragged_paged_verify_attention_plain(*args)
    got = _split_model(*args)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= RAGGED_TOL
    assert row_rel_l2(got, want) <= RAGGED_ROW_TOL


@pytest.mark.parametrize("page", [16, 32])
@pytest.mark.parametrize("pools", ["bf16", "int8"])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("g_len", [1, 2, 5, 8])
def test_d64_split_matches_the_plain_version(g_len, group, pools, page):
    """`small`'s table width at this page (2 ranks of one sweep), every
    fill edge; NaN in every dead row and scale entry never reaches the
    output."""
    width = TABLES[page][0]
    _check_split(_scenario(_edges(page, width), g_len, group, page, width,
                           pools, seed=200 + g_len * 10 + group + page))


@pytest.mark.parametrize("page", [16, 32])
@pytest.mark.parametrize("pools", ["bf16", "int8"])
@pytest.mark.parametrize("group", [1])
@pytest.mark.parametrize("g_len", [1, 5])
def test_d64_split_of_two_sweeps_matches_the_plain_version(g_len, group,
                                                            pools, page):
    """A table wider than 4096 positions: 8 ranks, the first of two
    sweeps, fills on the sweep edges."""
    width = TABLES[page][1]
    _check_split(_scenario(_edges(page, width), g_len, group, page, width,
                           pools, seed=400 + g_len * 10 + group + page))


@pytest.mark.parametrize("page", [16, 32])
@pytest.mark.parametrize("pools", ["bf16", "int8"])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("g_len", [1, 5])
def test_d64_split_of_one_rank_matches_the_plain_version(g_len, group,
                                                          pools, page):
    """A table of 256 positions (the dense engine's rung 256): one rank,
    no cluster."""
    width = TABLES[page][2]
    assert d64_ranks(width, page) == 1
    _check_split(_scenario(_edges(page, width), g_len, group, page, width,
                           pools, seed=500 + g_len * 10 + group + page))


@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("g_len", [1, 5])
def test_d64_split_matches_the_plain_version_f32(g_len, group):
    """float32 pools over the two-sweep table: the regrouped sums within
    float32 noise of the unsplit plain version."""
    page, width = 16, 288
    args = _scenario(_edges(page, width), g_len, group, page, width, "f32",
                     seed=300 + g_len * 10 + group)
    want = ragged_paged_verify_attention_plain(*args)
    got = _split_model(*args)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("pools", ["bf16", "int8"])
def test_d64_split_gives_the_same_bits_over_any_table(pools):
    """The model over one set of pages through tables of 32, 64 and 288
    columns of 16 (1, 2 and 8 ranks): the same bits, as the dense and the
    paged engine need."""
    page, fills = 16, [0, 1, 300, 511, 512]
    args = _scenario(fills, 5, 1, page, 32, pools, seed=11)
    outs = []
    for width in (32, 64, 288):
        table = torch.full((len(fills), width), args[1].shape[0],
                           dtype=torch.int32)
        table[:, :32] = args[3]
        outs.append(_split_model(*args[:3], table, *args[4:]))
    assert all(torch.equal(o.view(torch.int16), outs[0].view(torch.int16))
               for o in outs)


def test_d64_split_g1_is_the_decode_plain_version():
    """At G = 1 the model of the verify launch is the decode plain
    version's function (the kernel's two instantiations share every fold
    order)."""
    page, width = 32, 32
    args = _scenario(_edges(page, width), 1, 1, page, width, "bf16", seed=5)
    q, kp, vp, table, kn, vn, lens = args
    want = ragged_mod.ragged_paged_decode_attention_plain(
        q, kp, vp, table, kn[:, 0], vn[:, 0], lens)
    got = _split_model(*args)
    assert (got.float() - want.float()).abs().max().item() <= RAGGED_TOL
    assert row_rel_l2(got, want) <= RAGGED_ROW_TOL


def test_d64_split_matches_the_pallas_kernel():
    """One small case against the JAX package's kernel in interpret mode
    (bf16, G 5, group 1 as `small` verifies, page 16, a table of 40
    columns: two ranks of a sweep), fills on the page and sweep edges:
    whole pages no slot references are NaN, the only poisoning the JAX
    kernel is safe from."""
    page, width = 16, 40
    fills = [0, 1, 15, 16, 511, 512, 513, 639]
    args = _scenario(fills, 5, 1, page, width, "bf16", seed=9)
    q, kp, vp, table, kn, vn, lens = args
    assert d64_ranks(width, page) == 2
    pages = torch.zeros(kp.shape[0], dtype=torch.bool)
    pages[table[table < kp.shape[0]].long()] = True
    kp, vp = (x.nan_to_num().masked_fill(~pages[:, None, None, None],
                                         float("nan")) for x in (kp, vp))
    got = _split_model(q, kp, vp, table, kn, vn, lens)
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
