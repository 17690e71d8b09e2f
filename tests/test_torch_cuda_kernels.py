"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked ``cuda``: each test skips itself on a host without a CUDA
device (they cannot run anywhere else — a CUDA kernel has no interpret
mode). Run them on the GPU host with
``python -m pytest tests/test_torch_cuda_kernels.py -q``.

Bounds: flash bf16 outputs within 2e-2 absolute of the plain version
(one bf16 ulp at |x| <= 2, plus float32 sum-order noise and the bf16
rounding of P before P.V on the tensor cores), float32 within 2e-5. The ragged kernel, which keeps its plain version's bf16 roundings:
each element within 2e-2 and each output row (every head of one query of
one slot) within relative L2 2^-8 (flipped roundings are sparse; a walk
that drops one position moves a row by >= 1e-2). Flash decode, which
rounds once at the output: within one bf16 ulp of each element. At G = 1
the ragged kernel's verify instantiation equals its decode instantiation
bit for bit, over bf16 and over int8 pools. The int8 instantiations are
held to the ragged limits against the int8 plain version, with NaN in
the scale planes at every position no live entry references. The
dense cache's two routes: flash decode over an attention window's view
(the full cache's slot stride) equal to its plain version and to itself
over the window copied out, and the ragged kernel over a dense cache
viewed as pages through an identity table, every rung, held to the
ragged bounds against its plain version.
"""

import numpy as np
import pytest
import torch

from gofr_tpu_torch.models import llama
from gofr_tpu_torch.ops.cuda import decode_attention as decode_mod
from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod
from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod
from gofr_tpu_torch.ops.cuda.tolerance import row_rel_l2, ulp_error
from gofr_tpu_torch.ops.quant import quantize_kv

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


@pytest.mark.parametrize("seq", [1, 63, 64, 65, 2048])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_flash_tensor_core_kernel_matches_plain(cuda, seq, causal, group):
    """The bf16 wgmma kernel at GQA groups 1/4/8, on and around the
    64-row tile edges, causal and full."""
    gen = torch.Generator(device=cuda).manual_seed(seq * 16 + group)
    hkv = 2
    q, k, v = (torch.randn((2, seq, heads, 128), generator=gen, device=cuda)
               .bfloat16() for heads in (hkv * group, hkv, hkv))
    before = flash_mod.launches
    out = flash_mod.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_mod.launches == before + 1
    ref = flash_mod.flash_attention_plain(q, k, v, causal=causal)
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("seq", [1, 65, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tensor_core_kernel_head_dim_64(cuda, seq, causal):
    gen = torch.Generator(device=cuda).manual_seed(seq)
    q, k, v = (torch.randn((2, seq, heads, 64), generator=gen, device=cuda)
               .bfloat16() for heads in (8, 2, 2))
    out = flash_mod.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = flash_mod.flash_attention_plain(q, k, v, causal=causal)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def _paged(cuda, fills, g_len, group=4, seed=0, page=32, width=8):
    """Poisoned bf16 pools (NaN wherever no live position points), page
    32 and 8 table columns unless given; q (B,G,Hq,D), k/v_new
    (B,G,Hkv,D)."""
    hkv = 2
    num_pages = max(40, sum(-(-n // page) for n in fills) + 4)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    shape = (num_pages, page, hkv, 128)
    k_pages = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    v_pages = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    b = len(fills)
    q = torch.randn((b, g_len, hkv * group, 128), generator=gen,
                    device=cuda).bfloat16()
    k_new, v_new = (torch.randn((b, g_len, hkv, 128), generator=gen,
                                device=cuda).bfloat16() for _ in range(2))
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
    return (q, k_pages, v_pages, torch.from_numpy(table).to(cuda), k_new,
            v_new, torch.tensor(fills, dtype=torch.int32, device=cuda))


def test_ragged_kernel_matches_plain_and_skips_poison(cuda):
    q, kp, vp, table, kn, vn, lens = _paged(cuda, [0, 1, 31, 32, 33, 100,
                                                   255], 1)
    args = (q, kp, vp, table, kn[:, 0], vn[:, 0], lens)
    out = ragged_mod.ragged_paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = ragged_mod.ragged_paged_decode_attention_plain(*args)
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert row_rel_l2(out, ref) <= 2.0 ** -8


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("g_len", [1, 2, 3, 5, 8])
def test_verify_kernel_matches_plain_and_skips_poison(cuda, g_len, group):
    fills = [0, 1, 31, 32, 33, 100, 256 - g_len]
    args = _paged(cuda, fills, g_len, group=group, seed=g_len)
    before = ragged_mod.verify_launches
    out = ragged_mod.ragged_paged_verify_attention(*args)
    torch.cuda.synchronize()
    assert ragged_mod.verify_launches == before + 1
    ref = ragged_mod.ragged_paged_verify_attention_plain(*args)
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert row_rel_l2(out, ref) <= 2.0 ** -8


def test_verify_kernel_g1_is_bitwise_the_decode_kernel(cuda):
    """The verify instantiation (new-token bound 8) at G = 1 against the
    decode instantiation (bound 1) that served G = 1 launches take."""
    q, kp, vp, table, kn, vn, lens = _paged(cuda, [0, 1, 31, 32, 33, 100,
                                                   255], 1)
    before = ragged_mod.verify_launches
    verify = ragged_mod.ragged_paged_verify_form_attention(
        q, kp, vp, table, kn, vn, lens)
    assert ragged_mod.verify_launches == before     # uncounted
    decode = ragged_mod.ragged_paged_decode_attention(
        q, kp, vp, table, kn[:, 0], vn[:, 0], lens)
    assert torch.equal(verify.view(torch.int16), decode.view(torch.int16))


def test_verify_kernel_refuses_too_many_tokens(cuda):
    args = _paged(cuda, [3], 9)
    with pytest.raises(ValueError, match="G in"):
        ragged_mod.ragged_paged_verify_attention(*args)


def _paged_int8(cuda, fills, g_len, group=4, seed=0, page=32, width=8):
    """:func:`_paged`'s layout with its rows quantised to int8 pools and
    NaN in both scale planes wherever no live position points; returns
    the wrapper's arguments, the scale planes last."""
    q, kp, vp, table, kn, vn, lens = _paged(cuda, fills, g_len, group, seed,
                                            page, width)
    dead = kp[..., 0, 0].isnan()[..., None]
    (k8, ks), (v8, vs) = (quantize_kv(p.nan_to_num()) for p in (kp, vp))
    return (q, k8, v8, table, kn, vn, lens,
            ks.masked_fill(dead, float("nan")),
            vs.masked_fill(dead, float("nan")))


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_int8_ragged_kernel_matches_plain_and_skips_poison(cuda, group):
    q, k8, v8, table, kn, vn, lens, ks, vs = _paged_int8(
        cuda, [0, 1, 31, 32, 33, 100, 255], 1, group=group, seed=group)
    args = (q, k8, v8, table, kn[:, 0], vn[:, 0], lens, ks, vs)
    before = (ragged_mod.launches, ragged_mod.int8_launches)
    out = ragged_mod.ragged_paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert (ragged_mod.launches, ragged_mod.int8_launches) \
        == (before[0], before[1] + 1)
    ref = ragged_mod.ragged_paged_decode_attention_plain(*args)
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert row_rel_l2(out, ref) <= 2.0 ** -8


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("g_len", [2, 3, 5])
def test_int8_verify_kernel_matches_plain_and_skips_poison(cuda, g_len,
                                                           group):
    fills = [0, 1, 31, 32, 33, 100, 256 - g_len]
    args = _paged_int8(cuda, fills, g_len, group=group, seed=10 + g_len)
    before = (ragged_mod.verify_launches, ragged_mod.int8_verify_launches)
    out = ragged_mod.ragged_paged_verify_attention(*args)
    torch.cuda.synchronize()
    assert (ragged_mod.verify_launches, ragged_mod.int8_verify_launches) \
        == (before[0], before[1] + 1)
    ref = ragged_mod.ragged_paged_verify_attention_plain(*args)
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert row_rel_l2(out, ref) <= 2.0 ** -8


def test_int8_verify_kernel_g1_is_bitwise_the_int8_decode_kernel(cuda):
    q, k8, v8, table, kn, vn, lens, ks, vs = _paged_int8(
        cuda, [0, 1, 31, 32, 33, 100, 255], 1)
    before = ragged_mod.int8_verify_launches
    verify = ragged_mod.ragged_paged_verify_form_attention(
        q, k8, v8, table, kn, vn, lens, ks, vs)
    assert ragged_mod.int8_verify_launches == before     # uncounted
    decode = ragged_mod.ragged_paged_decode_attention(
        q, k8, v8, table, kn[:, 0], vn[:, 0], lens, ks, vs)
    assert torch.equal(verify.view(torch.int16), decode.view(torch.int16))


def test_int8_wrapper_refuses_mismatched_scale_planes(cuda):
    q, k8, v8, table, kn, vn, lens, ks, vs = _paged_int8(cuda, [3, 40], 1)
    args = (q, k8, v8, table, kn[:, 0], vn[:, 0], lens)
    bf16 = _paged(cuda, [3, 40], 1)
    with pytest.raises(ValueError, match="both scale planes"):
        ragged_mod.ragged_paged_decode_attention(*args, ks, None)
    with pytest.raises(ValueError, match="int8"):     # int8 pools, no scales
        ragged_mod.ragged_paged_decode_attention(*args)
    with pytest.raises(ValueError, match="bfloat16"):  # bf16 pools + scales
        ragged_mod.ragged_paged_decode_attention(
            bf16[0], bf16[1], bf16[2], bf16[3], bf16[4][:, 0],
            bf16[5][:, 0], bf16[6], ks, vs)
    with pytest.raises(ValueError, match="float32"):
        ragged_mod.ragged_paged_decode_attention(*args, ks.bfloat16(), vs)
    with pytest.raises(ValueError, match="float32"):   # wrong plane shape
        ragged_mod.ragged_paged_decode_attention(*args, ks[:, :16], vs)
    with pytest.raises(ValueError, match="contiguous"):
        ragged_mod.ragged_paged_decode_attention(
            *args, ks.transpose(0, 1).contiguous().transpose(0, 1), vs)
    with pytest.raises(ValueError, match="device"):
        ragged_mod.ragged_paged_decode_attention(*args, ks.cpu(), vs)
    with pytest.raises(ValueError, match="must be bf16"):
        ragged_mod.ragged_paged_verify_attention(
            q.float(), k8, v8, table, kn, vn, lens, ks, vs)


# fills around the cluster's chunk edges (each slot's pages split over 8
# blocks in runs of ceil(pages / 8)) and the 8-position runs a half-warp
# loads at once; clipped to the table's capacity
SPLIT_FILLS = [0, 1, 7, 8, 9, 31, 32, 33, 255, 256, 257, 2047, 2048]


@pytest.mark.parametrize("page,width", [(32, 64), (16, 63)])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("g_len", [1, 5])
def test_ragged_split_kernel_on_chunk_edges(cuda, page, width, group, int8,
                                            g_len):
    """The cluster split at fills below, at and above a chunk edge, a
    table width that is not a multiple of 8 (P 63 at page 16), every
    group, bf16 and int8 pools with NaN in every dead row and scale
    entry; at G = 1 the verify instantiation gives the decode one's bits."""
    cap = page * width
    edge = 8 * page                      # one page a rank
    fills = sorted({min(n, cap) for n in SPLIT_FILLS
                    + [edge - 1, edge, edge + 1, cap - 1]})
    make = _paged_int8 if int8 else _paged
    args = list(make(cuda, fills, g_len, group=group, seed=page + group,
                     page=page, width=width))
    counter = ("int8_" if int8 else "") + (
        "launches" if g_len == 1 else "verify_launches")
    before = getattr(ragged_mod, counter)
    if g_len == 1:
        call = args[:4] + [args[4][:, 0], args[5][:, 0]] + args[6:]
        out = ragged_mod.ragged_paged_decode_attention(*call)
        ref = ragged_mod.ragged_paged_decode_attention_plain(*call)
        verify = ragged_mod.ragged_paged_verify_form_attention(*args)
        torch.cuda.synchronize()
        assert torch.equal(verify.view(torch.int16), out.view(torch.int16))
    else:
        out = ragged_mod.ragged_paged_verify_attention(*args)
        ref = ragged_mod.ragged_paged_verify_attention_plain(*args)
    torch.cuda.synchronize()
    assert getattr(ragged_mod, counter) == before + 1
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert row_rel_l2(out, ref) <= 2.0 ** -8


@pytest.mark.parametrize("heads", [(32, 8), (8, 8), (8, 4), (16, 2)])
def test_flash_decode_kernel_matches_plain(cuda, heads):
    hq, hkv = heads
    fills = [0, 1, 127, 128, 129, 700, 1500, 2047]
    b, t = len(fills), 2048
    gen = torch.Generator(device=cuda).manual_seed(hq + hkv)
    lens = torch.tensor(fills, dtype=torch.int32, device=cuda)
    dead = (torch.arange(t, device=cuda)[None, :]
            >= lens[:, None])[..., None, None]
    k, v = (torch.randn((b, t, hkv, 128), generator=gen, device=cuda)
            .bfloat16().masked_fill(dead, float("nan")) for _ in range(2))
    q = torch.randn((b, 1, hq, 128), generator=gen, device=cuda).bfloat16()
    kn, vn = (torch.randn((b, hkv, 128), generator=gen, device=cuda)
              .bfloat16() for _ in range(2))
    before = decode_mod.launches
    out = decode_mod.flash_decode_attention(q, k, v, kn, vn, lens)
    torch.cuda.synchronize()
    assert decode_mod.launches == before + 1
    ref = decode_mod.flash_decode_attention_plain(q, k, v, kn, vn, lens)
    assert torch.isfinite(out).all()
    assert ulp_error(out, ref) <= 1.0


@pytest.mark.parametrize("t_max,fills", [
    (2048, [0, 1, 255, 256, 257, 2047]),
    (1000, [0, 1, 255, 256, 257, 999]),
    (4096, [0, 1, 2047, 2048, 4000, 4095])])
def test_flash_decode_split_kernel_on_chunk_edges(cuda, t_max, fills):
    """Fills on the 256-position chunk edges, at a width that is not a
    multiple of the chunk too; every row past a fill NaN."""
    b, hq, hkv = len(fills), 32, 8
    gen = torch.Generator(device=cuda).manual_seed(t_max)
    lens = torch.tensor(fills, dtype=torch.int32, device=cuda)
    dead = (torch.arange(t_max, device=cuda)[None, :]
            >= lens[:, None])[..., None, None]
    k, v = (torch.randn((b, t_max, hkv, 128), generator=gen, device=cuda)
            .bfloat16().masked_fill(dead, float("nan")) for _ in range(2))
    q = torch.randn((b, 1, hq, 128), generator=gen, device=cuda).bfloat16()
    kn, vn = (torch.randn((b, hkv, 128), generator=gen, device=cuda)
              .bfloat16() for _ in range(2))
    before = decode_mod.launches
    out = decode_mod.flash_decode_attention(q, k, v, kn, vn, lens)
    torch.cuda.synchronize()
    assert decode_mod.launches == before + 1
    ref = decode_mod.flash_decode_attention_plain(q, k, v, kn, vn, lens)
    assert torch.isfinite(out).all()
    assert ulp_error(out, ref) <= 1.0


def test_flash_decode_kernel_over_a_window_view(cuda):
    """Windows 128..1024 of a 2048-position cache, fills below each
    window and one past it; every row past the window NaN."""
    fills = [0, 1, 127, 128, 129, 700, 1500, 2047]
    b, t_max, hq, hkv = len(fills), 2048, 32, 8
    gen = torch.Generator(device=cuda).manual_seed(13)
    k, v = (torch.randn((b, t_max, hkv, 128), generator=gen, device=cuda)
            .bfloat16() for _ in range(2))
    q = torch.randn((b, 1, hq, 128), generator=gen, device=cuda).bfloat16()
    kn, vn = (torch.randn((b, hkv, 128), generator=gen, device=cuda)
              .bfloat16() for _ in range(2))
    for w in (128, 256, 512, 1024):
        lens = torch.tensor([min(n, w - 1) for n in fills[:-1]] + [w + 300],
                            dtype=torch.int32, device=cuda)
        kw, vw = (x.clone() for x in (k, v))
        kw[:, w:] = float("nan")
        vw[:, w:] = float("nan")
        before = decode_mod.launches
        out = decode_mod.flash_decode_attention(q, kw[:, :w], vw[:, :w], kn,
                                                vn, lens)
        copied = decode_mod.flash_decode_attention(
            q, kw[:, :w].contiguous(), vw[:, :w].contiguous(), kn, vn, lens)
        torch.cuda.synchronize()
        assert decode_mod.launches == before + 2
        ref = decode_mod.flash_decode_attention_plain(q, kw[:, :w], vw[:, :w],
                                                      kn, vn, lens)
        assert torch.isfinite(out).all()
        assert torch.equal(out.view(torch.int16), copied.view(torch.int16))
        assert ulp_error(out, ref) <= 1.0


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("g_len", [1, 5])
def test_ragged_kernel_over_an_identity_table(cuda, g_len, int8):
    """A dense (B 8, T 1024, Hkv 8) cache viewed as pages of 32 in slot
    order, each window rung's identity table, fills below the rung and one
    row past it; every position past a row's fill (the window's, for the
    row past it) NaN, scale planes too."""
    b, t_max, hq, hkv, page = 8, 1024, 32, 8, 32
    gen = torch.Generator(device=cuda).manual_seed(17 + g_len)
    shape = (b, t_max, hkv, 128)
    q = torch.randn((b, g_len, hq, 128), generator=gen, device=cuda)\
        .bfloat16()
    kn, vn = (torch.randn((b, g_len, hkv, 128), generator=gen, device=cuda)
              .bfloat16() for _ in range(2))
    k, v = (torch.randn(shape, generator=gen, device=cuda)
            for _ in range(2))
    for w in (128, 256, 512, None):
        top = w or t_max
        fills = [0, 1, 31, 32, 33, top // 2, top - g_len, top + 77]
        lens = torch.tensor([min(n, t_max) for n in fills],
                            dtype=torch.int32, device=cuda)
        dead = (torch.arange(t_max, device=cuda)[None, :]
                >= torch.clamp(lens, max=top)[:, None])    # (B, T)
        if int8:
            (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
            ks = ks.masked_fill(dead[..., None], float("nan"))
            vs = vs.masked_fill(dead[..., None], float("nan"))
            pools = [k8.view(-1, page, hkv, 128), v8.view(-1, page, hkv, 128),
                     ks.view(-1, page, hkv), vs.view(-1, page, hkv)]
        else:
            kb, vb = (x.bfloat16().masked_fill(dead[..., None, None],
                                               float("nan")) for x in (k, v))
            pools = [kb.view(-1, page, hkv, 128), vb.view(-1, page, hkv, 128)]
        table = llama.identity_table(b, t_max, w, device=cuda)
        args = [q, pools[0], pools[1], table, kn, vn, lens] + pools[2:]
        if g_len == 1:
            args[4], args[5] = kn[:, 0], vn[:, 0]
            out = ragged_mod.ragged_paged_decode_attention(*args)
            ref = ragged_mod.ragged_paged_decode_attention_plain(*args)
        else:
            out = ragged_mod.ragged_paged_verify_attention(*args)
            ref = ragged_mod.ragged_paged_verify_attention_plain(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all(), w
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2, w
        assert row_rel_l2(out, ref) <= 2.0 ** -8, w
