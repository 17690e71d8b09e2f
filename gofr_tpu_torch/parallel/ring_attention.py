"""Ring attention: exact (causal) attention over sequence-sharded Q/K/V
(counterpart of ``gofr_tpu/parallel/ring_attention.py``).

Each shard of the ``sp`` ring holds a contiguous sequence block of q, k
and v. K/V blocks rotate one ring step at a time
(``parallel/collectives.ppermute``) while each shard folds the block it
holds into a flash-style float32 (m, l, acc) carry, so the full (S, S)
score matrix never exists and a shard's memory is O(S_local²).

A shard's block attend is JAX's plain einsum formulation (it is not a
Pallas kernel in the reference), here in PyTorch. The mesh is
single-controller: the caller passes full tensors, every coordinate's
shard (batch on ``batch_axis``, sequence on ``axis_name``, heads on
``head_axis``) runs its ring on its device, and the shards are
reassembled into the full output on q's device. :func:`ring_line` is
one such ring for a caller that already holds one (dp, tp) coordinate's
q, k and v (a tp rank's heads, a dp row's batch): the train step's
attention over the sp axis, each rank's ring over its own heads.
"""

from __future__ import annotations

from typing import Optional

import torch

from gofr_tpu_torch.parallel.collectives import ppermute
from gofr_tpu_torch.parallel.mesh import Mesh
from gofr_tpu_torch.parallel.sharding import P, shard_slices

_NEG_INF = -1e30


def _block_attend(q, k, v, q_pos, k_pos, causal: bool):
    """One GQA block: q (B,S,Hq,D) vs k/v (B,T,Hkv,D); float32
    partial-softmax stats. Returns (p @ v (B,S,Hq,D), row max (B,K,G,S),
    row sum (B,K,G,S)), all float32."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores * (d ** -0.5)
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]                # (S, T)
        scores = torch.where(mask[None, None, None], scores,
                             torch.full_like(scores, _NEG_INF))
    m = scores.amax(dim=-1)                                     # (B,K,G,S)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    pv = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return pv.reshape(b, s, hq, d), m, l


def _ring(qs, ks, vs, devices, causal: bool):
    """The ring over one group of shards (rank r's blocks on
    ``devices[r]``); returns each rank's output block."""
    n = len(qs)
    b, s, hq, d = qs[0].shape
    hkv = ks[0].shape[2]
    g = hq // hkv

    def to_act(stat):
        return stat.permute(0, 3, 1, 2).reshape(b, s, hq)[..., None]

    accs, ms, ls, pos = [], [], [], []
    for r, dev in enumerate(devices):
        accs.append(torch.zeros((b, s, hq, d), dtype=torch.float32,
                                device=dev))
        ms.append(torch.full((b, hkv, g, s), _NEG_INF, dtype=torch.float32,
                             device=dev))
        ls.append(torch.zeros((b, hkv, g, s), dtype=torch.float32,
                              device=dev))
        pos.append(r * s + torch.arange(s, device=dev))
    k_blk, v_blk = list(ks), list(vs)
    for i in range(n):
        for r in range(n):
            blk = (r - i) % n
            pv, m_blk, l_blk = _block_attend(qs[r], k_blk[r], v_blk[r],
                                             pos[r], pos[blk].to(devices[r]),
                                             causal)
            m_new = torch.maximum(ms[r], m_blk)
            corr_old = torch.exp(ms[r] - m_new)
            corr_blk = torch.exp(m_blk - m_new)
            ls[r] = ls[r] * corr_old + l_blk * corr_blk
            accs[r] = accs[r] * to_act(corr_old) + pv * to_act(corr_blk)
            ms[r] = m_new
        k_blk = ppermute(k_blk, devices)
        v_blk = ppermute(v_blk, devices)
    return [(acc / torch.clamp(to_act(l), min=1e-30)).to(q.dtype)
            for acc, l, q in zip(accs, ls, qs)]


def ring_line(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              devices, causal: bool = True) -> torch.Tensor:
    """Ring attention over one line of sp ranks: the sequence of q
    (B, S, Hq, D) and k/v (B, S, Hkv, D) cut into ``len(devices)``
    contiguous blocks, block r on ``devices[r]``, every head of the
    caller's in every block (no head cut); returns the full output on
    q's device. Differentiable: the blocks are concatenated, not
    written into a buffer."""
    n = len(devices)
    if q.shape[1] % n:
        raise ValueError(f"sequence {q.shape[1]} does not divide over "
                         f"{n} sp ranks")

    def cut(x):
        return [part.to(dev) for part, dev in zip(x.chunk(n, dim=1),
                                                  devices)]
    blocks = _ring(cut(q), cut(k), cut(v), list(devices), causal)
    return torch.cat([b.to(q.device) for b in blocks], dim=1)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, axis_name: str = "sp",
                   causal: bool = True,
                   batch_axis: Optional[str] = None,
                   head_axis: Optional[str] = None) -> torch.Tensor:
    """Exact (causal) attention with Q/K/V sharded on the sequence axis.

    q (B, S, Hq, D), k/v (B, S, Hkv, D) — S sharded ``axis_name``-ways,
    optionally B on ``batch_axis`` (dp) and heads on ``head_axis`` (tp),
    so sp composes with dp×tp without gathering heads. Returns the full
    (B, S, Hq, D) output on q's device."""
    spec = P(batch_axis, axis_name, head_axis, None)
    names = mesh.axis_names
    at = names.index(axis_name)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    named = {a for a in (batch_axis, axis_name, head_axis) if a}
    for coord in mesh.coords():
        # one ring per coordinate of the other axes; an axis the spec
        # does not name holds replicas: its first coordinate computes
        if coord[at] != 0 or any(c for a, c in zip(names, coord)
                                 if a not in named):
            continue
        ring = [coord[:at] + (r,) + coord[at + 1:]
                for r in range(mesh.shape[axis_name])]
        devices = [mesh.devices[c] for c in ring]
        cuts = [shard_slices(tuple(q.shape), mesh, spec, c) for c in ring]
        kv_cuts = [shard_slices(tuple(k.shape), mesh, spec, c) for c in ring]
        blocks = _ring([q[c].to(dev) for c, dev in zip(cuts, devices)],
                       [k[c].to(dev) for c, dev in zip(kv_cuts, devices)],
                       [v[c].to(dev) for c, dev in zip(kv_cuts, devices)],
                       devices, causal)
        for c, block in zip(cuts, blocks):
            out[c] = block.to(q.device)
    return out
