"""Pipeline parallelism (pp): the GPipe microbatch schedule over a mesh
axis (counterpart of ``gofr_tpu/parallel/pipeline.py``).

- The decoder's stacked layer weights (L, ...) are cut into PP stages of
  L / PP layers, stage r held on the device of pp rank r (the first
  coordinate of every other mesh axis).
- One loop runs M + PP - 1 ticks. At tick t, rank r applies its stage
  to microbatch t - r when that is one of the M (rank 0 takes it from
  the embedded batch, every other rank from what its predecessor sent),
  and every rank hands its output one step along the ring
  (``parallel/collectives.ppermute``). A rank with no microbatch at a
  tick computes nothing, where JAX's SPMD body computes on padding and
  drops it: the same outputs.
- The last rank collects the final hidden states; the unembedding runs
  on rank 0's device after them. Bubble overhead is the standard GPipe
  (PP-1)/(M+PP-1).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from gofr_tpu_torch.models import llama as llama_mod
from gofr_tpu_torch.ops.attention import prefill_attention
from gofr_tpu_torch.ops.norms import rms_norm
from gofr_tpu_torch.ops.quant import qmm
from gofr_tpu_torch.ops.rotary import rope_table
from gofr_tpu_torch.parallel.collectives import ppermute
from gofr_tpu_torch.parallel.mesh import Mesh


def _split_stages(layers: Dict[str, torch.Tensor], pp: int):
    """(L, ...) stacked layer weights → PP stages of (L/PP, ...) each."""
    out = [{} for _ in range(pp)]
    for name, leaf in layers.items():
        l_count = leaf.shape[0]
        if l_count % pp:
            raise ValueError(f"n_layers {l_count} not divisible by pp={pp}")
        per = l_count // pp
        for r in range(pp):
            out[r][name] = leaf[r * per:(r + 1) * per]
    return out


def _stage_apply(stage_layers, x, cfg, cos, sin, positions):
    """Apply one stage's slice of layers."""
    b, s, _ = x.shape
    for i in range(stage_layers["wq"].shape[0]):
        layer = {name: leaf[i] for name, leaf in stage_layers.items()}
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v = llama_mod._qkv(layer, h, cfg, cos, sin, positions)
        attn = prefill_attention(q, k, v).reshape(b, s, -1)
        x = x + attn @ layer["wo"]
        h = rms_norm(x, layer["ffn_norm"], cfg.norm_eps)
        x = x + llama_mod._ffn(layer, h)
    return x


def make_pp_forward(cfg, mesh: Mesh, n_microbatches: int,
                    axis: str = "pp"):
    """Build ``fn(params, tokens) -> logits`` running the llama decoder as
    a PP-stage pipeline. ``tokens`` (B, S) with B divisible by
    n_microbatches; params are the standard llama tree (plain tensors)."""
    pp = mesh.shape[axis]
    at = mesh.axis_names.index(axis)
    devices = [mesh.devices[tuple(r if j == at else 0
                                  for j in range(len(mesh.axis_names)))]
               for r in range(pp)]

    def forward(params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
        b, s = tokens.shape
        m = n_microbatches
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        bm = b // m
        stages = [{name: leaf.to(dev) for name, leaf in stage.items()}
                  for stage, dev in zip(_split_stages(params["layers"], pp),
                                        devices)]
        ropes = []
        for dev in devices:
            cos, sin = rope_table(cfg.max_seq_len, cfg.head_dim,
                                  cfg.rope_theta, device=dev)
            positions = torch.arange(s, device=dev).expand(bm, s)
            ropes.append((cos, sin, positions))
        emb = params["tok_emb"][tokens].reshape(m, bm, s, cfg.dim)
        emb = emb.to(devices[0])
        recv = [None] * pp
        collected = [None] * m
        for t in range(m + pp - 1):
            outs = []
            for r in range(pp):
                micro = t - r
                if not 0 <= micro < m:
                    outs.append(torch.zeros((bm, s, cfg.dim),
                                            dtype=emb.dtype,
                                            device=devices[r]))
                    continue
                x_in = emb[micro] if r == 0 else recv[r]
                x_out = _stage_apply(stages[r], x_in, cfg, *ropes[r])
                if r == pp - 1:
                    collected[micro] = x_out
                outs.append(x_out)
            recv = ppermute(outs, devices)
        hidden = torch.stack([c.to(devices[0]) for c in collected])
        hidden = hidden.reshape(b, s, cfg.dim)
        hidden = rms_norm(hidden, params["out_norm"].to(devices[0]),
                          cfg.norm_eps)
        return qmm(hidden, params["lm_head"].to(devices[0])).float()

    return forward
