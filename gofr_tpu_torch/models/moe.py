"""Mixture-of-Experts Llama variant (counterpart of
``gofr_tpu/models/moe.py``).

- The attention half of every layer is Llama's (``models/llama``); the
  FFN is top-1 routed over ``n_experts`` expert FFNs with a fixed
  per-expert capacity ``C = ceil(T / E * capacity_factor)`` over all T
  tokens of the call, taken in the order of the flattened (row,
  position) sequence; a token past its expert's capacity is dropped
  (its FFN output is 0), the standard capacity-factor trade.
- Dispatch and combine are the JAX package's one-hot einsums over a (T,
  E, C) float32 tensor, the experts three batched einsums; these are
  library matmuls, as JAX computes them outside any Pallas kernel. The
  router runs in float32 (its softmax and argmax, first index on ties),
  the experts in the config's dtype. The one-hot of a token's capacity
  position compares against ``arange(C)``: a dropped token's position
  is past C and its row is all zeros, as ``jax.nn.one_hot`` gives it.
- Serving (:func:`init_cache`, :func:`prefill`, :func:`decode_step`)
  follows llama's dense serving path with the MoE FFN in the dense FFN's
  place: prefill attends through the dense causal ``prefill_attention``
  whatever ``use_flash`` says (JAX's MoE does), and decode reads the
  dense cache through the ragged decode wrapper over the cache's
  identity table (``llama.decode_step``'s route), the kernel on the
  card, its plain version on the CPU. The serving path is bf16-only
  (``kv_int8`` refused at the first prefill or decode step); no paged
  step, prefix reuse or draft (the engine refuses those for a custom
  model module).
- :func:`loss_fn` is the training objective, NLL plus
  ``router_aux_weight`` times the aux loss. The gradient reaches the
  router through the gate and the aux term's mean probabilities; the
  argmax, the one-hot and the cumsum of the capacity positions carry
  none, as in JAX.
- :func:`forward` and :func:`loss_fn` also run over a tree sharded by
  ``parallel/sharding.moe_param_specs`` (:func:`_mesh_stack`: each (ep,
  tp) rank its experts' FFN slice, one all-reduce over ep × tp).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.models import llama as llama_mod
from gofr_tpu_torch.ops.norms import rms_norm
from gofr_tpu_torch.ops.quant import qmm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    base: llama_mod.LlamaConfig = dataclasses.field(
        default_factory=lambda: llama_mod.PRESETS["tiny"])
    n_experts: int = 4
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # the serving contract reads these off the config it is handed, so an
    # MoEConfig stands in for its base LlamaConfig for everything that is
    # not an FFN concern
    @property
    def vocab_size(self) -> int:
        return self.base.vocab_size

    @property
    def dim(self) -> int:
        return self.base.dim

    @property
    def n_layers(self) -> int:
        return self.base.n_layers

    @property
    def n_heads(self) -> int:
        return self.base.n_heads

    @property
    def n_kv_heads(self) -> int:
        return self.base.n_kv_heads

    @property
    def head_dim(self) -> int:
        return self.base.head_dim

    @property
    def max_seq_len(self) -> int:
        return self.base.max_seq_len

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def kv_int8(self) -> bool:
        return self.base.kv_int8


PRESETS = {
    "tiny": MoEConfig(),
    "small": MoEConfig(base=llama_mod.PRESETS["small"], n_experts=8),
}


def config(preset: str = "tiny", **overrides) -> MoEConfig:
    return dataclasses.replace(PRESETS[preset], **overrides)


def init(cfg: MoEConfig, seed: int = 0,
         device: Union[str, torch.device] = "cuda") -> Params:
    """``llama.init``'s layout (drawn from ``seed`` on ``device``) with
    the FFN weights on a leading (E,) expert axis, ``w_gate``/``w_up``
    (L, E, D, F) and ``w_down`` (L, E, F, D), std 1/sqrt(fan_in), and a
    float32 router (L, D, E) at std 0.02 in each layer."""
    dev = resolve_device(device)
    base = cfg.base
    params = llama_mod.init(base, seed, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) + 1)
    d, f, n, e = base.dim, base.ffn_dim, base.n_layers, cfg.n_experts

    def stacked(shape, fan_in):
        out = torch.empty((n, *shape), dtype=base.dtype, device=dev)
        for i in range(n):
            w = torch.randn(shape, generator=gen, device=dev)
            out[i] = (w * (1.0 / math.sqrt(fan_in))).to(base.dtype)
        return out

    layers = dict(params["layers"])
    for name in ("w_gate", "w_up", "w_down"):
        del layers[name]
    layers["router"] = torch.randn((n, d, e), generator=gen,
                                   device=dev) * 0.02
    layers["w_gate"] = stacked((e, d, f), d)
    layers["w_up"] = stacked((e, d, f), d)
    layers["w_down"] = stacked((e, f, d), f)
    params["layers"] = layers
    return params


def _moe_ffn(layer: Dict[str, Any], x: torch.Tensor, cfg: MoEConfig,
             drops: Optional[list] = None,
             expert_slice: Optional[slice] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (out (B, S, D), aux loss scalar): top-1 capacity
    routing with einsum dispatch and combine (JAX ``_moe_ffn``). With
    ``drops`` given, the count of tokens past their expert's capacity
    (a 0-d float32 tensor, no host sync) is appended to it. With
    ``expert_slice`` (an ep rank's slice of the expert axis, whose weights
    ``layer`` holds, each over its tp slice of the FFN width), the
    routing is still every expert's, over all of x's tokens, and ``out``
    is those experts' share of the combine, a part of an all-reduce."""
    b, s, d = x.shape
    e = cfg.n_experts
    tokens = b * s
    capacity = max(1, int(math.ceil(tokens / e * cfg.capacity_factor)))

    flat = x.reshape(tokens, d).float()
    logits = flat @ layer["router"].float()                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)                   # (T,)
    gate = probs.gather(-1, expert_idx[:, None])[:, 0]

    # position of each token within its expert's capacity buffer
    experts = torch.arange(e, device=x.device)
    onehot = (expert_idx[:, None] == experts).float()          # (T, E)
    position = (torch.cumsum(onehot, dim=0) - 1.0) * onehot    # (T, E)
    kept = (position < capacity).float() * onehot              # (T, E)
    pos_idx = position.sum(dim=-1).long()                      # (T,)
    kept_mask = kept.sum(dim=-1)                               # (T,)
    if drops is not None:
        drops.append(tokens - kept_mask.sum())

    # dispatch (T, E, C) one-hot → expert inputs (E, C, D); a dropped
    # token's position is past C: its one-hot row is zeros
    slots = torch.arange(capacity, device=x.device)
    mine = kept if expert_slice is None else kept[:, expert_slice]
    dispatch = mine[:, :, None] * (pos_idx[:, None] == slots).float()[
        :, None, :]
    expert_in = torch.einsum("tec,td->ecd", dispatch, flat).to(x.dtype)

    gate_act = F.silu(torch.einsum("ecd,edf->ecf", expert_in,
                                   layer["w_gate"]).float())
    up = torch.einsum("ecd,edf->ecf", expert_in, layer["w_up"]).float()
    expert_out = torch.einsum("ecf,efd->ecd", (gate_act * up).to(x.dtype),
                              layer["w_down"])

    combine = dispatch * (gate * kept_mask)[:, None, None]
    out = torch.einsum("tec,ecd->td", combine,
                       expert_out.float()).to(x.dtype)

    # Switch-style load balance: E · Σ_e fraction_e · mean-prob_e
    aux = e * torch.sum(onehot.mean(dim=0) * probs.mean(dim=0))
    return out.reshape(b, s, d), aux


def _dense_attention_cfg(cfg: MoEConfig) -> llama_mod.LlamaConfig:
    """The base config with the dense causal prefill attention (JAX's MoE
    takes ``prefill_attention`` whatever ``use_flash`` says)."""
    return dataclasses.replace(cfg.base, use_flash=False,
                               use_flash_decode=False)


def forward(params: Params, cfg: MoEConfig, tokens: torch.Tensor,
            drops: Optional[list] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (logits (B, S, V) float32, aux loss: the layers' mean). With
    ``drops`` given, each layer appends its count of dropped tokens.
    ``params`` may be a tree of ``Sharded`` leaves over a mesh
    (``parallel/sharding.moe_param_specs``, pruned to it):
    :func:`_mesh_stack`."""
    base = cfg.base
    aux = []
    if llama_mod._sharded(params):
        group, ranks, xs = _mesh_stack(params, cfg, tokens, drops, aux)
        logits = llama_mod._logits(group, ranks, xs, base)
        return logits, torch.stack(aux).sum() / base.n_layers

    def ffn(layer, h):
        out, layer_aux = _moe_ffn(layer, h, cfg, drops)
        aux.append(layer_aux)
        return out

    x = llama_mod._run_prompt(params, _dense_attention_cfg(cfg), tokens,
                              ffn=ffn)
    x = rms_norm(x, params["out_norm"], base.norm_eps)
    logits = qmm(x, params["lm_head"]).float()
    return logits, torch.stack(aux).sum() / base.n_layers


def _mesh_stack(params: Params, cfg: MoEConfig, tokens: torch.Tensor,
                drops: Optional[list], aux: list):
    """The forward over an ep × tp sharded tree (JAX's GSPMD layout:
    experts on ep, the FFN width on tp, attention tp-sharded, routers
    replicated), as ``llama._mesh_rows``' tp body: attention through the
    tp line at ep 0 (its ranks' heads, one all-reduce over tp after
    ``wo``: the ep coordinates hold replicas of attention, not parts);
    then every (ep, tp) rank routes all tokens in float32 (the same
    routing everywhere), runs its experts' share of the dispatch, its
    GEMMs on its [E/ep, D, F/tp] weights and the combine over its
    experts (:func:`_moe_ffn` with ``expert_slice``), and one all-reduce
    over the ep × tp ranks sums the parts. The aux loss and the drops are
    rank (0, 0)'s. The batch is not cut: JAX's capacity is per call,
    ``ceil(T / E · capacity_factor)`` over all T tokens in (row,
    position) order, so every rank sees the whole batch, and the
    coordinates of other axes (dp) hold replicas. Returns (the tp
    collectives, the tp ranks' params, the final hidden states on each
    tp rank)."""
    from gofr_tpu_torch.parallel.collectives import Group
    from gofr_tpu_torch.parallel.sharding import local_tree, mesh_of

    mesh = mesh_of(params)
    names = mesh.axis_names
    n_ep, n_tp = mesh.shape.get("ep", 1), mesh.shape.get("tp", 1)

    def at(e, r):
        return tuple({"ep": e, "tp": r}.get(a, 0) for a in names)

    grid = [[at(e, r) for r in range(n_tp)] for e in range(n_ep)]
    trees = [[local_tree(params, c) for c in row] for row in grid]
    attn = llama_mod.TPShards(trees[0], Group([mesh.devices[c]
                                               for c in grid[0]]))
    everyone = Group([mesh.devices[c] for row in grid for c in row])
    per_rank = cfg.n_experts // n_ep

    def ffn_group(i, hs):
        parts = []
        for e, row in enumerate(grid):
            for r, coord in enumerate(row):
                lead = (e, r) == (0, 0)
                out, layer_aux = _moe_ffn(
                    llama_mod._layer(trees[e][r], i),
                    hs[r].to(mesh.devices[coord]), cfg,
                    drops if lead else None,
                    slice(e * per_rank, (e + 1) * per_rank))
                if lead:
                    aux.append(layer_aux)
                parts.append(out)
        return everyone.all_reduce(parts)[:n_tp]

    return llama_mod._prompt_stack(attn, _dense_attention_cfg(cfg),
                                   tokens.to(mesh.devices[grid[0][0]]),
                                   ffn_group=ffn_group)


def _check_serving_cfg(cfg: MoEConfig) -> llama_mod.LlamaConfig:
    if cfg.base.kv_int8:
        raise ValueError("MoE serving path is bf16-only (kv_int8=False)")
    return _dense_attention_cfg(cfg)


def _serving_ffn(cfg: MoEConfig):
    return lambda layer, h: _moe_ffn(layer, h, cfg)[0]


def init_cache(cfg: MoEConfig, batch: int, max_len: Optional[int] = None,
               device: Union[str, torch.device] = "cuda"
               ) -> Dict[str, torch.Tensor]:
    """Llama's dense per-layer KV cache (attention is llama's)."""
    return llama_mod.init_cache(cfg.base, batch,
                                max_len or cfg.max_seq_len, device=device)


def prefill(params: Params, cfg: MoEConfig, tokens: torch.Tensor,
            cache: Dict[str, torch.Tensor],
            lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """Run the prompts (right-padded, ``lengths`` (B,)) and fill ``cache``
    in place: ``llama.prefill``'s contract, (last-token logits (B, V)
    float32, cache, cache_len (B,) int32). Every position of every row,
    padding included, routes through the experts, as in JAX."""
    base = _check_serving_cfg(cfg)
    return llama_mod._prefill(params, base, tokens, cache, lengths,
                              ffn=_serving_ffn(cfg))


def decode_step(params: Params, cfg: MoEConfig, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_len: torch.Tensor,
                window: Optional[int] = None,
                table: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                           torch.Tensor]:
    """One decode step over the dense cache: ``llama.decode_step``'s
    contract (attention over the first ``window`` positions plus the new
    K/V through the ragged decode wrapper over ``table``, the window's
    identity table, built when None; the write at ``cache_len`` in the
    full cache), every row routing through the experts. Returns (logits
    (B, V) float32, cache, cache_len + 1)."""
    base = _check_serving_cfg(cfg)
    return llama_mod._decode(params, base, token, cache, cache_len,
                             window, table, ffn=_serving_ffn(cfg))


def loss_fn(params: Params, cfg: MoEConfig, tokens: torch.Tensor,
            targets: torch.Tensor, drops: Optional[list] = None
            ) -> torch.Tensor:
    """Mean next-token NLL (float32 ``log_softmax``, as llama's) plus
    ``cfg.router_aux_weight`` times :func:`forward`'s aux loss (JAX
    ``loss_fn``). ``drops`` as in :func:`forward`."""
    logits, aux = forward(params, cfg, tokens, drops)
    return llama_mod.mean_nll(logits, targets) + cfg.router_aux_weight * aux
