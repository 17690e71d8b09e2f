"""Weight converters into the port's params (counterpart of
``gofr_tpu/models/convert.py``).

:func:`from_jax_llama` takes the JAX package's Llama pytree as numpy
arrays and returns the same layout as torch tensors (``tok_emb``, stacked
``layers/*`` (L, ...), ``out_norm``, ``lm_head``; linears (in, out)), so
both packages compute the same function from the same weights.
:func:`from_jax_bert` does the same for BERT (stacked ``layers/*``).
:func:`from_jax_resnet` turns each conv kernel from JAX's HWIO into the
port's OIHW in ``channels_last``; the folded BatchNorm vectors and the
head are kept as they are. :func:`from_jax_train_state` takes a JAX
``TrainState`` (params, optax's Adam state, step) to the port's, so both
packages can take the same training steps from the same state.

With ``mesh`` given, :func:`from_jax_llama`, :func:`from_jax_moe` and
:func:`from_jax_train_state` lay the converted tree out on that mesh as
JAX's state is sharded there (``specs``, by default
``prune_specs(llama_param_specs(), mesh)`` or ``moe_param_specs``; the
moments like the params, count and step replicated): ``Sharded`` leaves
on the mesh's devices, each shard a copy, so a JAX mesh state and the
port's start from the same numbers.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.parallel import sharding, train


def _tensor(array, device: torch.device) -> torch.Tensor:
    array = np.asarray(array)
    if array.dtype.name == "bfloat16":
        # numpy's bfloat16 extension type has no torch counterpart to share
        # memory with: widen exactly to float32, narrow back on the torch side
        return torch.from_numpy(array.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    # a copy: the source may be a read-only view of another framework's buffer
    return torch.from_numpy(np.array(array)).to(device)


def from_jax_llama(params_np: Any,
                   device: Union[str, torch.device] = "cuda",
                   mesh=None, specs: Any = None) -> Any:
    """JAX Llama pytree of numpy arrays (nested dicts, int8 quant dicts
    included) → the same tree of torch tensors on ``device``, dtypes
    kept; with ``mesh``, ``Sharded`` leaves laid out by ``specs``
    (default ``prune_specs(llama_param_specs(), mesh)``)."""
    if mesh is not None:
        return _on_mesh(params_np, mesh, specs if specs is not None else
                        sharding.prune_specs(sharding.llama_param_specs(),
                                             mesh))
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {key: walk(val) for key, val in node.items()}
        return _tensor(node, dev)

    return walk(params_np)


def from_jax_moe(params_np: Any, device: Union[str, torch.device] = "cuda",
                 mesh=None, specs: Any = None) -> Any:
    """JAX MoE pytree of numpy arrays → the port's (llama's layout with
    the expert axis and routers); with ``mesh``, laid out by ``specs``
    (default ``prune_specs(moe_param_specs(), mesh)``)."""
    if mesh is not None and specs is None:
        specs = sharding.prune_specs(sharding.moe_param_specs(), mesh)
    return from_jax_llama(params_np, device, mesh, specs)


def _on_mesh(tree_np: Any, mesh, specs: Any) -> Any:
    """A numpy tree as ``Sharded`` leaves over ``mesh`` by ``specs``."""
    cpu = torch.device("cpu")
    return sharding.map_specs(
        lambda x, spec: sharding.shard_leaf(_tensor(x, cpu), mesh, spec),
        tree_np, specs)


def from_jax_bert(params_np: Any,
                  device: Union[str, torch.device] = "cuda") -> Any:
    """JAX BERT pytree of numpy arrays -> the same tree of torch tensors
    on ``device`` (the same stacked layout), dtypes kept."""
    return from_jax_llama(params_np, device)


def from_jax_resnet(params_np: Any,
                    device: Union[str, torch.device] = "cuda") -> Any:
    """JAX ResNet pytree of numpy arrays (``stem``, ``stages`` as lists of
    blocks, ``head``) -> the port's tree on ``device``: every 4-D conv
    kernel HWIO -> OIHW in ``channels_last``, dtypes kept."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {key: walk(val) for key, val in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(val) for val in node]
        tensor = _tensor(node, dev)
        if tensor.ndim == 4:
            tensor = tensor.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
        return tensor

    return walk(params_np)


def from_jax_train_state(state_np: Any,
                         device: Union[str, torch.device] = "cuda",
                         mesh=None, specs: Any = None) -> Any:
    """JAX ``TrainState`` of numpy arrays (``params``, ``opt_state`` =
    (optax ``ScaleByAdamState(count, mu, nu)``, ``EmptyState()``,
    ``EmptyState()``), ``step``) → the port's
    ``gofr_tpu_torch.parallel.train.TrainState`` on ``device``, dtypes
    kept (count and step int32, 0-d); with ``mesh``, laid out on it as
    ``parallel/train.make_train_step``'s state is (params and moments by
    ``specs``, default ``prune_specs(llama_param_specs(), mesh)``)."""
    cpu = torch.device("cpu")
    dev = cpu if mesh is not None else resolve_device(device)
    adam = state_np.opt_state[0]
    opt_state = (train.ScaleByAdamState(
        _tensor(adam.count, dev), from_jax_llama(adam.mu, dev),
        from_jax_llama(adam.nu, dev)), train.EmptyState(),
        train.EmptyState())
    state = train.TrainState(from_jax_llama(state_np.params, dev), opt_state,
                             _tensor(state_np.step, dev))
    if mesh is None:
        return state
    return train.shard_train_state(state, mesh, specs)
