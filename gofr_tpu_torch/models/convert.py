"""Weight converters into the port's params (counterpart of
``gofr_tpu/models/convert.py``).

:func:`from_jax_llama` takes the JAX package's Llama pytree as numpy
arrays and returns the same layout as torch tensors (``tok_emb``, stacked
``layers/*`` (L, ...), ``out_norm``, ``lm_head``; linears (in, out)), so
both packages compute the same function from the same weights.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from gofr_tpu_torch.device import resolve_device


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
                   device: Union[str, torch.device] = "cuda") -> Any:
    """JAX Llama pytree of numpy arrays (nested dicts, int8 quant dicts
    included) → the same tree of torch tensors on ``device``, dtypes
    kept."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {key: walk(val) for key, val in node.items()}
        return _tensor(node, dev)

    return walk(params_np)
