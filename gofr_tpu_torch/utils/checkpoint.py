"""Checkpoint and resume for param and optimizer trees (counterpart of
``gofr_tpu/utils/checkpoint.py``), in the JAX package's format, so
either package restores what the other saved.

Format: ``directory/step_N/arrays.npz`` (every leaf, keyed by its tree
path as :mod:`gofr_tpu_torch.utils.tree` keys it) and ``tree.json``
(``keys``, ``treedef``, ``dtypes``, ``step``, ``metadata``). A dtype
numpy lacks (bfloat16, fp8) is stored as the same-width unsigned words
under its real name, and restored by viewing the words as the torch
dtype: no ``ml_dtypes``, which the JAX package's restore imports. A save
publishes atomically: written under ``.tmp_ckpt_*``, the old copy moved
aside to ``step_N.old`` first when overwriting, so a crash between the
two renames leaves one of them, and :func:`latest_step` and
:func:`restore_checkpoint` find either.

Sharded trees: a leaf that is a ``parallel/sharding.Sharded`` is saved
as its full leaf, gathered from its shards (JAX saves global arrays), so
the file is the same whatever mesh wrote it. ``restore_checkpoint(...,
sharding=)`` takes JAX's argument, one ``NamedSharding`` for every leaf
or a tree of them like ``like``, and returns ``Sharded`` leaves on that
mesh's devices, one copy for each distinct (device, slice).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.utils import tree as tree_util

# dtypes numpy has no type for: stored as unsigned words of their width
_WORD_DTYPES = {"bfloat16": torch.bfloat16,
                "float8_e4m3fn": torch.float8_e4m3fn,
                "float8_e5m2": torch.float8_e5m2}
_SIGNED = {1: torch.int8, 2: torch.int16}
_UNSIGNED = {1: np.uint8, 2: np.uint16}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_numpy(leaf: Any):
    """(array as stored, its real dtype's name) for one leaf."""
    from gofr_tpu_torch.parallel.sharding import Sharded

    if isinstance(leaf, Sharded):
        leaf = leaf.gather(torch.device("cpu"))
    if not isinstance(leaf, torch.Tensor):
        array = np.asarray(leaf)
        return array, str(array.dtype)
    tensor = leaf.detach().cpu().contiguous()
    name = _dtype_name(tensor.dtype)
    if name in _WORD_DTYPES:
        size = tensor.element_size()
        words = tensor.view(_SIGNED[size]).numpy().view(_UNSIGNED[size])
        return words, name
    return tensor.numpy(), name


def _to_tensor(value: np.ndarray, saved_dtype: Optional[str]
               ) -> torch.Tensor:
    """A stored array as a tensor of its saved dtype (words viewed back)."""
    if saved_dtype in _WORD_DTYPES and str(value.dtype) != saved_dtype:
        signed = value.view(np.dtype(f"int{8 * value.dtype.itemsize}"))
        return torch.from_numpy(signed).view(_WORD_DTYPES[saved_dtype])
    return torch.from_numpy(value)


def save_checkpoint(directory: str, tree: Any, step: int = 0,
                    metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write ``directory/step_N`` atomically (tmpdir + rename). Returns
    the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    stored, dtypes = {}, {}
    for key, leaf in tree_util.flatten(tree).items():
        stored[key], dtypes[key] = _to_numpy(leaf)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **stored)
        with open(os.path.join(tmp, "tree.json"), "w") as handle:
            json.dump({
                "keys": list(stored.keys()),
                "treedef": tree_util.treedef(tree),
                "dtypes": dtypes,
                "step": step,
                "metadata": metadata or {},
            }, handle)
        old = None
        if os.path.exists(final):
            old = final + ".old"
            if os.path.exists(old):
                shutil.rmtree(old, ignore_errors=True)
            os.rename(final, old)
        try:
            os.rename(tmp, final)
        except Exception:
            if old is not None and not os.path.exists(final):
                os.rename(old, final)  # roll the old checkpoint back in
            raise
        # stale once the new copy is visible (also a .old a crash left
        # when final itself was absent)
        shutil.rmtree(final + ".old", ignore_errors=True)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(directory: str) -> Optional[int]:
    """Max step with a readable checkpoint: ``step_N`` or the
    ``step_N.old`` a crash mid-publish left."""
    if not os.path.isdir(directory):
        return None
    steps = set()
    for name in os.listdir(directory):
        if name.startswith("step_"):
            tail = name[5:-4] if name.endswith(".old") else name[5:]
            if tail.isdigit():
                steps.add(int(tail))
    return max(steps) if steps else None


def _step_path(directory: str, step: int) -> str:
    """``step_N``, or ``step_N.old`` when only that is there."""
    path = os.path.join(directory, f"step_{step}")
    if not os.path.isdir(path) and os.path.isdir(path + ".old"):
        return path + ".old"
    return path


def restore_checkpoint(directory: str, like: Any, step: Optional[int] = None,
                       device: Union[str, torch.device] = "cuda",
                       sharding: Any = None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors or
    ``Sharded`` leaves, on any device, ``meta`` included) on ``device``,
    or with ``sharding`` (a ``NamedSharding`` for every leaf, or a tree
    of them like ``like``) as ``Sharded`` leaves on its mesh;
    ``step=None`` takes the latest. A leaf whose saved dtype differs
    from ``like``'s is cast to ``like``'s, as JAX's restore casts to its
    ``like``."""
    from gofr_tpu_torch.parallel.sharding import NamedSharding, shard_leaf

    dev = resolve_device(device) if sharding is None else None
    if sharding is None or isinstance(sharding, NamedSharding):
        shardings = {}
    else:
        shardings = tree_util.flatten(sharding)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = _step_path(directory, step)
    with open(os.path.join(path, "tree.json")) as handle:
        saved_dtypes = json.load(handle)["dtypes"]
    leaves = {}
    with np.load(os.path.join(path, "arrays.npz")) as archive:
        for key, leaf_like in tree_util.flatten(like).items():
            if key not in archive:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            value = _to_tensor(archive[key], saved_dtypes.get(key))
            dtype = getattr(leaf_like, "dtype", None)
            if isinstance(dtype, torch.dtype) and dtype != value.dtype:
                value = value.to(dtype)
            if sharding is None:
                leaves[key] = value.to(dev)
                continue
            target = shardings.get(key, sharding)
            if not isinstance(target, NamedSharding):
                raise ValueError(f"sharding for {key!r}: expected a "
                                 f"NamedSharding, got {target!r}")
            leaves[key] = shard_leaf(value, target.mesh, target.spec)
    return tree_util.unflatten(like, leaves)


def checkpoint_metadata(directory: str,
                        step: Optional[int] = None) -> Dict[str, Any]:
    """``tree.json`` of ``step`` (the latest when None)."""
    if step is None:
        step = latest_step(directory)
    with open(os.path.join(_step_path(directory, step), "tree.json")) as f:
        return json.load(f)
