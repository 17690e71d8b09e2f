"""Sharding rules and sharded trees (counterpart of
``gofr_tpu/parallel/sharding.py``).

The spec trees are JAX's, with the same names and structure: Megatron
column/row parallel pairs —

  wq/wk/wv, w_gate/w_up : column-parallel (shard output features on ``tp``)
  wo, w_down            : row-parallel   (shard input features on ``tp``)

so each attention / FFN block needs exactly one all-reduce on its
output. JAX lets XLA insert it; the port's model code calls it
(``parallel/collectives``, ``models/llama``). Layers are stacked (L, ...)
so every spec carries a leading ``None``.

:class:`P` is the port's ``PartitionSpec``: a tuple of axis names (an
entry may be a tuple of names, major first) or None. :func:`shard_pytree`
holds each leaf as a :class:`Sharded`: one tensor for each mesh
coordinate, on that coordinate's device, cut as GSPMD lays out
``addressable_shards`` (a dim sharded over axes of total size n is n
contiguous chunks, the coordinate's mixed-radix index over those axes
picking its chunk). Coordinates on one device share one tensor for a
slice they both hold (a replicated leaf is held once a device, and on
its own device not copied at all). :func:`gather_pytree` reassembles
full leaves (tests, checkpoints); :func:`local_tree` is one
coordinate's tree of plain tensors.

Trees that train (``parallel/train``): :func:`map_distinct` maps a
function over a leaf's distinct tensors, once each, keeping which
coordinates share a result, so moments and gradients take the params'
layout and an optimizer step touches each tensor once however many
coordinates hold it; :func:`sum_replicas` sums the gradients of copies
of one slice held apart (distinct devices, or :func:`assemble`'s own
tensors), JAX's psum over the axes a leaf is replicated on.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.parallel.mesh import Mesh
from gofr_tpu_torch.utils import tree as tree_util

Axis = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """``PartitionSpec``: one entry a dim, an axis name, a tuple of axis
    names or None (replicated on that dim); dims past its length are
    replicated."""

    def __new__(cls, *axes: Axis) -> "P":
        return tuple.__new__(cls, axes)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = spec

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def named(mesh: Mesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec)


def _axes(entry: Axis) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_slices(shape: Tuple[int, ...], mesh: Mesh, spec: P,
                 coord: Tuple[int, ...]) -> Tuple[slice, ...]:
    """The slice of a ``shape`` leaf that mesh coordinate ``coord`` holds
    under ``spec``; raises ValueError where a sharded dim does not
    divide by its axes' size or ``spec`` names an axis the mesh lacks."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec!r} has more entries than the leaf's "
                         f"{len(shape)} dims")
    sizes = mesh.shape
    index = dict(zip(mesh.axis_names, coord))
    out = []
    for dim, size in enumerate(shape):
        axes = _axes(spec[dim]) if dim < len(spec) else ()
        n, at = 1, 0
        for axis in axes:
            if axis not in sizes:
                raise ValueError(f"spec {spec!r}: axis {axis!r} is not in "
                                 f"the mesh {dict(sizes)}")
            n *= sizes[axis]
            at = at * sizes[axis] + index[axis]
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not divide "
                             f"over {axes} ({n} shards)")
        chunk = size // n
        out.append(slice(at * chunk, (at + 1) * chunk))
    return tuple(out)


class Sharded:
    """One leaf over a mesh: ``shards`` holds, at each mesh coordinate,
    that coordinate's tensor on its device. ``shape`` and ``dtype`` are
    the full leaf's."""

    __slots__ = ("mesh", "spec", "shape", "dtype", "shards")

    def __init__(self, mesh: Mesh, spec: P, shape: Tuple[int, ...],
                 dtype: torch.dtype, shards: np.ndarray):
        self.mesh = mesh
        self.spec = spec
        self.shape = tuple(shape)
        self.dtype = dtype
        self.shards = shards

    @property
    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec)

    def shard(self, coord: Tuple[int, ...]) -> torch.Tensor:
        return self.shards[tuple(coord)]

    @property
    def addressable_shards(self):
        """(coordinate, tensor) for every coordinate, row-major."""
        return [(c, self.shards[c]) for c in self.mesh.coords()]

    def distinct_shards(self) -> List[torch.Tensor]:
        """The shards' tensors, each once (coordinates may share one)."""
        return list({id(t): t for t in self.shards.flat}.values())

    def nbytes(self) -> int:
        """Bytes the shards hold, a shared tensor counted once."""
        return sum(t.numel() * t.element_size()
                   for t in self.distinct_shards())

    def item(self):
        """A 0-d leaf's value (every coordinate holds the same: a 0-d
        leaf is replicated)."""
        if self.shape != ():
            raise ValueError(f"item() of a leaf of shape {self.shape}")
        return self.shards.flat[0].item()

    def __int__(self) -> int:
        return int(self.item())

    def __float__(self) -> float:
        return float(self.item())

    def gather(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The full leaf, reassembled from the shards on ``device``
        (default: the first coordinate's)."""
        first = self.shards.flat[0]
        dev = first.device if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for coord in self.mesh.coords():
            out[shard_slices(self.shape, self.mesh, self.spec, coord)] = \
                self.shards[coord].to(dev)
        return out

    def __repr__(self) -> str:
        return (f"Sharded({self.shape}, {self.dtype}, {self.spec!r}, "
                f"{dict(self.mesh.shape)})")


def shard_leaf(x: torch.Tensor, mesh: Mesh, spec: P,
               own: bool = False) -> Sharded:
    """``x`` cut by ``spec`` over ``mesh``, one copy for each distinct
    (device, slice): coordinates on one device share their slice's
    tensor, and a whole-leaf slice on ``x``'s own device is ``x`` itself
    unless ``own``, which copies that one too, so that a train state
    stepped in place never writes the caller's tensor."""
    x = torch.as_tensor(x)
    shards = np.empty(mesh.devices.shape, dtype=object)
    made: Dict[Tuple[str, tuple], torch.Tensor] = {}
    for coord in mesh.coords():
        dev = resolve_device(mesh.devices[coord])
        cut = shard_slices(tuple(x.shape), mesh, spec, coord)
        key = (str(dev), tuple((s.start, s.stop) for s in cut))
        if key not in made:
            whole = all(s.stop - s.start == size
                        for s, size in zip(cut, x.shape))
            if whole and x.device == dev and not own:
                made[key] = x
            else:
                part = x[cut]
                made[key] = torch.empty(part.shape, dtype=part.dtype,
                                        device=dev).copy_(part)
        shards[coord] = made[key]
    return Sharded(mesh, spec, tuple(x.shape), x.dtype, shards)


def assemble(mesh: Mesh, specs: Dict[str, P],
             make: Callable[[Tuple[int, ...]], Dict[str, torch.Tensor]]
             ) -> Dict[str, Sharded]:
    """A dict of :class:`Sharded` leaves built from each coordinate's own
    tensors, ``make(coord)`` → that coordinate's leaves by name (made on
    its device at the shard's shape, no full leaf ever held): the full
    shape is a shard's with each sharded dim times its axes' size."""
    made = {coord: make(coord) for coord in mesh.coords()}
    first = made[mesh.coords()[0]]
    out = {}
    for name, spec in specs.items():
        local = first[name].shape
        shape = tuple(
            size * int(np.prod([mesh.shape[a]
                                for a in _axes(spec[dim])] or [1]))
            if dim < len(spec) else size
            for dim, size in enumerate(local))
        shards = np.empty(mesh.devices.shape, dtype=object)
        for coord, leaves in made.items():
            shards[coord] = leaves[name]
        out[name] = Sharded(mesh, spec, shape, first[name].dtype, shards)
    return out


def is_sharded(tree: Any) -> bool:
    """Whether any leaf of ``tree`` is a :class:`Sharded`."""
    if isinstance(tree, Sharded):
        return True
    if isinstance(tree, dict):
        return any(is_sharded(val) for val in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(is_sharded(val) for val in tree)
    return False


def map_specs(fn: Callable[[Any, P], Any], tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a tree and its mirror spec tree (a spec
    is a leaf; dicts, lists and tuples recurse; None stays None)."""
    if isinstance(specs, P):
        return None if tree is None else fn(tree, specs)
    if isinstance(specs, dict):
        return {key: map_specs(fn, tree[key], specs[key]) for key in tree}
    if isinstance(specs, (list, tuple)):
        return type(tree)(map_specs(fn, t, s) for t, s in zip(tree, specs))
    raise TypeError(f"not a spec tree node: {specs!r}")


def _map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {key: _map_leaves(fn, val) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        items = [_map_leaves(fn, val) for val in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return None if tree is None else fn(tree)


def shard_pytree(tree: Any, mesh: Mesh, specs: Any, own: bool = False
                 ) -> Any:
    """Every leaf as a :class:`Sharded` by its spec (specs mirrors
    tree); ``own`` as in :func:`shard_leaf`."""
    return map_specs(lambda x, s: shard_leaf(x, mesh, s, own), tree, specs)


def map_distinct(fn: Callable[[torch.Tensor], torch.Tensor],
                 leaf: Any) -> Any:
    """``fn(t)`` for each distinct tensor ``t`` of a :class:`Sharded`
    ``leaf``, once each, as a :class:`Sharded` of ``leaf``'s layout:
    coordinates that share a tensor in ``leaf`` share its result. A
    plain tensor is ``fn(leaf)``."""
    if not isinstance(leaf, Sharded):
        return fn(leaf)
    made: Dict[int, torch.Tensor] = {}
    shards = np.empty(leaf.shards.shape, dtype=object)
    for coord in leaf.mesh.coords():
        t = leaf.shards[coord]
        if id(t) not in made:
            made[id(t)] = fn(t)
        shards[coord] = made[id(t)]
    return Sharded(leaf.mesh, leaf.spec, leaf.shape, shards.flat[0].dtype,
                   shards)


def map_distinct_tree(fn: Callable[[torch.Tensor], torch.Tensor],
                      tree: Any) -> Any:
    """:func:`map_distinct` over every leaf of ``tree``."""
    return tree_util.tree_map(lambda leaf: map_distinct(fn, leaf), tree)


def clone_tree(tree: Any) -> Any:
    """A copy of every distinct tensor of ``tree``, sharing kept."""
    return map_distinct_tree(torch.clone, tree)


def distinct_tensors(leaf: Any) -> List[torch.Tensor]:
    """A :class:`Sharded` leaf's distinct tensors (in the order of the
    coordinates first holding them), or ``[leaf]``."""
    return leaf.distinct_shards() if isinstance(leaf, Sharded) else [leaf]


def sum_replicas(leaf: Any) -> Any:
    """A :class:`Sharded` gradient whose copies of one slice held in
    distinct tensors are each replaced by their sum
    (``collectives.all_reduce``: float32 in coordinate order, one
    rounding), so every replica then takes the same step bit for bit.
    Where each slice is one tensor (shards sharing a device) it is
    ``leaf`` itself."""
    if not isinstance(leaf, Sharded):
        return leaf
    from gofr_tpu_torch.parallel.collectives import all_reduce

    groups: Dict[tuple, List[torch.Tensor]] = {}
    for coord in leaf.mesh.coords():
        cut = shard_slices(leaf.shape, leaf.mesh, leaf.spec, coord)
        group = groups.setdefault(tuple((c.start, c.stop) for c in cut), [])
        t = leaf.shards[coord]
        if all(t is not u for u in group):
            group.append(t)
    if all(len(g) == 1 for g in groups.values()):
        return leaf
    summed: Dict[int, torch.Tensor] = {}
    for group in groups.values():
        for t, total in zip(group, all_reduce(group,
                                              [u.device for u in group])):
            summed[id(t)] = total
    return map_distinct(lambda t: summed[id(t)], leaf)


def mesh_of(tree: Any) -> Optional[Mesh]:
    """The mesh of ``tree``'s first :class:`Sharded` leaf (None: none)."""
    if isinstance(tree, Sharded):
        return tree.mesh
    children = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for child in children:
        mesh = mesh_of(child)
        if mesh is not None:
            return mesh
    return None


def gather_pytree(tree: Any, device=None) -> Any:
    """Full leaves from a tree of :class:`Sharded` (others as they are)."""
    return _map_leaves(lambda x: x.gather(device) if isinstance(x, Sharded)
                       else x, tree)


def local_tree(tree: Any, coord: Tuple[int, ...]) -> Any:
    """Mesh coordinate ``coord``'s tree: each :class:`Sharded` leaf's
    shard there (views of the sharded tree's memory, no copy)."""
    return _map_leaves(lambda x: x.shard(coord) if isinstance(x, Sharded)
                       else x, tree)


def replicated_specs(tree: Any) -> Any:
    return _map_leaves(lambda _: P(), tree)


def prune_specs(specs: Any, mesh: Mesh) -> Any:
    """Drop axis names the mesh doesn't have (→ replicated on that dim), so
    one canonical rule-set serves every mesh topology."""
    names = mesh.shape

    def prune(spec):
        if isinstance(spec, P):
            return P(*(axis if axis in names else None for axis in spec))
        if isinstance(spec, dict):
            return {key: prune(val) for key, val in spec.items()}
        return type(spec)(prune(val) for val in spec)
    return prune(specs)


def llama_param_specs(tp: str = "tp") -> Dict[str, Any]:
    """PartitionSpecs mirroring the llama param tree (``models/llama``)."""
    return {
        "tok_emb": P(None, None),        # replicated: lookup stays local
        "layers": {
            "attn_norm": P(None, None),
            "wq": P(None, None, tp),     # column parallel
            "wk": P(None, None, tp),
            "wv": P(None, None, tp),
            "wo": P(None, tp, None),     # row parallel → all-reduce out
            "ffn_norm": P(None, None),
            "w_gate": P(None, None, tp),
            "w_up": P(None, None, tp),
            "w_down": P(None, tp, None),
        },
        "out_norm": P(None,),
        "lm_head": P(None, tp),          # vocab-sharded logits
    }


def llama_cache_specs(dp: str = "dp", tp: str = "tp",
                      kv_int8: bool = False) -> Dict[str, P]:
    """KV cache (L, B, T, Hkv, Dh): batch on dp, kv-heads on tp. int8
    caches add per-vector scale planes (L, B, T, Hkv), sharded alike."""
    spec = P(None, dp, None, tp, None)
    specs = {"k": spec, "v": spec}
    if kv_int8:
        specs["ks"] = P(None, dp, None, tp)
        specs["vs"] = P(None, dp, None, tp)
    return specs


def llama_prefix_pool_specs(tp: str = "tp",
                            kv_int8: bool = False) -> Dict[str, P]:
    """Prefix-KV page pool (L, num_pages, page, Hkv, Dh): kv-heads on tp
    like the main cache; pages replicate across dp (any dp shard may
    gather any page)."""
    spec = P(None, None, None, tp, None)
    specs = {"k": spec, "v": spec}
    if kv_int8:
        specs["ks"] = P(None, None, None, tp)
        specs["vs"] = P(None, None, None, tp)
    return specs


def moe_param_specs(tp: str = "tp", ep: str = "ep") -> Dict[str, Any]:
    """PartitionSpecs for ``models/moe``: expert-stacked FFN weights
    (L, E, D, F) shard the expert axis on ``ep``; attention stays
    Megatron tensor-parallel on ``tp``; routers replicate. The MoE's
    ``forward`` and ``loss_fn`` run over a tree sharded by it
    (``models/moe``: each (ep, tp) rank its experts' FFN slice, one
    all-reduce over ep × tp)."""
    specs = llama_param_specs(tp)
    layers = dict(specs["layers"])
    layers.pop("w_gate"), layers.pop("w_up"), layers.pop("w_down")
    layers["router"] = P(None, None, None)
    layers["w_gate"] = P(None, ep, None, tp)
    layers["w_up"] = P(None, ep, None, tp)
    layers["w_down"] = P(None, ep, tp, None)
    specs["layers"] = layers
    return specs


def bert_param_specs(tp: str = "tp") -> Dict[str, Any]:
    """PartitionSpecs mirroring the BERT param tree (``models/bert``)."""
    return {
        "tok_emb": P(None, None),
        "pos_emb": P(None, None),
        "type_emb": P(None, None),
        "emb_norm_w": P(None,), "emb_norm_b": P(None,),
        "layers": {
            "wq": P(None, None, tp), "wk": P(None, None, tp),
            "wv": P(None, None, tp), "wo": P(None, tp, None),
            "bq": P(None, tp), "bk": P(None, tp), "bv": P(None, tp),
            "bo": P(None, None),
            "attn_norm_w": P(None, None), "attn_norm_b": P(None, None),
            "w_in": P(None, None, tp), "b_in": P(None, tp),
            "w_out": P(None, tp, None), "b_out": P(None, None),
            "ffn_norm_w": P(None, None), "ffn_norm_b": P(None, None),
        },
        "pool_w": P(None, None), "pool_b": P(None,),
    }


def batch_spec(dp: str = "dp", ndim: int = 2) -> P:
    """Shard the leading (batch) axis on dp, replicate the rest."""
    return P(dp, *([None] * (ndim - 1)))
