"""Trees of tensors as the JAX package keys them (its ``_flatten`` in
``gofr_tpu/utils/checkpoint.py``, over ``jax.tree_util``'s node rules).

A node is a dict (children in sorted key order, each keyed by its key),
a NamedTuple (each field keyed ``.name``), a tuple or list (each item
keyed by its index) or None (no children); anything else is a leaf. A
leaf's key is its path's keys joined by ``/``: a JAX ``TrainState`` and
the port's give the same keys (``.params/layers/wq``,
``.opt_state/0/.mu/tok_emb``, ``.step``). :func:`tree_map` maps a
function over the leaves, as ``jax.tree.map`` does over one tree.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a node in JAX's order; None for a leaf."""
    if isinstance(node, dict):
        return [(str(key), node[key]) for key in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{name}", getattr(node, name)) for name in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), child) for i, child in enumerate(node)]
    if node is None:
        return []
    return None


def _walk(node: Any, path: Tuple[str, ...]) -> Iterator[Tuple[str, Any]]:
    children = _children(node)
    if children is None:
        yield "/".join(path), node
        return
    for key, child in children:
        yield from _walk(child, path + (key,))


def flatten(tree: Any) -> Dict[str, Any]:
    """Every leaf of ``tree`` by its key, in JAX's leaf order."""
    return dict(_walk(tree, ()))


def unflatten(like: Any, leaves: Dict[str, Any]) -> Any:
    """A tree of ``like``'s structure whose leaf at each key is
    ``leaves[key]``."""
    def build(node, path):
        children = _children(node)
        if children is None:
            return leaves["/".join(path)]
        if node is None:
            return None
        built = [build(child, path + (key,)) for key, child in children]
        if isinstance(node, dict):
            return {key: value for key, value in zip(sorted(node), built)}
        if _is_namedtuple(node):
            return type(node)(*built)
        return type(node)(built)
    return build(like, ())


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """A tree of ``tree``'s structure whose leaves are ``fn`` of its
    leaves."""
    return unflatten(tree, {key: fn(leaf)
                            for key, leaf in flatten(tree).items()})


def treedef(tree: Any) -> str:
    """The tree's structure as ``str(jax.tree.structure(tree))`` writes
    it, for a checkpoint's ``tree.json``."""
    def node_repr(node):
        children = _children(node)
        if children is None:
            return "*"
        if node is None:
            return "None"
        parts = [node_repr(child) for _, child in children]
        if isinstance(node, dict):
            return "{" + ", ".join(f"{key!r}: {part}" for key, part in zip(
                sorted(node), parts)) + "}"
        if _is_namedtuple(node):
            return (f"CustomNode(namedtuple[{type(node).__name__}], "
                    f"[{', '.join(parts)}])")
        if isinstance(node, list):
            return "[" + ", ".join(parts) + "]"
        return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") \
            + ")"
    return f"PyTreeDef({node_repr(tree)})"
