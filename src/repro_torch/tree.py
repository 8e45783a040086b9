"""Nested dicts of tensors, read as the reference's pytrees.

Leaves and their ``a/b/c`` paths come in ``jax.tree_util``'s order
(keys sorted at every level): the order in which the reference's
global norm sums its squares and by which its checkpoints key their
arrays.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple


def paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree_util`` order."""
    if not isinstance(tree, dict):
        yield prefix.rstrip("/"), tree
        return
    for k in sorted(tree):
        yield from paths(tree[k], f"{prefix}{k}/")


def leaves(tree: Any) -> List[Any]:
    """The leaves in ``jax.tree.leaves`` order."""
    return [leaf for _, leaf in paths(tree)]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every leaf; the same nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unflatten(flat: Dict[str, Any]) -> Dict:
    """``{"a/b/c": leaf}`` -> nested dicts."""
    tree: Dict = {}
    for path, leaf in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree
