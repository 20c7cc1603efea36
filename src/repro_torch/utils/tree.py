"""The tree operations the port needs over its parameter trees (nested
dicts and lists of tensors, the JAX package's pytrees): the leaves in a
fixed order, a leafwise map over trees of one structure, and the sums,
scalings and sizes that the elastic data-parallel step takes of them."""
from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves depth first, dict entries in their order, list entries in theirs."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied to matching leaves of ``tree`` and ``rest``, in a tree of
    ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_add(a: Any, b: Any) -> Any:
    """Leafwise ``a + b`` (new leaves)."""
    return tree_map(lambda x, y: x + y, a, b)


def tree_scale(tree: Any, scale) -> Any:
    """Leafwise ``x * scale`` (new leaves): a multiply, as the JAX package's."""
    return tree_map(lambda x: x * scale, tree)


def tree_size(tree: Any) -> int:
    """Total number of elements across the tensor leaves."""
    return int(sum(x.numel() for x in tree_leaves(tree) if isinstance(x, torch.Tensor)))
