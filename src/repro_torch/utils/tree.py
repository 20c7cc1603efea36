"""The two tree operations the port needs over its parameter trees (nested
dicts and lists of tensors, the JAX package's pytrees): the leaves in a
fixed order, and a leafwise map over trees of one structure."""
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
