"""Baseline optimizers the paper compares against (or that the large-batch
literature uses): AdamW, LARS [You et al. 2017], LAMB.

The JAX package computes them with XLA, outside any Pallas kernel, so they
are plain PyTorch here, updating the parameter and state tensors in place
(see ``optim/base.py``) with the JAX package's f32 arithmetic, term for
term. ``count`` (Adam, LAMB) is a host integer, as ``stage`` is.

The trust ratio of LARS and LAMB is taken, as in the JAX package, over
each leaf of the JAX package's tree: there a segment's layers are stacked
on one array, so one ratio covers that leaf of every layer of the segment
(:func:`_stacked_groups` finds those leaves in the port's per-layer lists).
Each norm comes from per-leaf sums of squares; a sharded run's update gets
its shards and ``leaf_sums``, which turns the per-shard sums into whole-leaf
ones (``distributed/sharded.py``). Each leaf's update term is computed twice,
once for its sum and once to apply it (the same bits), so that no second
f32 copy of the tree is held.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.optim.base import Optimizer
from repro_torch.utils.tree import tree_leaves, tree_map


def _zeros(params):
    return tree_map(lambda w: torch.zeros_like(w, dtype=torch.float32), params)


def _bias_corrections(b1: float, b2: float, count: int):
    """``1 - b**count`` in f32, as the JAX package computes it."""
    c = np.float32(count)
    return float(np.float32(1) - np.float32(b1) ** c), float(np.float32(1) - np.float32(b2) ** c)


def _moments(m, v, g, b1: float, b2: float) -> None:
    """m ← b1·m + (1−b1)·g ;  v ← b2·v + (1−b2)·g², in f32, in place."""
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * torch.square(g))


def _stacked_groups(params) -> List[List[int]]:
    """Indices into ``tree_leaves(params)``, one list per leaf of the JAX
    package's tree: the same leaf of every layer of a per-layer list, every
    other leaf alone."""
    groups: List[List[int]] = []

    def walk(tree, start: int) -> int:
        if isinstance(tree, dict):
            for v in tree.values():
                start = walk(v, start)
            return start
        if isinstance(tree, list):  # a segment's layers, each of one structure
            n = len(tree_leaves(tree[0]))
            groups.extend([start + r * n + j for r in range(len(tree))] for j in range(n))
            return start + n * len(tree)
        groups.append([start])
        return start + 1

    walk(params, 0)
    return groups


def _sq(x: torch.Tensor) -> torch.Tensor:
    """‖x‖² in f32."""
    return torch.sum(torch.square(x.float()))


def _trust_ratio(sums: torch.Tensor, group: List[int], eps: float = 1e-9) -> torch.Tensor:
    """‖w‖ / (‖g‖ + eps) over the leaves of one group, or 1 where either
    norm is 0; ``sums`` (2, L) holds each leaf's ‖w‖² and ‖g‖²."""
    wn = torch.sqrt(sum(sums[0, i] for i in group))
    gn = torch.sqrt(sum(sums[1, i] for i in group))
    ratio = wn / (gn + eps)
    return torch.where((wn > 0) & (gn > 0), ratio, torch.ones_like(ratio))


def _whole(sums: torch.Tensor, leaf_sums) -> torch.Tensor:
    return sums if leaf_sums is None else leaf_sums(sums)


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"stage": 0, "m": _zeros(params), "v": _zeros(params), "count": 0}

    @torch.no_grad()
    def update(grads, state, params, *, lr, stage=0, **_):
        state["count"] += 1
        bc1, bc2 = _bias_corrections(b1, b2, state["count"])
        for w, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]), tree_leaves(state["v"])):
            _moments(m, v, g.float(), b1, b2)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            wf = w.float()
            w.copy_((wf - lr * (upd + weight_decay * wf)).to(w.dtype))
        state["stage"] = int(stage)
        return params, state

    return Optimizer(init, update, "adamw")


def lars(beta: float = 0.9, scaling: float = 0.01, weight_decay: float = 1e-4) -> Optimizer:
    """Layer-wise Adaptive Rate Scaling [You et al. 2017]: the large-batch
    baseline the paper compares mSEBS against (Fig. 3)."""

    def init(params):
        return {"stage": 0, "u": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params, *, lr, stage=0, leaf_sums=None, **_):
        ws, gs, us = tree_leaves(params), tree_leaves(grads), tree_leaves(state["u"])
        decayed = lambda i: gs[i].float() + weight_decay * ws[i].float()  # noqa: E731
        sums = _whole(torch.stack([torch.stack([_sq(w) for w in ws]),
                                   torch.stack([_sq(decayed(i)) for i in range(len(ws))])]), leaf_sums)
        for group in _stacked_groups(params):
            local = scaling * _trust_ratio(sums, group)
            for i in group:
                us[i].mul_(beta).add_(local * lr * decayed(i))
                ws[i].copy_((ws[i].float() - us[i]).to(ws[i].dtype))
        state["stage"] = int(stage)
        return params, state

    return Optimizer(init, update, "lars")


def lamb(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6, weight_decay: float = 0.01) -> Optimizer:
    def init(params):
        return {"stage": 0, "m": _zeros(params), "v": _zeros(params), "count": 0}

    @torch.no_grad()
    def update(grads, state, params, *, lr, stage=0, leaf_sums=None, **_):
        state["count"] += 1
        bc1, bc2 = _bias_corrections(b1, b2, state["count"])
        ws, gs = tree_leaves(params), tree_leaves(grads)
        ms, vs = tree_leaves(state["m"]), tree_leaves(state["v"])
        step = lambda i: (ms[i] / bc1) / (torch.sqrt(vs[i] / bc2) + eps) + weight_decay * ws[i].float()  # noqa: E731
        for m, v, g in zip(ms, vs, gs):
            _moments(m, v, g.float(), b1, b2)
        sums = _whole(torch.stack([torch.stack([_sq(w) for w in ws]),
                                   torch.stack([_sq(step(i)) for i in range(len(ws))])]), leaf_sums)
        for group in _stacked_groups(params):
            ratio = _trust_ratio(sums, group)
            for i in group:
                ws[i].copy_((ws[i].float() - lr * ratio * step(i)).to(ws[i].dtype))
        state["stage"] = int(stage)
        return params, state

    return Optimizer(init, update, "lamb")
