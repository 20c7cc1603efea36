"""SGD-family optimizers: vanilla SGD, the paper's penalty SGD (pSGD,
Algorithm 2), and Polyak momentum SGD with stage reset (mSGD, Algorithm 4).

pSGD update (closed form of the Alg. 2 argmin):
    w⁺ = argmin_w  gᵀw + ‖w−wₘ‖²/(2η) + ‖w−w̃‖²/(2γ)
       = (γ·(wₘ − η·g) + η·w̃) / (γ + η)
With γ=∞ this degenerates to vanilla SGD.

mSGD (Alg. 4):  u⁺ = β·u − η·g ;  w⁺ = w + u⁺ ; momentum u is reset to 0 at
every stage boundary (``reset_on_stage``; Table 1's mSGD* ablation keeps it).

pSGD and mSGD always go through kernels/fused_optim (one CUDA launch over
every leaf on the card, the plain versions on the CPU); updates are in
place (see ``optim/base.py``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.fused_optim import ops as fused
from repro_torch.optim.base import Optimizer, stage_transition
from repro_torch.utils.tree import tree_leaves, tree_map


@torch.no_grad()
def _sgd_step(params, grads, lr: float) -> None:
    for w, g in zip(tree_leaves(params), tree_leaves(grads)):
        w.sub_(lr * g.to(w.dtype))


def sgd() -> Optimizer:
    def init(params):
        return {"stage": 0}

    def update(grads, state, params, *, lr, stage=0, **_):
        _sgd_step(params, grads, lr)
        state["stage"] = int(stage)
        return params, state

    return Optimizer(init, update, "sgd")


def psgd(gamma: float = 1e4) -> Optimizer:
    """The paper's penalty SGD. ``gamma=float('inf')`` → vanilla SGD."""

    def init(params):
        return {"stage": 0, "anchor": tree_map(lambda w: w.detach().clone(), params)}

    def update(grads, state, params, *, lr, stage=0, **_):
        fresh, state["stage"] = stage_transition(stage, state["stage"])
        anchors = tree_leaves(state["anchor"])
        leaves = tree_leaves(params)
        if fresh:
            with torch.no_grad():
                for a, w in zip(anchors, leaves):
                    a.copy_(w)
        if math.isinf(gamma):
            _sgd_step(params, grads, lr)
        else:
            fused.psgd_update(leaves, tree_leaves(grads), anchors, lr=lr, gamma=gamma)
        return params, state

    return Optimizer(init, update, "psgd")


def momentum(beta: float = 0.9, reset_on_stage: bool = True) -> Optimizer:
    """Polyak momentum SGD (paper Alg. 4)."""

    def init(params):
        return {"stage": 0, "u": tree_map(lambda w: torch.zeros_like(w, dtype=torch.float32), params)}

    def update(grads, state, params, *, lr, stage=0, **_):
        fresh, state["stage"] = stage_transition(stage, state["stage"])
        us = tree_leaves(state["u"])
        if fresh and reset_on_stage:
            for u in us:
                u.zero_()
        fused.momentum_update(tree_leaves(params), tree_leaves(grads), us, lr=lr, beta=beta)
        return params, state

    return Optimizer(init, update, "momentum")
