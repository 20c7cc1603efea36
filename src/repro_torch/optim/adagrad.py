"""AdaGrad in the paper's dual-averaging form (Algorithm 6) plus the
standard diagonal form.

Algorithm 6 runs, within a stage anchored at w₁ = w̃:
    hₘ = (δ² + Σ_{i≤m} gᵢ²)^ν            (coordinate-wise)
    wₘ₊₁ = w̃ − η · (Σ_{i≤m} gᵢ) / hₘ
The state keeps the running gradient sum z and square-sum s², both reset
at stage boundaries (AdaSEBS, Algorithm 5, calls AdaGrad fresh each stage
with the new anchor). ν=1 by default, per the paper (Lemma 8).

The dual-averaging update always goes through kernels/fused_optim (one CUDA
launch over every leaf on the card, the plain version on the CPU); updates
are in place (see ``optim/base.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_optim import ops as fused
from repro_torch.optim.base import Optimizer, stage_transition
from repro_torch.utils.tree import tree_leaves, tree_map


def _zeros(params):
    return tree_map(lambda w: torch.zeros_like(w, dtype=torch.float32), params)


def adagrad_da(delta: float = 1.0, nu: float = 1.0) -> Optimizer:
    """Paper's dual-averaging AdaGrad (Alg. 6)."""

    def init(params):
        return {
            "stage": 0,
            "anchor": tree_map(lambda w: w.detach().clone(), params),
            "z": _zeros(params),   # Σ g
            "s2": _zeros(params),  # Σ g²
        }

    def update(grads, state, params, *, lr, stage=0, **_):
        fresh, state["stage"] = stage_transition(stage, state["stage"])
        leaves = tree_leaves(params)
        anchors, zs, s2s = (tree_leaves(state[k]) for k in ("anchor", "z", "s2"))
        if fresh:
            with torch.no_grad():
                for a, w, z, s2 in zip(anchors, leaves, zs, s2s):
                    a.copy_(w)
                    z.zero_()
                    s2.zero_()
        fused.adagrad_da_update(leaves, tree_leaves(grads), anchors, zs, s2s,
                                lr=lr, delta=delta, nu=nu)
        return params, state

    return Optimizer(init, update, "adagrad_da")


def adagrad(delta: float = 1e-7) -> Optimizer:
    """Standard (primal) diagonal AdaGrad baseline (no kernel in either
    package: plain PyTorch, in place)."""

    def init(params):
        return {"stage": 0, "s2": _zeros(params)}

    @torch.no_grad()
    def update(grads, state, params, *, lr, stage=0, **_):
        for w, g, s2 in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["s2"])):
            gf = g.float()
            s2.add_(gf * gf)
            w.copy_((w.float() - (lr * gf) / (torch.sqrt(s2) + delta)).to(w.dtype))
        state["stage"] = int(stage)
        return params, state

    return Optimizer(init, update, "adagrad")
