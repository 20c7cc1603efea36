"""Public wrappers for the fused optimizer updates, used by
``repro_torch.optim``. Each takes lists of leaves (parameters, gradients,
optimizer state) and updates the parameters and the state in place: one
launch of the CUDA kernel (``kernel``) over every leaf for CUDA tensors,
the plain version (``ref``) leaf by leaf for CPU tensors.

The CPU path exists for the tests, and is taken only because the tensors
lie on the CPU: CUDA tensors launch the kernel or raise, with no fallback.
Each wrapper adds one to its entry of :data:`LAUNCHES` where it launches
its kernel, and nowhere else.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.fused_optim import kernel, ref

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"fused_psgd": 0, "fused_momentum": 0, "fused_adagrad_da": 0}

Leaves = Sequence[torch.Tensor]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(leaves: Leaves) -> bool:
    device = leaves[0].device
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the fused updates run on cuda (or their plain versions on cpu), not {device}")
    return device.type == "cuda"


def _contiguous(leaves: Leaves):
    return [g.contiguous() for g in leaves]


@torch.no_grad()
def psgd_update(params: Leaves, grads: Leaves, anchors: Leaves, *, lr: float, gamma: float) -> None:
    """w <- (gamma (w - lr g) + lr a) / (gamma + lr), in place."""
    if not _on_cuda(params):
        for w, g, a in zip(params, grads, anchors):
            w.copy_(ref.psgd_ref(w, g, a, lr=lr, gamma=gamma))
        return
    kernel.psgd_(params, _contiguous(grads), anchors, lr=lr, gamma=gamma,
                 denom=float(ref.psgd_denominator(lr, gamma)))
    LAUNCHES["fused_psgd"] += 1


@torch.no_grad()
def momentum_update(params: Leaves, grads: Leaves, us: Leaves, *, lr: float, beta: float) -> None:
    """u <- beta u - lr g; w <- w + u, in place."""
    if not _on_cuda(params):
        for w, g, u in zip(params, grads, us):
            new_w, new_u = ref.momentum_ref(w, g, u, lr=lr, beta=beta)
            w.copy_(new_w)
            u.copy_(new_u)
        return
    kernel.momentum_(params, _contiguous(grads), us, lr=lr, beta=beta)
    LAUNCHES["fused_momentum"] += 1


@torch.no_grad()
def adagrad_da_update(params: Leaves, grads: Leaves, anchors: Leaves, zs: Leaves, s2s: Leaves, *,
                      lr: float, delta: float, nu: float) -> None:
    """z <- z + g; s2 <- s2 + g^2; w <- a - lr z / (delta^2 + s2)^nu, in place."""
    if not _on_cuda(params):
        for w, g, a, z, s2 in zip(params, grads, anchors, zs, s2s):
            new_w, new_z, new_s2 = ref.adagrad_da_ref(w, g, a, z, s2, lr=lr, delta=delta, nu=nu)
            w.copy_(new_w)
            z.copy_(new_z)
            s2.copy_(new_s2)
        return
    kernel.adagrad_da_(params, _contiguous(grads), anchors, zs, s2s, lr=lr,
                       delta2=float(np.float32(delta**2)), nu=nu)
    LAUNCHES["fused_adagrad_da"] += 1
