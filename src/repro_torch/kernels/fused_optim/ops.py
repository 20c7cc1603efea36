"""Public wrappers for the fused optimizer updates, used by
``repro_torch.optim``. Each takes lists of leaves (parameters, gradients,
optimizer state) and updates the parameters and the state in place: one
launch of the CUDA kernel (``kernel``) over every leaf for CUDA tensors,
the plain version (``ref``) leaf by leaf for CPU tensors, nothing for meta
tensors (the dry run). Each call reports :func:`cost` to the active
counters (``kernels/accounting.py``).

The CPU path exists for the tests, and is taken only because the tensors
lie on the CPU: CUDA tensors launch the kernel or raise, with no fallback.
Each wrapper adds one to its entry of :data:`LAUNCHES` where it launches
its kernel, and nowhere else.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.accounting import kernel_region
from repro_torch.kernels.fused_optim import kernel, ref

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"fused_psgd": 0, "fused_momentum": 0, "fused_adagrad_da": 0}

Leaves = Sequence[torch.Tensor]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _route(leaves: Leaves) -> str:
    device = leaves[0].device
    if device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"the fused updates run on cuda (or their plain versions on cpu, their counts on meta), "
                         f"not {device}")
    return device.type


def _contiguous(leaves: Leaves):
    return [g.contiguous() for g in leaves]


def _nbytes(*lists: Leaves) -> int:
    return sum(t.numel() * t.element_size() for leaves in lists for t in leaves)


#: of each update: whether it reads w, and the lists it writes (0 the
#: params, i the i-th state list)
_TRAFFIC = {"fused_psgd": (True, (0,)), "fused_momentum": (True, (0, 1)),
            "fused_adagrad_da": (False, (0, 2, 3))}


def cost(name: str, params: Leaves, grads: Leaves, *state: Leaves):
    """(operations, bytes) of one fused update over the leaves: 6 flops an
    element; each leaf it reads read once and each it writes written once
    (pSGD reads w, g and the anchor and writes w; momentum reads w, g, u
    and writes w, u; AdaGrad-DA reads g, the anchor, z, s2 and writes w, z,
    s2). The bounds of ``chip_smoke.py``'s kernel table are these counts
    over the card's rates."""
    reads_w, writes = _TRAFFIC[name]
    lists = (params,) + tuple(state)
    read = _nbytes(grads, *state) + (_nbytes(params) if reads_w else 0)
    return float(6 * sum(w.numel() for w in params)), float(read + _nbytes(*(lists[i] for i in writes)))


@torch.no_grad()
def psgd_update(params: Leaves, grads: Leaves, anchors: Leaves, *, lr: float, gamma: float) -> None:
    """w <- (gamma (w - lr g) + lr a) / (gamma + lr), in place."""
    route = _route(params)
    with kernel_region("fused_psgd", *cost("fused_psgd", params, grads, anchors), (*params, *grads, *anchors)):
        if route == "cpu":
            for w, g, a in zip(params, grads, anchors):
                w.copy_(ref.psgd_ref(w, g, a, lr=lr, gamma=gamma))
        if route != "cuda":
            return
        kernel.psgd_(params, _contiguous(grads), anchors, lr=lr, gamma=gamma,
                     denom=float(ref.psgd_denominator(lr, gamma)))
    LAUNCHES["fused_psgd"] += 1


@torch.no_grad()
def momentum_update(params: Leaves, grads: Leaves, us: Leaves, *, lr: float, beta: float) -> None:
    """u <- beta u - lr g; w <- w + u, in place."""
    route = _route(params)
    with kernel_region("fused_momentum", *cost("fused_momentum", params, grads, us), (*params, *grads, *us)):
        if route == "cpu":
            for w, g, u in zip(params, grads, us):
                new_w, new_u = ref.momentum_ref(w, g, u, lr=lr, beta=beta)
                w.copy_(new_w)
                u.copy_(new_u)
        if route != "cuda":
            return
        kernel.momentum_(params, _contiguous(grads), us, lr=lr, beta=beta)
    LAUNCHES["fused_momentum"] += 1


@torch.no_grad()
def adagrad_da_update(params: Leaves, grads: Leaves, anchors: Leaves, zs: Leaves, s2s: Leaves, *,
                      lr: float, delta: float, nu: float) -> None:
    """z <- z + g; s2 <- s2 + g^2; w <- a - lr z / (delta^2 + s2)^nu, in place."""
    route = _route(params)
    with kernel_region("fused_adagrad_da", *cost("fused_adagrad_da", params, grads, anchors, zs, s2s),
                       (*grads, *anchors, *zs, *s2s)):
        if route == "cpu":
            for w, g, a, z, s2 in zip(params, grads, anchors, zs, s2s):
                new_w, new_z, new_s2 = ref.adagrad_da_ref(w, g, a, z, s2, lr=lr, delta=delta, nu=nu)
                w.copy_(new_w)
                z.copy_(new_z)
                s2.copy_(new_s2)
        if route != "cuda":
            return
        kernel.adagrad_da_(params, _contiguous(grads), anchors, zs, s2s, lr=lr,
                           delta2=float(np.float32(delta**2)), nu=nu)
    LAUNCHES["fused_adagrad_da"] += 1
