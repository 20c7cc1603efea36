"""Plain PyTorch versions of the fused SEBS optimizer updates: the pSGD
closed-form proximal step, Polyak momentum and dual-averaging AdaGrad, in
f32, out of place (the JAX package's ``fused_optim/ref.py``).

The scalars are f32 as in the JAX package, where ``lr`` is an f32 device
scalar: ``gamma + lr`` and ``delta**2`` are rounded to f32 before use.
Every division is between tensors, so it is the IEEE division on every
device (PyTorch divides a CUDA tensor by a Python scalar as a multiply by
its reciprocal); the kernels then equal these versions bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(x), dtype=torch.float32, device=like.device)


def psgd_denominator(lr: float, gamma: float) -> np.float32:
    """``gamma + lr`` in f32, as the JAX update computes it."""
    return np.float32(gamma) + np.float32(lr)


def psgd_ref(w, g, anchor, *, lr: float, gamma: float):
    wf, gf, af = (x.float() for x in (w, g, anchor))
    out = (gamma * (wf - lr * gf) + lr * af) / _f32(psgd_denominator(lr, gamma), wf)
    return out.to(w.dtype)


def momentum_ref(w, g, u, *, lr: float, beta: float):
    new_u = beta * u.float() - lr * g.float()
    new_w = (w.float() + new_u).to(w.dtype)
    return new_w, new_u


def adagrad_da_ref(w, g, anchor, z, s2, *, lr: float, delta: float, nu: float):
    gf = g.float()
    new_z = z.float() + gf
    new_s2 = s2.float() + gf * gf
    h = float(np.float32(delta**2)) + new_s2
    if nu != 1.0:
        h = torch.pow(h, nu)
    new_w = (anchor.float() - (lr * new_z) / h).to(w.dtype)
    return new_w, new_z, new_s2
