"""The single-process train step: gradients over microbatches, optional
global-norm clipping, then the optimizer's in-place update.

The JAX package's accumulation modes (``psum_each``, ``deferred``,
``unrolled``) differ only in where a multi-device mesh synchronizes the
gradients; without a mesh they are one computation (its ``step.py`` takes
the same branch for all three when ``mesh is None``). The port runs in one
process, so it accepts all three and runs that computation: a Python loop
over the microbatches.

Memory at full width (``qwen2.5-3b``, f32 weights): a microbatch's
gradients are taken with ``torch.autograd.grad`` and added into an f32 sum
that the first microbatch's gradients become, so the step holds the
weights, the sum and one microbatch's gradients (plus the optimizer state)
and never a second copy of the parameters.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.train.loss import lm_loss
from repro_torch.train.state import TrainState
from repro_torch.utils.tree import tree_leaves

MODES = ("deferred", "psum_each", "unrolled")


def _sq_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ‖x‖² over the leaves, in f32."""
    return sum(torch.dot(x.reshape(-1).float(), x.reshape(-1).float()) for x in leaves)


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    """Scales ``grads`` in place to a global norm of at most ``max_norm``
    (no-op for 0). Returns (grads, the norm before clipping, or 0)."""
    if not max_norm:
        return grads, torch.zeros((), dtype=torch.float32, device=grads[0].device)
    norm = torch.sqrt(_sq_norm(grads))
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in grads:
        g.mul_(scale)
    return grads, norm


def _grads_over_microbatches(model, params, batch, accum_steps: int, z_loss: float):
    """Mean grads (a list in ``tree_leaves(params)`` order) and metrics over
    the (accum, micro, ...) leading axes of ``batch``."""
    leaves = tree_leaves(params)

    def grads_of(mb):
        total, metrics = lm_loss(model, params, mb, z_loss=z_loss)
        grads = torch.autograd.grad(total, leaves)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    if accum_steps == 1:
        return grads_of(batch)
    gsum = None
    lsum = asum = sqsum = 0.0
    for i in range(accum_steps):
        grads, m = grads_of({k: v[i] for k, v in batch.items()})
        # per-microbatch squared grad norm: feeds the gradient-noise-scale
        # estimator (core/noise_scale.py)
        sqsum = sqsum + _sq_norm(grads)
        lsum, asum = lsum + m["loss"], asum + m["aux"]
        if gsum is None:
            gsum = [g if g.dtype == torch.float32 else g.float() for g in grads]
        else:
            for s, g in zip(gsum, grads):
                s.add_(g)
        del grads
    for s in gsum:
        s.mul_(1.0 / accum_steps)
    metrics = {
        "loss": lsum / accum_steps,
        "aux": asum / accum_steps,
        "grad_sq_small": sqsum / accum_steps,  # E‖g_micro‖² for GNS
    }
    return gsum, metrics


def build_train_step(model, optimizer, *, accum_steps: int = 1, mode: str = "deferred",
                     z_loss: float = 0.0, grad_clip: float = 0.0):
    """Returns ``step(state, batch, lr, stage) -> (state, metrics)``; the
    parameters and optimizer state are updated in place.

    Batch leaves are (B, ...) when accum_steps == 1, else (accum, micro, ...).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")

    def step(state: TrainState, batch, lr: float, stage: int):
        leaves = tree_leaves(state.params)
        for w in leaves:
            w.requires_grad_(True)
        grads, metrics = _grads_over_microbatches(model, state.params, batch, accum_steps, z_loss)
        if "grad_sq_small" in metrics:
            metrics["grad_sq_big"] = _sq_norm(grads)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        optimizer.update(grads, state.opt_state, state.params, lr=lr, stage=stage)
        metrics["grad_norm"] = gnorm
        return TrainState(state.params, state.opt_state, state.step + 1), metrics

    return step

