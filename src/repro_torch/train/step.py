"""The single-process train step: gradients over microbatches, optional
global-norm clipping, then the optimizer's in-place update.

The JAX package's accumulation modes (``psum_each``, ``deferred``,
``unrolled``) differ only in where a multi-device mesh synchronizes the
gradients; without a mesh they are one computation (its ``step.py`` takes
the same branch for all three when ``mesh is None``). The port runs in one
process, so it accepts all three and runs that computation: a Python loop
over the microbatches.

Memory at full width (f32 weights): each leaf's gradient is taken from the
leaf as the backward pass finishes it (a post-accumulate hook), added into
an f32 sum that the first microbatch's gradients become, and freed, so the
step holds the weights, the sum and one leaf's gradient of the microbatch
at a time (plus the optimizer state), never a second set of gradients:
at dbrx-132b's width one layer's gradients are 15.5 GB. The sums are those
of ``torch.autograd.grad`` leaf for leaf, bit for bit. A leaf that the
loss does not reach (internvl2's projector on a batch of tokens alone)
gets a zero gradient, as under ``jax.grad``.
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
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float, sq_norm=None):
    """Scales ``grads`` in place to a global norm of at most ``max_norm``
    (no-op for 0). Returns (grads, the norm before clipping, or 0).
    ``sq_norm``: the squared norm where the caller has it (the sharded
    step's ``grads`` are slices), default :func:`_sq_norm` of ``grads``."""
    if not max_norm:
        return grads, torch.zeros((), dtype=torch.float32, device=grads[0].device)
    norm = torch.sqrt(_sq_norm(grads) if sq_norm is None else sq_norm)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in grads:
        g.mul_(scale)
    return grads, norm


def _grads_over_microbatches(model, params, batch, accum_steps: int, z_loss: float):
    """Mean grads (a list in ``tree_leaves(params)`` order) and metrics over
    the (accum, micro, ...) leading axes of ``batch``."""
    leaves = tree_leaves(params)
    index = {id(w): i for i, w in enumerate(leaves)}
    gsum: List = [None] * len(leaves)
    dots: List = [None] * len(leaves)  # a microbatch's ‖g‖² per leaf

    def take(w):
        """A leaf's gradient of the current microbatch, into the sum."""
        i, g = index[id(w)], w.grad
        w.grad = None
        if accum_steps == 1:
            gsum[i] = g
            return
        flat = g.reshape(-1).float()
        dots[i] = torch.dot(flat, flat)
        if gsum[i] is None:
            gsum[i] = g if g.dtype == torch.float32 else g.float()
        else:
            gsum[i].add_(g)

    hooks = [w.register_post_accumulate_grad_hook(take) for w in leaves]
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    lsum = asum = sqsum = 0.0
    try:
        for w in leaves:
            w.grad = None
        for i in range(accum_steps):
            mb = batch if accum_steps == 1 else {k: v[i] for k, v in batch.items()}
            total, m = lm_loss(model, params, mb, z_loss=z_loss)
            dots[:] = [zero] * len(leaves)
            torch.autograd.backward(total, inputs=leaves)
            del total
            m = {k: v.detach() for k, v in m.items()}
            if accum_steps > 1:
                # per-microbatch squared grad norm, summed in leaf order:
                # feeds the gradient-noise-scale estimator (core/noise_scale.py)
                sqsum = sqsum + sum(dots)
                lsum, asum = lsum + m["loss"], asum + m["aux"]
    finally:
        for h in hooks:
            h.remove()
    for i, w in enumerate(leaves):
        if gsum[i] is None:  # not reached by the loss
            gsum[i] = torch.zeros_like(w, dtype=w.dtype if accum_steps == 1 else torch.float32)
    if accum_steps == 1:
        return gsum, m
    for s in gsum:
        s.mul_(1.0 / accum_steps)
    metrics = {
        "loss": lsum / accum_steps,
        "aux": asum / accum_steps,
        "grad_sq_small": sqsum / accum_steps,  # E‖g_micro‖² for GNS
    }
    return gsum, metrics


def build_eval_step(model, *, z_loss: float = 0.0):
    """Returns ``eval_step(params, batch) -> metrics``: ``lm_loss``'s
    metrics ({"loss", "aux", "tokens"}) without gradients."""

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = lm_loss(model, params, batch, z_loss=z_loss)
        return metrics

    return eval_step


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

