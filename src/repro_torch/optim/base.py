"""Optimizer interface, as in the JAX package: an :class:`Optimizer` is an
(init, update) pair where

    state  = opt.init(params)
    params, state = opt.update(grads, state, params, lr=..., stage=...)

``update`` returns the new parameters rather than additive updates,
because the paper's pSGD proximal step and dual-averaging AdaGrad are not
additive-update shaped. ``grads`` is a tree of ``params``' structure or
the list of its leaves in :func:`repro_torch.utils.tree.tree_leaves` order.

Unlike the JAX package, the update runs **in place** on the parameter and
state tensors (and returns the same objects): a functional update of the
f32 ``qwen2.5-3b`` tree would hold a second 12.3 GB copy of it.

**Stages.** Every optimizer state carries ``stage`` (a host integer) and,
for the SEBS-family optimizers, ``anchor``: the stage-initialization
parameters ``w̃_s`` that the proximal term of pSGD and the AdaGrad
proximal matrix are centred on. When the caller passes a ``stage``
different from the stored one, the update first makes the stage-boundary
transition (anchor ← params, momentum and accumulators reset per the
paper), the same transition the JAX package's ``jnp.where`` makes inside
jit, at the same update; here it is decided on the host.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

PyTree = Any


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[..., Tuple[PyTree, PyTree]]
    name: str = ""


def stage_transition(new_stage, state_stage) -> Tuple[bool, int]:
    """Returns (is_new_stage, updated_stage)."""
    new_stage = int(new_stage)
    return new_stage != int(state_stage), new_stage
