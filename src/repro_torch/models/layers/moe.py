"""Mixture-of-Experts FFN with GShard/Switch-style grouped capacity dispatch
(dbrx-132b: 16 experts, top-4; arctic-480b: 128 experts, top-2, beside a
dense residual MLP that ``blocks.py`` adds).

The (batch, seq) token axis is split into groups of ``gs = min(1024, S)``
tokens; each group routes its tokens into a per-expert capacity buffer of
``C = max(1, ceil(top_k * gs / E * cf))`` slots. The dispatch and combine
tensors are (B, G, T, E, C) and the expert products see (E, ..., C, d)
operands, as in the JAX package. Routing is integer-exact against it: the
top k come from a stable descending sort (``jax.lax.top_k`` lets the lower
expert index win a tie), buffer positions are a cumulative sum over the
assignments in slot-major order (slot 0 of every token before slot 1 of
any), and an assignment past its expert's capacity is dropped.

The JAX package computes the products outside any Pallas kernel, so they
stay ``torch.einsum`` here (:func:`expert_products`). Each expert tensor is
cast to the compute dtype just before its product and released after it:
at arctic's width one bf16 copy is 8.9 GB, and three at once would not fit
beside the f32 weights.

Under the sharded step on a mesh whose ``model`` axis splits the experts
(the rules map ``experts`` to ``model``; JAX constrains ``xe`` and ``h``
there), the params carry a ``"group"`` entry and the rank's E/M experts
only: routing and dispatch stay the rank's own, and ``group.products``
sends each chunk of ``xe`` to the ``model`` rank holding those experts,
runs its own experts on what its group sent and returns the outputs
(``distributed/sharded.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

GROUP_SIZE = 1024


def init(gen: torch.Generator, cfg, device="cuda"):
    """The router is f32 whatever ``param_dtype`` is, as in the JAX package."""
    d, dff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dtype = getattr(torch, cfg.param_dtype)

    def normal(shape, scale, dt=dtype):
        # scaled in place: an arctic expert tensor is 17.8 GB in f32
        return torch.randn(shape, generator=gen, dtype=dt, device=device).mul_(scale)

    return {
        "router": normal((d, e), d**-0.5, torch.float32),
        "w_gate": normal((e, d, dff), d**-0.5),
        "w_up": normal((e, d, dff), d**-0.5),
        "w_down": normal((e, dff, d), dff**-0.5),
    }


#: the expert tensors (leading dimension ``experts``)
EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def param_axes(cfg):
    """The logical axes of :func:`init`'s leaves."""
    return {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", "mlp"),
        "w_up": ("experts", "embed", "mlp"),
        "w_down": ("experts", "mlp", "embed"),
    }


def top_experts(probs: torch.Tensor, top_k: int) -> torch.Tensor:
    """(..., T, E) -> (..., T, k) expert indices by falling probability, the
    lower index first among equals (``jax.lax.top_k``'s order)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :top_k]


def dispatch_tensors(probs: torch.Tensor, top_k: int, capacity: int):
    """probs (..., T, E) -> (dispatch, combine), both (..., T, E, C) in
    probs' dtype: dispatch is 1 where a token's assignment to an expert holds
    capacity slot c, combine is dispatch times the token's probability."""
    e = probs.shape[-1]
    onehots = F.one_hot(top_experts(probs, top_k), e)  # (..., T, k, E)
    # positions in each expert's buffer, slot-major, so that slot 0 (the
    # highest probability) of every token wins a place before any slot 1
    flat = onehots.movedim(-2, -3)  # (..., k, T, E)
    shape = flat.shape
    kt = flat.reshape(shape[:-3] + (shape[-3] * shape[-2], e))  # (..., k*T, E)
    pos = ((kt.cumsum(-2) - kt) * kt).sum(-1)  # (..., k*T)
    keep = (pos < capacity) & (kt.sum(-1) > 0)
    pos_oh = (pos[..., None] == torch.arange(capacity, device=pos.device)) & keep[..., None]
    disp_kt = kt.to(probs.dtype)[..., None] * pos_oh.to(probs.dtype)[..., None, :]  # (..., k*T, E, C)
    disp = disp_kt.reshape(shape[:-3] + (shape[-3], shape[-2], e, capacity))
    disp = disp.movedim(-4, -3).sum(-3)  # over the k slots -> (..., T, E, C)
    return disp, disp * probs[..., None]


def capacity_of(cfg, group_size: int) -> int:
    return max(1, math.ceil(cfg.top_k * group_size / cfg.num_experts * cfg.moe_capacity_factor))


def expert_products(xe, w_gate, w_up, w_down):
    """Each expert's SwiGLU on its capacity buffer: xe (B, n, E, C, d) ->
    (B, n, E, C, d) in xe's dtype, each weight cast to it for its product."""
    gate = torch.einsum("bnecd,edf->bnecf", xe, w_gate.to(xe.dtype))
    up = torch.einsum("bnecd,edf->bnecf", xe, w_up.to(xe.dtype))
    h = F.silu(gate) * up
    return torch.einsum("bnecf,efd->bnecd", h, w_down.to(xe.dtype))


def apply(params, x, cfg):
    """x: (B, S, d). Returns (y (B, S, d), the load-balance aux loss, an f32
    scalar)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    gs = min(GROUP_SIZE, s)
    n = s // gs
    if n * gs != s:
        raise ValueError(f"seq {s} not divisible by group size {gs}")
    capacity = capacity_of(cfg, gs)

    xg = x.reshape(b, n, gs, d)
    logits = torch.einsum("bngd,de->bnge", xg.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    disp, combine = dispatch_tensors(probs, k, capacity)
    disp = disp.to(x.dtype)
    combine = combine.to(x.dtype)
    xe = torch.einsum("bngec,bngd->bnecd", disp, xg)
    group = params.get("group")
    if group is None:
        ye = expert_products(xe, params["w_gate"], params["w_up"], params["w_down"])
    else:
        ye = group.products(xe, params)
    y = torch.einsum("bngec,bnecd->bngd", combine, ye).reshape(b, s, d)

    # Switch-style load balance: the share of assignments each expert took
    # (from the cast dispatch tensor, as in the JAX package) times its mean
    # probability
    token_frac = disp.float().sum(-1).mean(-2)  # (b, n, e)
    prob_frac = probs.mean(-2)
    aux = e * (token_frac * prob_frac).sum(-1).mean()
    return y, aux
