"""Mixture-of-Experts FFN with GShard/Switch-style grouped capacity dispatch
(dbrx-132b: 16 experts, top-4; arctic-480b: 128 experts, top-2, beside a
dense residual MLP, whose params ``blocks.py`` passes to :func:`apply`).

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

Under tensor parallelism (a ``"tp"`` entry: the ranks of a ``model`` group
share their rows, :func:`_apply_split`) the layout is the one GSPMD gives
the JAX package: the sequence whole on every rank, the experts (and
arctic's residual MLP's hidden dimension) split over the group. A rank
gathers its group's sequence, trimmed, so that the carry's pad rows never
take capacity; routes every token of each routing group with the
replicated router, so its dispatch is the unsplit run's to the integer;
runs its E/M experts on their capacity buffers only; adds arctic's
residual MLP as its partial over its hidden slice; and sums that one
partial over the group onto its block of the sequence (one all-reduce, or
a reduce-scatter under ``cfg.tp_reduce_scatter``, JAX's ``seq_sp`` output).
The aux loss is linear in ``prob_frac`` (``token_frac`` takes no
gradient): each rank takes ``prob_frac`` over its block of the sequence, so
that the router's gradient, summed over the group as every replicated
leaf's is, counts the aux once; its value is the group's sum.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import mlp

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


def _route(params, x, cfg):
    """x (B, S, d) -> (xg (B, n, gs, d), probs (B, n, gs, E) f32, dispatch
    and combine (B, n, gs, E, C) in x's dtype)."""
    b, s, d = x.shape
    gs = min(GROUP_SIZE, s)
    n = s // gs
    if n * gs != s:
        raise ValueError(f"seq {s} not divisible by group size {gs}")
    xg = x.reshape(b, n, gs, d)
    logits = torch.einsum("bngd,de->bnge", xg.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    disp, combine = dispatch_tensors(probs, cfg.top_k, capacity_of(cfg, gs))
    return xg, probs, disp.to(x.dtype), combine.to(x.dtype)


def _aux(disp, prob_frac, e: int):
    """Switch-style load balance: the share of assignments each expert took
    (from the cast dispatch tensor, as in the JAX package) times its mean
    probability ``prob_frac`` (B, n, E)."""
    token_frac = disp.float().sum(-1).mean(-2)  # (b, n, e)
    return e * (token_frac * prob_frac).sum(-1).mean()


def apply(params, x, cfg, dense=None):
    """x: (B, S, d). Returns (y (B, S, d), the load-balance aux loss, an f32
    scalar); ``dense`` (arctic's residual MLP's params) adds its output to
    y."""
    tp = params.get("tp")
    if tp is not None:
        return _apply_split(params, x, cfg, tp, dense)
    b, s, d = x.shape
    xg, probs, disp, combine = _route(params, x, cfg)
    xe = torch.einsum("bngec,bngd->bnecd", disp, xg)
    group = params.get("group")
    if group is None:
        ye = expert_products(xe, params["w_gate"], params["w_up"], params["w_down"])
    else:
        ye = group.products(xe, params)
    y = torch.einsum("bngec,bnecd->bngd", combine, ye).reshape(b, s, d)
    if dense is not None:
        y = y + mlp.apply(dense, x)
    return y, _aux(disp, probs.mean(-2), cfg.num_experts)


def _apply_split(params, x, cfg, tp, dense):
    """:func:`apply` over the rank's ``model`` group ``tp`` (see the
    module): ``x`` (B, c, d) is the rank's block of the sequence, and so is
    the output; the expert tensors hold the rank's E/M experts and
    ``dense``'s its hidden slice."""
    xs = tp.gather(x)  # the group's sequence, trimmed
    b, s, d = xs.shape
    xg, probs, disp, combine = _route(params, xs, cfg)
    k = cfg.num_experts // tp.width
    mine = slice(tp.me * k, (tp.me + 1) * k)
    xe = torch.einsum("bngec,bngd->bnecd", disp[..., mine, :], xg)
    ye = expert_products(xe, params["w_gate"], params["w_up"], params["w_down"])
    y = torch.einsum("bngec,bnecd->bngd", combine[..., mine, :], ye).reshape(b, s, d)
    if dense is not None:
        y = y + mlp.swiglu(dense, xs)
    n, gs = xg.shape[1], xg.shape[2]
    pos = torch.arange(s, device=xs.device).reshape(n, gs)
    block = ((pos >= tp.me * tp.block) & (pos < (tp.me + 1) * tp.block)).to(probs.dtype)
    aux = tp.total(_aux(disp, (probs * block[..., None]).sum(-2) / gs, cfg.num_experts))
    return tp.scatter(y), aux
