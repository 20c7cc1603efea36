"""Token embedding and the tied (``table.T``) or untied logit head, with
gemma-style final-logit soft-capping."""
from __future__ import annotations

import torch


def init(gen: torch.Generator, cfg, device="cuda"):
    v, d = cfg.padded_vocab, cfg.d_model
    dtype = getattr(torch, cfg.param_dtype)
    params = {"table": torch.randn((v, d), generator=gen, dtype=dtype, device=device) * d**-0.5}
    if not cfg.tie_embeddings:
        params["unembed"] = (
            torch.randn((d, v), generator=gen, dtype=dtype, device=device) * d**-0.5
        )
    return params


def param_axes(cfg):
    """The logical axes of :func:`init`'s leaves."""
    axes = {"table": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        axes["unembed"] = ("embed", "vocab")
    return axes


def embed(params, tokens, cfg):
    """Row lookup with ``jnp.take``'s semantics: a negative id counts from
    the end, and an id outside ``[-V, V)`` yields a row of NaN (the CUDA
    gather would otherwise fault on it)."""
    table = params["table"]
    v = table.shape[0]
    ids = torch.where(tokens < 0, tokens + v, tokens)
    outside = (ids < 0) | (ids >= v)
    x = table[ids.clamp(0, v - 1)].to(getattr(torch, cfg.compute_dtype))
    x = torch.where(outside[..., None], torch.nan, x)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x


def logits(params, x, cfg):
    if cfg.tie_embeddings:
        w = params["table"].to(x.dtype).T  # (d, V)
    else:
        w = params["unembed"].to(x.dtype)
    out = (x @ w).float()
    cap = cfg.final_logit_softcap
    if cap is not None:
        out = cap * torch.tanh(out / cap)
    return out
