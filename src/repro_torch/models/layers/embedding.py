"""Token embedding and the tied (``table.T``) or untied logit head, with
gemma-style final-logit soft-capping.

Under tensor parallelism (a ``"tp"`` entry in the params, the sharded
step's group) the table and the head hold the rank's slice of the
vocabulary, as JAX's ``constrain`` of the logits to ``vocab`` splits them:
the lookup gives each rank's rows (zeros for a token outside its slice),
summed over the ``model`` group onto the rank's block of the sequence,
and :func:`logits` gives the rank's slice of the logits."""
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
    tp = params.get("tp")
    if tp is not None:
        return _embed_split(table, tokens, cfg, tp)
    v = table.shape[0]
    ids = torch.where(tokens < 0, tokens + v, tokens)
    outside = (ids < 0) | (ids >= v)
    x = table[ids.clamp(0, v - 1)].to(getattr(torch, cfg.compute_dtype))
    x = torch.where(outside[..., None], torch.nan, x)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x


def _embed_split(table, tokens, cfg, tp):
    """The vocabulary-parallel lookup: the rank's block (B, c, d) of the
    embedded sequence. Each token's row comes from the one rank whose slice
    holds it (the others add zeros), so the sum has the row's bits; gemma's
    scale applies after it."""
    tp.seq = tokens.shape[1]
    vl = table.shape[0]
    v = vl * tp.width
    ids = torch.where(tokens < 0, tokens + v, tokens)
    local = ids - tp.me * vl
    mine = (local >= 0) & (local < vl)
    rows = table[local.clamp(0, vl - 1)].to(getattr(torch, cfg.compute_dtype))
    x = tp.scatter(torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device)))
    outside = tp.slice((ids < 0) | (ids >= v))
    x = torch.where(outside[..., None], torch.nan, x)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x


def logits(params, x, cfg):
    """(B, S, V) f32 logits of ``x`` (B, S, d); under tensor parallelism
    ``x`` is the whole sequence and the result the rank's vocabulary slice."""
    if cfg.tie_embeddings:
        w = params["table"].to(x.dtype).T  # (d, V)
    else:
        w = params["unembed"].to(x.dtype)
    out = (x @ w).float()
    cap = cfg.final_logit_softcap
    if cap is not None:
        out = cap * torch.tanh(out / cap)
    return out
