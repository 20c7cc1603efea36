"""Decoder blocks and segments.

A *block* is (pre-norm → mixer → residual, pre-norm → ffn → residual). A
*segment* is ``repeat`` iterations of a tuple of blocks (the "body"). The
JAX package scans the body over weights stacked on a leading ``layers``
axis; here each body block holds a list of per-layer parameter (and cache)
trees, and a Python loop walks them.

Two modes: the full-sequence forward of training (no cache) and the paged
serving steps. In training, ``cfg.remat`` recomputes each block in the
backward pass (``torch.utils.checkpoint``, non-reentrant), as the JAX
package's ``jax.checkpoint`` with the ``nothing_saveable`` policy does per
scanned layer; the other JAX policies come with a later slice.

Ported so far: attention mixers (``"attn"``, ``"swa"``) with the dense
SwiGLU FFN, which is every block of the dense decoders.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockSpec, ModelConfig, SegmentSpec
from repro_torch.models.layers import attention, mlp, norm

_LATER = {
    "mamba2": "the mamba2/zamba2 slice",
    "rwkv6": "the rwkv6 slice",
    "cross_attn_block": "the whisper slice",
    "moe": "the MoE (dbrx/arctic) slice",
    "rwkv_cmix": "the rwkv6 slice",
    "none": "the mamba2/zamba2 slice",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a block kind that a later slice ports."""
    for seg in cfg.segments:
        if seg.shared_attn:
            raise NotImplementedError("zamba2's shared attention block comes with the zamba2 slice")
        for spec in seg.body:
            for kind in (spec.mixer, spec.ffn):
                if kind in _LATER:
                    raise NotImplementedError(f"{kind!r} blocks come with {_LATER[kind]}")


def init_block(gen: torch.Generator, cfg: ModelConfig, device="cuda"):
    dtype = getattr(torch, cfg.param_dtype)
    return {
        "norm1": norm.init(cfg.d_model, dtype, device),
        "attn": attention.init(gen, cfg, device),
        "norm2": norm.init(cfg.d_model, dtype, device),
        "mlp": mlp.init(gen, cfg, device),
    }


def init_segment(gen: torch.Generator, cfg: ModelConfig, seg: SegmentSpec, device="cuda"):
    """Returns {"b<i>": [per-layer params] for each body block}."""
    return {
        f"b{bi}": [init_block(gen, cfg, device) for _ in range(seg.repeat)]
        for bi in range(len(seg.body))
    }


def init_segment_cache_paged(cfg: ModelConfig, seg: SegmentSpec, num_pages: int,
                             page_size: int, dtype, device="cuda"):
    """Attention KV of every layer lives in the shared page pool: one
    ``(num_pages, page_size, hkv, hd)`` pair of leaves per layer."""
    return {
        f"b{bi}": [
            {"attn": attention.init_paged_cache(cfg, num_pages, page_size, dtype, device)}
            for _ in range(seg.repeat)
        ]
        for bi in range(len(seg.body))
    }


def apply_block(params, x, cfg: ModelConfig, spec: BlockSpec, *, positions, cache=None,
                page_table=None, cache_index=None):
    """Returns (x, cache); a paged cache is updated in place. With ``cache``
    None it is the full-sequence (training) forward."""
    window = None
    if spec.mixer == "swa":
        window = spec.sliding_window or cfg.sliding_window
    h = norm.apply(params["norm1"], x, cfg.norm_eps)
    y, _ = attention.apply(
        params["attn"], h, cfg, positions=positions,
        cache=None if cache is None else cache["attn"],
        page_table=page_table, cache_index=cache_index, sliding_window=window,
    )
    x = x + y
    h = norm.apply(params["norm2"], x, cfg.norm_eps)
    return x + mlp.apply(params["mlp"], h), cache


def _train_block(params, x, cfg: ModelConfig, spec: BlockSpec, positions):
    return apply_block(params, x, cfg, spec, positions=positions)[0]


def apply_segment(params, x, cfg: ModelConfig, seg: SegmentSpec, *, positions, cache=None,
                  page_table=None, cache_index=None):
    """Run the segment's layers in order. Returns (x, cache); with ``cache``
    None it is the full-sequence (training) forward, rematerialized per
    block when ``cfg.remat`` is set."""
    if cache is None:
        remat = cfg.remat and torch.is_grad_enabled()
        if remat and cfg.remat_policy != "nothing_saveable":
            raise NotImplementedError(
                f"remat policy {cfg.remat_policy!r} comes with a later slice; "
                "the port has nothing_saveable"
            )
        for r in range(seg.repeat):
            for bi, spec in enumerate(seg.body):
                p = params[f"b{bi}"][r]
                if remat:
                    x = checkpoint(_train_block, p, x, cfg, spec, positions, use_reentrant=False)
                else:
                    x = _train_block(p, x, cfg, spec, positions)
        return x, None
    for r in range(seg.repeat):
        for bi, spec in enumerate(seg.body):
            x, _ = apply_block(
                params[f"b{bi}"][r], x, cfg, spec, positions=positions,
                cache=cache[f"b{bi}"][r], page_table=page_table, cache_index=cache_index,
            )
    return x, cache
