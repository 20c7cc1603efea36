"""Decoder blocks and segments.

A *block* is (pre-norm → mixer → residual, pre-norm → ffn → residual). A
*segment* is ``repeat`` iterations of a tuple of blocks (the "body"). The
JAX package scans the body over weights stacked on a leading ``layers``
axis; here each body block holds a list of per-layer parameter (and cache)
trees, and a Python loop walks them.

Three modes: the full-sequence forward of training (no cache), the dense
serving steps (prefill and decode against a per-row cache) and the paged
serving steps. In training, ``cfg.remat`` recomputes each block in the
backward pass (``torch.utils.checkpoint``, non-reentrant), as the JAX
package's ``jax.checkpoint`` with the ``nothing_saveable`` policy does per
scanned layer; the other JAX policies come with a later slice.

Ported so far: attention mixers (``"attn"``, ``"swa"``) with the dense
SwiGLU FFN, which is every block of the dense decoders, and RWKV6's
time-mix (``"rwkv6"``) with its channel-mix FFN (``"rwkv_cmix"``). In the
dense cache every leaf has one row per batch row (attention KV at
``cache_len`` positions, RWKV6's O(1) recurrent state: wkv state and token
shifts). In the paged cache, attention KV lives in the shared page pool
and RWKV6's state stays per slot at ``state_batch`` rows.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockSpec, ModelConfig, SegmentSpec
from repro_torch.models.layers import attention, mlp, norm, rwkv6

_LATER = {
    "mamba2": "the mamba2/zamba2 slice",
    "cross_attn_block": "the whisper slice",
    "moe": "the MoE (dbrx/arctic) slice",
    "none": "the mamba2/zamba2 slice",
}
ATTENTION_MIXERS = ("attn", "swa")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a block kind that a later slice ports."""
    for seg in cfg.segments:
        if seg.shared_attn:
            raise NotImplementedError("zamba2's shared attention block comes with the zamba2 slice")
        for spec in seg.body:
            for kind in (spec.mixer, spec.ffn):
                if kind in _LATER:
                    raise NotImplementedError(f"{kind!r} blocks come with {_LATER[kind]}")


def init_block(gen: torch.Generator, cfg: ModelConfig, spec: BlockSpec, device="cuda"):
    dtype = getattr(torch, cfg.param_dtype)
    params = {"norm1": norm.init(cfg.d_model, dtype, device)}
    if spec.mixer in ATTENTION_MIXERS:
        params["attn"] = attention.init(gen, cfg, device)
    else:
        params["tmix"] = rwkv6.init_time_mix(gen, cfg, device)
    params["norm2"] = norm.init(cfg.d_model, dtype, device)
    if spec.ffn == "dense":
        params["mlp"] = mlp.init(gen, cfg, device)
    else:
        params["cmix"] = rwkv6.init_channel_mix(gen, cfg, device)
    return params


def init_segment(gen: torch.Generator, cfg: ModelConfig, seg: SegmentSpec, device="cuda"):
    """Returns {"b<i>": [per-layer params] for each body block}."""
    return {
        f"b{bi}": [init_block(gen, cfg, spec, device) for _ in range(seg.repeat)]
        for bi, spec in enumerate(seg.body)
    }


def init_block_cache(cfg: ModelConfig, spec: BlockSpec, batch: int, cache_len: int, dtype,
                     device="cuda"):
    """A dense cache of ``batch`` rows: attention KV of ``cache_len``
    positions, or RWKV6's recurrent state."""
    if spec.mixer in ATTENTION_MIXERS:
        return {"attn": attention.init_cache(cfg, batch, cache_len, dtype, device)}
    return {"rwkv": rwkv6.init_cache(cfg, batch, dtype, device)}


def init_segment_cache(cfg: ModelConfig, seg: SegmentSpec, batch: int, cache_len: int, dtype,
                       device="cuda"):
    return {
        f"b{bi}": [init_block_cache(cfg, spec, batch, cache_len, dtype, device) for _ in range(seg.repeat)]
        for bi, spec in enumerate(seg.body)
    }


def init_block_cache_paged(cfg: ModelConfig, spec: BlockSpec, num_pages: int, page_size: int,
                           state_batch: int, dtype, device="cuda"):
    """Attention KV lives in the shared page pool (a ``(num_pages,
    page_size, hkv, hd)`` pair of leaves per layer); RWKV6's recurrent state
    stays per slot, at ``state_batch`` rows."""
    if spec.mixer in ATTENTION_MIXERS:
        return {"attn": attention.init_paged_cache(cfg, num_pages, page_size, dtype, device)}
    return {"rwkv": rwkv6.init_cache(cfg, state_batch, dtype, device)}


def init_segment_cache_paged(cfg: ModelConfig, seg: SegmentSpec, num_pages: int,
                             page_size: int, state_batch: int, dtype, device="cuda"):
    return {
        f"b{bi}": [
            init_block_cache_paged(cfg, spec, num_pages, page_size, state_batch, dtype, device)
            for _ in range(seg.repeat)
        ]
        for bi, spec in enumerate(seg.body)
    }


def apply_block(params, x, cfg: ModelConfig, spec: BlockSpec, *, positions, cache=None,
                page_table=None, cache_index=None):
    """Returns (x, new_cache). With ``cache`` None it is the full-sequence
    (training) forward. An attention cache (dense or paged) is updated in
    place and returned; RWKV6's recurrent state comes back as new tensors
    (which the paged engine writes into its slot rows,
    ``LanguageModel.paged_state_merge``)."""
    h = norm.apply(params["norm1"], x, cfg.norm_eps)
    new_cache = cache
    if spec.mixer in ATTENTION_MIXERS:
        window = None
        if spec.mixer == "swa":
            window = spec.sliding_window or cfg.sliding_window
        y, _ = attention.apply(
            params["attn"], h, cfg, positions=positions,
            cache=None if cache is None else cache["attn"],
            page_table=page_table, cache_index=cache_index, sliding_window=window,
        )
        x = x + y
        h = norm.apply(params["norm2"], x, cfg.norm_eps)
        return x + mlp.apply(params["mlp"], h), new_cache
    rc = None if cache is None else cache["rwkv"]
    decode = cache is not None and x.shape[1] == 1 and cache_index is not None
    y, wkv, shift_t = rwkv6.apply_time_mix(params["tmix"], h, cfg, cache=rc, decode=decode)
    x = x + y
    h = norm.apply(params["norm2"], x, cfg.norm_eps)
    y, shift_c = rwkv6.apply_channel_mix(params["cmix"], h, cfg, cache=rc)
    if cache is not None:
        new_cache = {"rwkv": {"wkv": wkv, "shift_t": shift_t, "shift_c": shift_c}}
    return x + y, new_cache


def _train_block(params, x, cfg: ModelConfig, spec: BlockSpec, positions):
    return apply_block(params, x, cfg, spec, positions=positions)[0]


def apply_segment(params, x, cfg: ModelConfig, seg: SegmentSpec, *, positions, cache=None,
                  page_table=None, cache_index=None):
    """Run the segment's layers in order. Returns (x, new_cache); with
    ``cache`` None it is the full-sequence (training) forward,
    rematerialized per block when ``cfg.remat`` is set."""
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
    new_cache = {name: list(layers) for name, layers in cache.items()}
    for r in range(seg.repeat):
        for bi, spec in enumerate(seg.body):
            x, new_cache[f"b{bi}"][r] = apply_block(
                params[f"b{bi}"][r], x, cfg, spec, positions=positions,
                cache=cache[f"b{bi}"][r], page_table=page_table, cache_index=cache_index,
            )
    return x, new_cache
