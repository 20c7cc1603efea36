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

The block kinds: attention mixers (``"attn"``, ``"swa"``) with the dense
SwiGLU FFN, which is every block of the dense decoders, or with the MoE
FFN (``"moe"``: dbrx; arctic adds a dense residual MLP beside it, under
``"mlp"``, where ``cfg.moe_dense_residual`` is set); RWKV6's time-mix
(``"rwkv6"``) with its channel-mix FFN (``"rwkv_cmix"``); and Mamba2
(``"mamba2"``) with no FFN (``"none"``: no ``norm2``), with zamba2's
weight-tied shared attention block (``SHARED_SPEC``, one set of weights
under the segment's ``"shared"`` key) applied before each repeat of the
body, with a cache of its own per repeat; and whisper's decoder block
(``"cross_attn_block"``): causal self-attention, then, where an encoder
``memory`` is given, ``x + cross_attn(norm_cross(x), memory)``, then the
FFN. Its cache is the self-attention's; the cross-attention's K and V are
computed from the memory at every call, as in the JAX package. A segment
runs causal or not (``causal=False``: whisper's encoder, a segment of
``"attn"`` blocks over the audio frames). In the dense cache every leaf
has one row per batch row (attention KV at ``cache_len`` positions, the
O(1) recurrent state: RWKV6's wkv state and token shifts, Mamba2's SSM
state and conv window). In the paged cache, attention KV lives in the
shared page pool and the recurrent state stays per slot at
``state_batch`` rows.

Each block also returns its router's load-balance loss (the MoE FFN's aux;
0.0 for a block without a router), which ``apply_segment`` sums over the
layers; under remat it is an output of the rematerialized block, so the
router's gradient flows through the recomputation, as the JAX scan's
``(h, aux)`` carry does. The serving paths compute it and drop it.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockSpec, ModelConfig, SegmentSpec
from repro_torch.models.layers import attention, mamba2, mlp, moe, norm, rwkv6
from repro_torch.sharding.partitioning import map_axes

ATTENTION_MIXERS = ("attn", "swa", "cross_attn_block")
# zamba2's shared block: attention and the dense FFN, one set of weights for
# every repeat of its segment
SHARED_SPEC = BlockSpec(mixer="attn", ffn="dense")


def init_block(gen: torch.Generator, cfg: ModelConfig, spec: BlockSpec, device="cuda"):
    dtype = getattr(torch, cfg.param_dtype)
    params = {"norm1": norm.init(cfg.d_model, dtype, device)}
    if spec.mixer in ATTENTION_MIXERS:
        params["attn"] = attention.init(gen, cfg, device)
        if spec.mixer == "cross_attn_block":
            params["norm_cross"] = norm.init(cfg.d_model, dtype, device)
            params["cross_attn"] = attention.init(gen, cfg, device, cross=True)
    elif spec.mixer == "mamba2":
        params["mamba"] = mamba2.init(gen, cfg, device)
    else:
        params["tmix"] = rwkv6.init_time_mix(gen, cfg, device)
    if spec.ffn != "none":
        params["norm2"] = norm.init(cfg.d_model, dtype, device)
    if spec.ffn == "dense":
        params["mlp"] = mlp.init(gen, cfg, device)
    elif spec.ffn == "moe":
        params["moe"] = moe.init(gen, cfg, device)
        if cfg.moe_dense_residual:
            params["mlp"] = mlp.init(gen, cfg, device)
    elif spec.ffn == "rwkv_cmix":
        params["cmix"] = rwkv6.init_channel_mix(gen, cfg, device)
    return params


def init_segment(gen: torch.Generator, cfg: ModelConfig, seg: SegmentSpec, device="cuda"):
    """Returns {"b<i>": [per-layer params] for each body block}, and the
    shared block's params under "shared" where the segment has one."""
    params = {
        f"b{bi}": [init_block(gen, cfg, spec, device) for _ in range(seg.repeat)]
        for bi, spec in enumerate(seg.body)
    }
    if seg.shared_attn:
        params["shared"] = init_block(gen, cfg, SHARED_SPEC, device)
    return params


def block_axes(cfg: ModelConfig, spec: BlockSpec):
    """The logical axes of :func:`init_block`'s leaves, key for key."""
    axes = {"norm1": norm.param_axes()}
    if spec.mixer in ATTENTION_MIXERS:
        axes["attn"] = attention.param_axes(cfg)
        if spec.mixer == "cross_attn_block":
            axes["norm_cross"] = norm.param_axes()
            axes["cross_attn"] = attention.param_axes(cfg, cross=True)
    elif spec.mixer == "mamba2":
        axes["mamba"] = mamba2.param_axes(cfg)
    else:
        axes["tmix"] = rwkv6.time_mix_axes(cfg)
    if spec.ffn != "none":
        axes["norm2"] = norm.param_axes()
    if spec.ffn == "dense":
        axes["mlp"] = mlp.param_axes(cfg)
    elif spec.ffn == "moe":
        axes["moe"] = moe.param_axes(cfg)
        if cfg.moe_dense_residual:
            axes["mlp"] = mlp.param_axes(cfg)
    elif spec.ffn == "rwkv_cmix":
        axes["cmix"] = rwkv6.channel_mix_axes(cfg)
    return axes


def _stacked(axes):
    """``axes`` with the leading ``"layers"`` entry of a stacked leaf."""
    return map_axes(lambda a: ("layers",) + a, axes)


def segment_axes(cfg: ModelConfig, seg: SegmentSpec):
    """The logical axes of a segment in the JAX package's layout: each body
    block's leaves stacked over the repeats (a leading ``"layers"`` entry),
    the shared block's alone. ``train/state.py``'s ``unstack_axes`` lays
    them over the port's per-layer lists."""
    axes = {f"b{bi}": _stacked(block_axes(cfg, spec)) for bi, spec in enumerate(seg.body)}
    if seg.shared_attn:
        axes["shared"] = block_axes(cfg, SHARED_SPEC)
    return axes


def block_cache_axes(spec: BlockSpec):
    if spec.mixer in ATTENTION_MIXERS:
        return {"attn": dict(attention.CACHE_AXES)}
    if spec.mixer == "mamba2":
        return {"mamba": dict(mamba2.CACHE_AXES)}
    return {"rwkv": dict(rwkv6.CACHE_AXES)}


def segment_cache_axes(seg: SegmentSpec):
    """The logical axes of a segment's dense cache in the JAX package's
    layout (every block's cache stacked over the repeats)."""
    return {name: _stacked(block_cache_axes(spec)) for name, spec in _segment_blocks(seg)}


def _recurrent_cache(cfg: ModelConfig, spec: BlockSpec, batch: int, dtype, device):
    if spec.mixer == "mamba2":
        return {"mamba": mamba2.init_cache(cfg, batch, dtype, device)}
    return {"rwkv": rwkv6.init_cache(cfg, batch, dtype, device)}


def init_block_cache(cfg: ModelConfig, spec: BlockSpec, batch: int, cache_len: int, dtype,
                     device="cuda"):
    """A dense cache of ``batch`` rows: attention KV of ``cache_len``
    positions, or the recurrent state (RWKV6's, Mamba2's)."""
    if spec.mixer in ATTENTION_MIXERS:
        return {"attn": attention.init_cache(cfg, batch, cache_len, dtype, device)}
    return _recurrent_cache(cfg, spec, batch, dtype, device)


def _segment_blocks(seg: SegmentSpec):
    """(key, spec) of each block a repeat runs, in the order it runs them:
    the shared block first, where the segment has one, then the body. The
    key names the block's params and its cache; the shared block's params
    are one set for every repeat, the body's are stacked by repeat."""
    shared = [("shared", SHARED_SPEC)] if seg.shared_attn else []
    return shared + [(f"b{bi}", spec) for bi, spec in enumerate(seg.body)]


def init_segment_cache(cfg: ModelConfig, seg: SegmentSpec, batch: int, cache_len: int, dtype,
                       device="cuda"):
    return {
        name: [init_block_cache(cfg, spec, batch, cache_len, dtype, device) for _ in range(seg.repeat)]
        for name, spec in _segment_blocks(seg)
    }


def init_block_cache_paged(cfg: ModelConfig, spec: BlockSpec, num_pages: int, page_size: int,
                           state_batch: int, dtype, device="cuda"):
    """Attention KV lives in the shared page pool (a ``(num_pages,
    page_size, hkv, hd)`` pair of leaves per layer); recurrent state stays
    per slot, at ``state_batch`` rows."""
    if spec.mixer in ATTENTION_MIXERS:
        return {"attn": attention.init_paged_cache(cfg, num_pages, page_size, dtype, device)}
    return _recurrent_cache(cfg, spec, state_batch, dtype, device)


def init_segment_cache_paged(cfg: ModelConfig, seg: SegmentSpec, num_pages: int,
                             page_size: int, state_batch: int, dtype, device="cuda"):
    return {
        name: [
            init_block_cache_paged(cfg, spec, num_pages, page_size, state_batch, dtype, device)
            for _ in range(seg.repeat)
        ]
        for name, spec in _segment_blocks(seg)
    }


def apply_block(params, x, cfg: ModelConfig, spec: BlockSpec, *, positions, cache=None,
                page_table=None, cache_index=None, memory=None, causal: bool = True):
    """Returns (x, new_cache, aux). With ``cache`` None it is the full-sequence
    (training) forward, causal or not; ``memory`` is the encoder output a
    cross-attention block attends to. An attention cache (dense or paged) is updated in
    place and returned; recurrent state (RWKV6's, Mamba2's) comes back as
    new tensors (which the paged engine writes into its slot rows,
    ``LanguageModel.paged_state_merge``)."""
    h = norm.apply(params["norm1"], x, cfg.norm_eps)
    new_cache = cache
    rc = None
    if spec.mixer in ATTENTION_MIXERS:
        window = None
        if spec.mixer == "swa":
            window = spec.sliding_window or cfg.sliding_window
        y, _ = attention.apply(
            params["attn"], h, cfg, positions=positions,
            cache=None if cache is None else cache["attn"],
            page_table=page_table, cache_index=cache_index, sliding_window=window, causal=causal,
        )
        if spec.mixer == "cross_attn_block" and memory is not None:
            x = x + y
            hx = norm.apply(params["norm_cross"], x, cfg.norm_eps)
            y, _ = attention.apply(params["cross_attn"], hx, cfg, positions=positions, memory=memory)
    elif spec.mixer == "mamba2":
        y, mcache = mamba2.apply(params["mamba"], h, cfg,
                                 cache=None if cache is None else cache["mamba"],
                                 cache_index=cache_index)
        if cache is not None:
            new_cache = {"mamba": mcache}
    else:
        rc = None if cache is None else cache["rwkv"]
        decode = cache is not None and x.shape[1] == 1 and cache_index is not None
        y, wkv, shift_t = rwkv6.apply_time_mix(params["tmix"], h, cfg, cache=rc, decode=decode)
    x = x + y
    if spec.ffn == "none":
        return x, new_cache, 0.0
    h = norm.apply(params["norm2"], x, cfg.norm_eps)
    if spec.ffn == "dense":
        return x + mlp.apply(params["mlp"], h), new_cache, 0.0
    if spec.ffn == "moe":
        y, aux = moe.apply(params["moe"], h, cfg)
        if cfg.moe_dense_residual:
            y = y + mlp.apply(params["mlp"], h)
        return x + y, new_cache, aux
    y, shift_c = rwkv6.apply_channel_mix(params["cmix"], h, cfg, cache=rc)
    if cache is not None:
        new_cache = {"rwkv": {"wkv": wkv, "shift_t": shift_t, "shift_c": shift_c}}
    return x + y, new_cache, 0.0


def _train_block(params, x, cfg: ModelConfig, spec: BlockSpec, positions, memory, causal):
    x, _, aux = apply_block(params, x, cfg, spec, positions=positions, memory=memory, causal=causal)
    return x, aux


def apply_segment(params, x, cfg: ModelConfig, seg: SegmentSpec, *, positions, cache=None,
                  page_table=None, cache_index=None, memory=None, causal: bool = True):
    """Run the segment's layers in order. Returns (x, new_cache, aux: the
    layers' router losses summed); with ``cache`` None it is the
    full-sequence (training) forward, rematerialized per block (the shared
    block's every application too) when ``cfg.remat`` is set. ``memory``
    and ``causal`` reach every block (the memory under remat too, so the
    encoder's gradient flows through each decoder block's recomputation)."""
    aux = 0.0
    if cache is None:
        remat = cfg.remat and torch.is_grad_enabled()
        if remat and cfg.remat_policy != "nothing_saveable":
            raise NotImplementedError(
                f"remat policy {cfg.remat_policy!r} comes with a later slice; "
                "the port has nothing_saveable"
            )
        for r in range(seg.repeat):
            for name, spec in _segment_blocks(seg):
                p = params[name] if name == "shared" else params[name][r]
                if remat:
                    x, a = checkpoint(_train_block, p, x, cfg, spec, positions, memory, causal,
                                      use_reentrant=False)
                else:
                    x, a = _train_block(p, x, cfg, spec, positions, memory, causal)
                aux = aux + a
        return x, None, aux
    new_cache = {name: list(layers) for name, layers in cache.items()}
    for r in range(seg.repeat):
        for name, spec in _segment_blocks(seg):
            p = params[name] if name == "shared" else params[name][r]
            x, new_cache[name][r], a = apply_block(
                p, x, cfg, spec, positions=positions, cache=cache[name][r],
                page_table=page_table, cache_index=cache_index, memory=memory, causal=causal,
            )
            aux = aux + a
    return x, new_cache, aux
