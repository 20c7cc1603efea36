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
package's ``jax.checkpoint`` does per scanned layer, under the policy
``cfg.remat_policy`` names (:data:`REMAT_POLICIES`, JAX's four names):

- ``nothing_saveable``: each block one region; nothing inside is kept.
- ``dots_saveable``: one region, whose matrix products (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, ``convolution``) are kept for the recomputation
  (``create_selective_checkpoint_contexts``), as JAX's policy keeps
  ``dot_general`` and convolutions.
- ``dots_no_batch``: only the products without batch dimensions: ``mm``
  and ``addmm``, and ``bmm``/``baddbmm`` of batch 1 (the form
  ``torch.einsum`` gives a product with no batch dimension: the
  projections, the FFN, the router); not the MoE experts' ``e``-batched
  products nor ``_sdpa``'s (B x heads).
- ``save_block_outputs``: JAX keeps the outputs it names ``mixer_out`` (an
  attention block's self-attention, Mamba2's mixer) and ``ffn_out`` (the
  dense and MoE FFNs). Here such a block is two regions, split where the
  mixer's branch joins the residual stream: the mid-block residual is the
  second region's input and is kept, and each branch is recomputed from
  its own input, so the FFN's recomputation no longer replays the mixer.
  A named identity kept by a selective policy would keep the tensor but
  save nothing: a non-reentrant recomputation replays the region from its
  input up to each tensor the backward unpacks. RWKV6's blocks name
  nothing in JAX and stay one region.

A policy changes what is kept, never a value: losses and gradients are
the same bits under all four. The kernels' calls (``kernels/accounting.py``)
are opaque to the policies, as a ``pallas_call`` is to JAX's: no tensor
inside a kernel's call is kept, and its outputs are recomputed under every
policy.

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

Under tensor parallelism (the sharded step's ``"tp"`` group in the
attention, MLP, MoE, time-mix, channel-mix and Mamba2 subtrees) each layer
takes and returns the rank's block of the sequence; the blocks themselves
are unchanged. zamba2's shared block is gathered once a segment and applied
before each repeat with that one set of split weights, so its gradient
accumulates over every application, as unsplit.

Each block also returns its router's load-balance loss (the MoE FFN's aux;
0.0 for a block without a router), which ``apply_segment`` sums over the
layers; under remat it is an output of the rematerialized block, so the
router's gradient flows through the recomputation, as the JAX scan's
``(h, aux)`` carry does. The serving paths compute it and drop it.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import BlockSpec, ModelConfig, SegmentSpec
from repro_torch.kernels.accounting import in_kernel
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
    x, new_cache, carry = _mixer_part(params, x, cfg, spec, positions=positions, cache=cache,
                                      page_table=page_table, cache_index=cache_index, causal=causal)
    return _ffn_part(params, x, cfg, spec, positions=positions, cache=cache, new_cache=new_cache,
                     carry=carry, memory=memory)


def _mixer_part(params, x, cfg: ModelConfig, spec: BlockSpec, *, positions, cache=None, page_table=None,
                cache_index=None, causal: bool = True):
    """The block's first half: x plus the mixer's branch (JAX's
    ``mixer_out``; an RWKV6 block's time-mix). Returns (x, new_cache, the
    time-mix's (wkv, shift_t) for the channel mix, or None)."""
    h = norm.apply(params["norm1"], x, cfg.norm_eps)
    new_cache, carry = cache, None
    if spec.mixer in ATTENTION_MIXERS:
        window = None
        if spec.mixer == "swa":
            window = spec.sliding_window or cfg.sliding_window
        y, _ = attention.apply(
            params["attn"], h, cfg, positions=positions,
            cache=None if cache is None else cache["attn"],
            page_table=page_table, cache_index=cache_index, sliding_window=window, causal=causal,
        )
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
        carry = (wkv, shift_t)
    return x + y, new_cache, carry


def _ffn_part(params, x, cfg: ModelConfig, spec: BlockSpec, *, positions, cache=None, new_cache=None,
              carry=None, memory=None):
    """The block's second half: a cross-attention block's attention to the
    ``memory``, then x plus the FFN's branch (JAX's ``ffn_out``). Returns
    (x, new_cache, aux)."""
    if spec.mixer == "cross_attn_block" and memory is not None:
        hx = norm.apply(params["norm_cross"], x, cfg.norm_eps)
        y, _ = attention.apply(params["cross_attn"], hx, cfg, positions=positions, memory=memory)
        x = x + y
    if spec.ffn == "none":
        return x, new_cache, 0.0
    h = norm.apply(params["norm2"], x, cfg.norm_eps)
    if spec.ffn == "dense":
        return x + mlp.apply(params["mlp"], h), new_cache, 0.0
    if spec.ffn == "moe":
        y, aux = moe.apply(params["moe"], h, cfg, dense=params["mlp"] if cfg.moe_dense_residual else None)
        return x + y, new_cache, aux
    rc = None if cache is None else cache["rwkv"]
    y, shift_c = rwkv6.apply_channel_mix(params["cmix"], h, cfg, cache=rc)
    if cache is not None:
        wkv, shift_t = carry
        new_cache = {"rwkv": {"wkv": wkv, "shift_t": shift_t, "shift_c": shift_c}}
    return x + y, new_cache, 0.0


#: the top-level keys of a block's params that its first half (``_mixer_part``) reads; ``_ffn_part`` reads the rest
MIXER_KEYS = frozenset({"norm1", "attn", "mamba", "tmix"})


def whole(params, keep=None):
    """``params`` as whole tensors. The sharded train step and the sharded
    serving forward (``distributed/sharded.py``) hand the model each
    layer's params, and each other subtree, as the worker's stored shards:
    an object whose ``whole(keep)`` gathers them (the top-level keys for
    which ``keep`` is true, or all). Called first thing in a block's
    checkpoint region, the gather is part of the region, so the backward's
    recomputation gathers again and nothing whole outlives the region; the
    serving forward gathers each layer where it runs. A plain tree comes
    back as it is."""
    gather = getattr(params, "whole", None)
    return params if gather is None else gather(keep)


def _is_mixer(key: str) -> bool:
    return key in MIXER_KEYS


def _not_mixer(key: str) -> bool:
    return key not in MIXER_KEYS


def _train_block(params, x, cfg: ModelConfig, spec: BlockSpec, positions, memory, causal):
    x, _, aux = apply_block(whole(params), x, cfg, spec, positions=positions, memory=memory, causal=causal)
    return x, aux


def _train_mixer(params, x, cfg: ModelConfig, spec: BlockSpec, positions, causal):
    return _mixer_part(whole(params, _is_mixer), x, cfg, spec, positions=positions, causal=causal)[0]


def _train_ffn(params, x, cfg: ModelConfig, spec: BlockSpec, positions, memory):
    x, _, aux = _ffn_part(whole(params, _not_mixer), x, cfg, spec, positions=positions, memory=memory)
    return x, aux


_DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm, torch.ops.aten.baddbmm,
         torch.ops.aten.convolution)
_UNBATCHED = (torch.ops.aten.mm, torch.ops.aten.addmm)
_BATCHED = (torch.ops.aten.bmm, torch.ops.aten.baddbmm)


def _save_if(keep):
    def policy(ctx, op, *args, **kwargs):
        if not in_kernel() and keep(op.overloadpacket, args):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _dots(packet, args) -> bool:
    return packet in _DOTS


def _dots_no_batch(packet, args) -> bool:
    if packet in _UNBATCHED:
        return True
    # bmm(input, mat2) and baddbmm(self, batch1, batch2): batch 1 is torch.einsum's unbatched product
    return packet in _BATCHED and args[0 if packet is torch.ops.aten.bmm else 1].shape[0] == 1


#: policy name -> the ``context_fn`` of each block's ``checkpoint`` (None:
#: the default, which keeps nothing); ``save_block_outputs`` also splits
#: the blocks that name outputs (:func:`_splits`)
REMAT_POLICIES = {
    "nothing_saveable": None,
    "dots_saveable": _save_if(_dots),
    "dots_no_batch": _save_if(_dots_no_batch),
    "save_block_outputs": None,
}


def _splits(spec: BlockSpec) -> bool:
    """Whether ``save_block_outputs`` splits the block: JAX names its
    ``mixer_out`` where an attention or Mamba2 mixer is followed by more of
    the block (the FFN, or the cross-attention)."""
    named_mixer = spec.mixer in ATTENTION_MIXERS or spec.mixer == "mamba2"
    return named_mixer and (spec.ffn != "none" or spec.mixer == "cross_attn_block")


def _remat_block(p, x, cfg: ModelConfig, spec: BlockSpec, positions, memory, causal):
    """One block rematerialized under ``cfg.remat_policy``: (x, aux)."""
    policy = cfg.remat_policy
    if policy == "save_block_outputs" and _splits(spec):
        x = checkpoint(_train_mixer, p, x, cfg, spec, positions, causal, use_reentrant=False)
        return checkpoint(_train_ffn, p, x, cfg, spec, positions, memory, use_reentrant=False)
    context_fn = REMAT_POLICIES[policy]
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(_train_block, p, x, cfg, spec, positions, memory, causal, use_reentrant=False, **kw)


def apply_segment(params, x, cfg: ModelConfig, seg: SegmentSpec, *, positions, cache=None,
                  page_table=None, cache_index=None, memory=None, causal: bool = True):
    """Run the segment's layers in order. Returns (x, new_cache, aux: the
    layers' router losses summed); with ``cache`` None it is the
    full-sequence (training) forward, rematerialized per block (the shared
    block's every application too) under ``cfg.remat_policy`` when
    ``cfg.remat`` is set. ``memory``
    and ``causal`` reach every block (the memory under remat too, so the
    encoder's gradient flows through each decoder block's recomputation)."""
    aux = 0.0
    if cache is None:
        remat = cfg.remat and torch.is_grad_enabled()
        if remat and cfg.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {cfg.remat_policy!r}; the policies are {sorted(REMAT_POLICIES)}")
        shared = whole(params["shared"]) if seg.shared_attn else None  # one set for every application
        for r in range(seg.repeat):
            for name, spec in _segment_blocks(seg):
                p = shared if name == "shared" else params[name][r]
                if remat:
                    x, a = _remat_block(p, x, cfg, spec, positions, memory, causal)
                else:
                    x, a = _train_block(p, x, cfg, spec, positions, memory, causal)
                aux = aux + a
        return x, None, aux
    new_cache = {name: list(layers) for name, layers in cache.items()}
    shared = whole(params["shared"]) if seg.shared_attn else None
    for r in range(seg.repeat):
        for name, spec in _segment_blocks(seg):
            p = shared if name == "shared" else whole(params[name][r])
            x, new_cache[name][r], a = apply_block(
                p, x, cfg, spec, positions=positions, cache=cache[name][r],
                page_table=page_table, cache_index=cache_index, memory=memory, causal=causal,
            )
            aux = aux + a
    return x, new_cache, aux
