"""The language model: embeddings → segments → logits, for training (the
full-sequence ``forward``) and for serving over a dense or a paged cache.

Parameters are a plain tree of tensors with the JAX package's names and
layouts (``wq (d, hq, hd)``, ``wo (hq, hd, d)``, ...), except that each
segment's scanned ``layers`` axis is unstacked into a list of per-layer
trees. Weights stay at ``param_dtype`` and are cast to ``compute_dtype``
where they are used, as in the JAX package.

The dense cache mirrors the JAX tree with the layers as lists: per
attention layer ``{"attn": {"k", "v"}}`` of ``(B, cache_len, hkv, hd)``,
per RWKV6 layer ``{"rwkv": {"wkv", "shift_t", "shift_c"}}`` and per Mamba2
layer ``{"mamba": {"ssm", "conv"}}`` at B rows, so axis 0 of every leaf is
the batch row (the slot); ``cache_insert`` and ``cache_extract`` move rows
between caches. zamba2's shared attention block has a cache of its own per
repeat, under the segment's ``"shared"`` key.

The paged cache mirrors the JAX tree the same way. Per attention layer
(the shared block's included), a ``{"attn": {"k", "v"}}`` pair of
``(num_pages, page_size, hkv, hd)`` pools, one page id indexing every
layer at once, which the steps update in place. Per recurrent layer, its
state at ``state_batch`` rows (one per slot), which a step computes anew
and the ``paged_state_*`` helpers write back into the slot rows.

An encoder-decoder model (whisper) adds a non-causal encoder segment over
the batch's ``audio_embeds`` (B, T, d): stubbed frame embeddings, as in the
JAX package, whose mel/conv frontend is out of scope there too. Its output,
the ``memory``, is what every decoder block cross-attends to; the serving
steps take it as an argument (the engines encode each request once).
"""
from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import VISION_EMBED_DIM, BlockSpec, ModelConfig, SegmentSpec
from repro_torch.models import blocks
from repro_torch.models.layers import embedding, norm


class LanguageModel:
    """Functional model: ``params = lm.init(seed)``, then ``forward`` or the
    serving steps."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # -- init ---------------------------------------------------------------
    def init(self, seed: int = 0, device="cuda") -> Any:
        """Random parameters from a ``torch.Generator`` seeded with ``seed``,
        on ``device`` (the JAX package's scales; not its random stream).
        On ``"meta"`` the same tree of empty tensors (:meth:`abstract_init`)."""
        cfg = self.cfg
        gen = None if torch.device(device).type == "meta" else torch.Generator(device=device).manual_seed(seed)
        params = {"embed": embedding.init(gen, cfg, device)}
        for i, seg in enumerate(cfg.segments):
            params[f"seg{i}"] = blocks.init_segment(gen, cfg, seg, device)
        dtype = getattr(torch, cfg.param_dtype)
        params["final_norm"] = norm.init(cfg.d_model, dtype, device)
        if cfg.is_encoder_decoder:
            params["encoder"] = blocks.init_segment(gen, cfg, self.encoder_segment(), device)
            params["encoder_norm"] = norm.init(cfg.d_model, dtype, device)
        if cfg.num_vision_tokens:
            d = cfg.d_model
            params["vision_proj"] = {
                "w1": torch.randn((VISION_EMBED_DIM, d), generator=gen, dtype=dtype, device=device)
                * VISION_EMBED_DIM**-0.5,
                "w2": torch.randn((d, d), generator=gen, dtype=dtype, device=device) * d**-0.5,
            }
        return params

    def abstract_init(self) -> Any:
        """The tree :meth:`init` builds, as meta tensors of its shapes and
        dtypes: nothing is allocated or drawn (the dry run's state)."""
        return self.init(device="meta")

    def param_axes(self) -> Any:
        """The logical axes of :meth:`init`'s leaves, in the JAX package's
        layout (its ``init``'s second tree): each segment's body leaves
        stacked over a leading ``"layers"`` entry. ``train/state.py``'s
        ``unstack_axes`` lays them over the port's per-layer lists."""
        cfg = self.cfg
        axes = {"embed": embedding.param_axes(cfg)}
        for i, seg in enumerate(cfg.segments):
            axes[f"seg{i}"] = blocks.segment_axes(cfg, seg)
        axes["final_norm"] = norm.param_axes()
        if cfg.is_encoder_decoder:
            axes["encoder"] = blocks.segment_axes(cfg, self.encoder_segment())
            axes["encoder_norm"] = norm.param_axes()
        if cfg.num_vision_tokens:
            axes["vision_proj"] = {"w1": (None, "embed"), "w2": ("embed", "embed")}
        return axes

    def cache_axes(self) -> Any:
        """The logical axes of the dense cache, in the JAX package's layout."""
        return {f"seg{i}": blocks.segment_cache_axes(seg) for i, seg in enumerate(self.cfg.segments)}

    def encoder_segment(self) -> SegmentSpec:
        """The encoder: ``encoder_layers`` attention blocks with the dense
        FFN, run non-causal."""
        return SegmentSpec(body=(BlockSpec(mixer="attn", ffn="dense"),), repeat=self.cfg.encoder_layers)

    def _encode(self, params, batch):
        """The encoder's output (the memory, (B, T, d) in ``compute_dtype``)
        from ``batch["audio_embeds"]`` (B, T, d); None for a decoder-only
        model. An encoder-decoder batch without audio embeddings raises,
        naming them."""
        cfg = self.cfg
        if not cfg.is_encoder_decoder:
            return None
        if "audio_embeds" not in batch:
            raise ValueError(f"{cfg.name} is an encoder-decoder model: its batch needs 'audio_embeds' "
                             f"(B, {cfg.encoder_seq}, {cfg.d_model}), the frames its encoder reads")
        mem = batch["audio_embeds"].to(getattr(torch, cfg.compute_dtype))
        pos = torch.arange(mem.shape[1], device=mem.device)[None, :]
        mem, _, _ = blocks.apply_segment(params["encoder"], mem, cfg, self.encoder_segment(),
                                         positions=pos, causal=False)
        return norm.apply(blocks.whole(params["encoder_norm"]), mem, cfg.norm_eps)

    def _embed_inputs(self, params, batch, embed=None):
        """Token embeddings (from ``embed``, default ``params["embed"]``);
        with ``vision_embeds`` (B, P, 1024) in the batch (internvl2's stubbed
        vision frontend), the first ``num_vision_tokens`` positions are their
        projections instead (two products with a tanh GELU between, as
        ``jax.nn.gelu``)."""
        cfg = self.cfg
        x = embedding.embed(params["embed"] if embed is None else embed, batch["tokens"], cfg)
        if cfg.num_vision_tokens and "vision_embeds" in batch:
            proj = blocks.whole(params["vision_proj"])
            h = batch["vision_embeds"].to(x.dtype) @ proj["w1"].to(x.dtype)
            h = F.gelu(h, approximate="tanh") @ proj["w2"].to(x.dtype)
            nv = cfg.num_vision_tokens
            x = torch.cat([h[:, :nv], x[:, nv:]], dim=1)
        return x

    # -- train forward --------------------------------------------------------
    def forward(self, params, batch):
        """batch: {tokens (B, S) int, [vision_embeds (B, P, 1024)],
        [audio_embeds (B, T, d): an encoder-decoder model's, required
        there]}. Returns (logits (B, S, V) f32 of the decoder, aux loss: the
        router losses summed over the layers, an f32 scalar, 0 for a model
        without a router). Each subtree is made whole (``blocks.whole``)
        where it is used: a tied table once, for the lookup and the head."""
        cfg = self.cfg
        tied = cfg.tie_embeddings
        table = blocks.whole(params["embed"], None if tied else (lambda k: k == "table"))
        x = self._embed_inputs(params, batch, table)
        memory = self._encode(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, seg in enumerate(cfg.segments):
            x, _, a = blocks.apply_segment(params[f"seg{i}"], x, cfg, seg, positions=positions,
                                           memory=memory)
            aux = aux + a
        x = norm.apply(blocks.whole(params["final_norm"]), x, cfg.norm_eps)
        head = table if tied else blocks.whole(params["embed"], lambda k: k == "unembed")
        return embedding.logits(head, x, cfg), aux

    # -- dense cache ----------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16, device="cuda"):
        return {
            f"seg{i}": blocks.init_segment_cache(self.cfg, seg, batch, cache_len, dtype, device)
            for i, seg in enumerate(self.cfg.segments)
        }

    def cache_insert(self, cache, slot_cache, slot: int):
        """Write the rows of ``slot_cache`` (e.g. a batch-1 prefill, or a
        whole narrower ring) into ``cache`` from row ``slot`` on, in place.
        Returns ``cache``."""
        def put(full, part):
            full[slot:slot + part.shape[0]].copy_(part)
            return full

        return self._map_paged(put, put, cache, slot_cache)

    def cache_extract(self, cache, slot: int):
        """A batch-1 copy of row ``slot`` (the inverse of :meth:`cache_insert`)."""
        def row(full):
            return full[slot:slot + 1].clone()

        return self._map_paged(row, row, cache)

    # -- paged KV cache -------------------------------------------------------
    # One merged tree: attention leaves live in the shared page pool (a page
    # id indexes axis 0 of every attention leaf at once), while O(1)
    # recurrent state stays per slot (axis 0 of each state leaf is the
    # slot). The helpers below walk the tree and dispatch on which side of
    # that split a leaf is on (anything under an "attn" key is paged KV).
    def init_paged_cache(self, num_pages: int, page_size: int, state_batch: int,
                         dtype=torch.bfloat16, device="cuda"):
        return {
            f"seg{i}": blocks.init_segment_cache_paged(
                self.cfg, seg, num_pages, page_size, state_batch, dtype, device
            )
            for i, seg in enumerate(self.cfg.segments)
        }

    @staticmethod
    def _map_paged(kv_fn: Callable, state_fn: Callable, *trees, _in_attn: bool = False):
        """Walk one or more trees of one structure, leaf by leaf: ``kv_fn``
        on the leaves under an "attn" key, ``state_fn`` on the others."""
        first = trees[0]
        if isinstance(first, dict):
            return {k: LanguageModel._map_paged(kv_fn, state_fn, *(t[k] for t in trees),
                                                _in_attn=_in_attn or k == "attn")
                    for k in first}
        if isinstance(first, list):
            return [LanguageModel._map_paged(kv_fn, state_fn, *xs, _in_attn=_in_attn)
                    for xs in zip(*trees)]
        return kv_fn(*trees) if _in_attn else state_fn(*trees)

    def _kv_leaves(self, cache) -> List[torch.Tensor]:
        leaves: List[torch.Tensor] = []
        self._map_paged(leaves.append, lambda leaf: None, cache)
        return leaves

    def paged_state_slice(self, cache, width: int):
        """Static-width view: state rows [:width], paged KV untouched."""
        return self._map_paged(lambda leaf: leaf, lambda leaf: leaf[:width], cache)

    def paged_state_merge(self, full, new, width: int, active=None):
        """Write a width-sliced step's updated state rows back into the
        full-width buffers, in place; the paged KV is the step's (updated in
        place already). With ``active`` (width,) bool, only active rows take
        the new state: a masked lane must not advance its recurrence (a slot
        awaiting its next prefill chunk rides the tick as a dead lane; its
        attention writes land at positions the chunk will overwrite, but a
        recurrent state update would be irreversible corruption)."""
        def upd(f, n):
            n = n.to(f.dtype)
            if active is not None:
                mask = active.reshape((active.shape[0],) + (1,) * (n.ndim - 1))
                n = torch.where(mask, n, f[:width])
            f[:width].copy_(n)
            return f

        return self._map_paged(lambda f, n: n, upd, full, new)

    def paged_state_row(self, cache, slot: int):
        """Batch-1 view for a chunk prefill: state row ``slot``, the full
        paged KV riding along."""
        return self._map_paged(lambda leaf: leaf, lambda leaf: leaf[slot:slot + 1], cache)

    def paged_state_merge_row(self, full, new, slot: int):
        """Write a chunk prefill's state row back into row ``slot``, in place."""
        def upd(f, n):
            f[slot:slot + 1].copy_(n)
            return f

        return self._map_paged(lambda f, n: n, upd, full, new)

    def paged_zero_state_row(self, cache, slot: int):
        """Clear slot ``slot``'s recurrent state at admission, in place (the
        row may hold a previous occupant's state; attention pages need no
        clearing: the causal mask never reads unwritten positions)."""
        def zero(leaf):
            leaf[slot].zero_()
            return leaf

        return self._map_paged(lambda leaf: leaf, zero, cache)

    def paged_copy_page(self, cache, src: int, dst: int):
        """Copy-on-write: duplicate physical page ``src`` into ``dst`` across
        every attention leaf (the divergence page of a partial prefix match),
        in place."""
        for leaf in self._kv_leaves(cache):
            leaf[dst].copy_(leaf[src])
        return cache

    def paged_export_slot(self, cache, page_ids, slot: int):
        """One slot's streamable state (disaggregated serving): the attention
        pages ``page_ids`` ((K,) int64 tensor on the cache's device, padded
        with the scratch page 0 past the prompt) gathered along the page
        axis, and the slot's recurrent state row. The result has the cache's
        tree structure and pool-size-free shapes, ``(K, page_size, ...)`` KV
        and ``(1, ...)`` state, so it can be moved to another device and
        scattered into a pool of any size there. Every leaf is a copy: the
        prefill pool's pages and row are reused as soon as the export
        returns, and on one device the move across the seam copies nothing."""
        return self._map_paged(lambda leaf: leaf.index_select(0, page_ids),
                               lambda leaf: leaf[slot:slot + 1].clone(), cache)

    def paged_import_slot(self, cache, block, page_ids, slot: int):
        """Scatter a streamed export into this pool's pages and state row
        ``slot``, in place. ``page_ids`` ((K,) host ints) maps each lane of
        the block to its page here; a lane mapped to 0 (padding, or a page
        the local prefix index already holds) is not written, so the scratch
        page 0 is never touched and no page is written twice."""
        ids = np.asarray(page_ids, np.int64)
        lanes = np.flatnonzero(ids)
        index = {}  # (lanes, pages) as tensors, once a device

        def on(device):
            if device not in index:
                index[device] = (torch.from_numpy(lanes).to(device), torch.from_numpy(ids[lanes]).to(device))
            return index[device]

        def put_pages(full, part):
            lanes_part = part.index_select(0, on(part.device)[0])
            full.index_copy_(0, on(full.device)[1], lanes_part.to(full.device, full.dtype))
            return full

        def put_row(full, part):
            full[slot:slot + 1].copy_(part)
            return full

        return self._map_paged(put_pages, put_row, cache, block)

    def paged_kv_bytes_per_page(self, page_size: int, dtype=torch.bfloat16) -> int:
        """Host-side accounting: bytes one page occupies across all
        attention leaves (the unit of the pool's memory high-water mark; 0
        for a model without attention)."""
        cache = self.init_paged_cache(2, page_size, 1, dtype=dtype, device="meta")
        return sum(leaf[0].numel() * leaf.element_size() for leaf in self._kv_leaves(cache))

    # -- serving ----------------------------------------------------------------
    def _segments(self, params, x, cache, *, positions, page_table, cache_index=None, memory=None):
        new_cache = {}
        for i, seg in enumerate(self.cfg.segments):
            x, new_cache[f"seg{i}"], _ = blocks.apply_segment(
                params[f"seg{i}"], x, self.cfg, seg, positions=positions,
                cache=cache[f"seg{i}"], page_table=page_table, cache_index=cache_index, memory=memory,
            )
        return x, new_cache

    def prefill(self, params, batch, cache, memory=None):
        """Full-sequence forward over ``batch["tokens"]`` (B, S), filling the
        dense ``cache`` (B rows, zeroed first) in place. ``memory`` may carry
        an encoder output made already; an encoder-decoder model encodes
        ``batch["audio_embeds"]`` when it is given none. Returns (logits
        (B, 1, V) f32 of the last position, cache: the KV updated in place,
        new recurrent state)."""
        cfg = self.cfg
        embed = blocks.whole(params["embed"])
        x = self._embed_inputs(params, batch, embed)
        if memory is None:
            memory = self._encode(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, new_cache = self._segments(params, x, cache, positions=positions, page_table=None,
                                      memory=memory)
        x = norm.apply(blocks.whole(params["final_norm"]), x[:, -1:, :], cfg.norm_eps)
        return embedding.logits(embed, x, cfg), new_cache

    def decode_step(self, params, token, cache, cache_index, page_table=None, memory=None):
        """One-token decode. token: (B, 1) int; cache_index: scalar int (all
        rows at one depth) or (B,) int (each slot at its own). Without a
        ``page_table`` the cache is dense (:meth:`init_cache`, B rows); with
        one (B, max_pages) it is paged and holds B state rows
        (``paged_state_slice``). Returns (logits (B, 1, V) f32, new cache:
        the KV updated in place, new recurrent state rows, which the paged
        engine writes back with ``paged_state_merge``). An encoder-decoder
        model takes its ``memory`` (B, T, d)."""
        cfg = self.cfg
        embed = blocks.whole(params["embed"])
        x = embedding.embed(embed, token, cfg)
        idx = torch.as_tensor(cache_index, dtype=torch.int32, device=x.device)
        positions = idx.expand(token.shape[0])[:, None]
        x, new_cache = self._segments(params, x, cache, positions=positions,
                                      page_table=page_table, cache_index=idx, memory=memory)
        x = norm.apply(blocks.whole(params["final_norm"]), x, cfg.norm_eps)
        return embedding.logits(embed, x, cfg), new_cache

    def prefill_chunk(self, params, tokens, cache, pos_start: int, slot: int, page_table, memory=None):
        """One chunk of a paged, chunked prefill: ``tokens`` (1, C) are the
        prompt positions ``[pos_start, pos_start + C)`` of the request in
        slot ``slot``, whose pages ``page_table`` (1, max_pages) names. The
        chunk's KV is written into those pages and attends to everything
        already written (shared prefix pages included); recurrent state
        resumes from, and is written back to, row ``slot``. An
        encoder-decoder model takes the request's ``memory`` (1, T, d).
        Returns (logits (1, 1, V) for the chunk's last token, cache)."""
        cfg = self.cfg
        x = embedding.embed(params["embed"], tokens, cfg)
        positions = pos_start + torch.arange(tokens.shape[1], dtype=torch.int32, device=x.device)
        row = self.paged_state_row(cache, slot)
        x, new_row = self._segments(params, x, row, positions=positions[None, :],
                                    page_table=page_table, memory=memory)
        x = norm.apply(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
        return embedding.logits(params["embed"], x, cfg), self.paged_state_merge_row(cache, new_row, slot)
