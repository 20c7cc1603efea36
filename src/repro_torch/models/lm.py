"""The language model: embeddings → segments → logits, for training (the
full-sequence ``forward``) and for serving over a paged KV cache.

Parameters are a plain tree of tensors with the JAX package's names and
layouts (``wq (d, hq, hd)``, ``wo (hq, hd, d)``, ...), except that each
segment's scanned ``layers`` axis is unstacked into a list of per-layer
trees. Weights stay at ``param_dtype`` and are cast to ``compute_dtype``
where they are used, as in the JAX package.

The paged cache mirrors the JAX tree the same way: per layer, a
``{"attn": {"k", "v"}}`` pair of ``(num_pages, page_size, hkv, hd)`` pools,
one page id indexing every layer at once. Steps update it in place and
return it.
"""
from __future__ import annotations

from typing import Any, Iterator

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.layers import embedding, norm


class LanguageModel:
    """Functional model: ``params = lm.init(seed)``, then ``forward`` or the
    serving steps."""

    def __init__(self, cfg: ModelConfig):
        blocks.check_supported(cfg)
        self.cfg = cfg

    # -- init ---------------------------------------------------------------
    def init(self, seed: int = 0, device="cuda") -> Any:
        """Random parameters from a ``torch.Generator`` seeded with ``seed``,
        on ``device`` (the JAX package's scales; not its random stream)."""
        cfg = self.cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        params = {"embed": embedding.init(gen, cfg, device)}
        for i, seg in enumerate(cfg.segments):
            params[f"seg{i}"] = blocks.init_segment(gen, cfg, seg, device)
        params["final_norm"] = norm.init(cfg.d_model, getattr(torch, cfg.param_dtype), device)
        return params

    # -- train forward --------------------------------------------------------
    def forward(self, params, batch):
        """batch: {tokens (B, S) int}. Returns (logits (B, S, V) f32, aux loss
        (a zero f32 scalar: the dense models have no router loss))."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embedding.embed(params["embed"], tokens, cfg)
        positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
        for i, seg in enumerate(cfg.segments):
            x, _ = blocks.apply_segment(params[f"seg{i}"], x, cfg, seg, positions=positions)
        x = norm.apply(params["final_norm"], x, cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return embedding.logits(params["embed"], x, cfg), aux

    # -- paged KV cache -------------------------------------------------------
    def init_paged_cache(self, num_pages: int, page_size: int, state_batch: int,
                         dtype=torch.bfloat16, device="cuda"):
        """``state_batch`` sizes recurrent state, which attention-only models
        do not have; it is kept for the JAX signature."""
        return {
            f"seg{i}": blocks.init_segment_cache_paged(
                self.cfg, seg, num_pages, page_size, dtype, device
            )
            for i, seg in enumerate(self.cfg.segments)
        }

    @staticmethod
    def _kv_leaves(cache) -> Iterator[torch.Tensor]:
        for seg in cache.values():
            for layers in seg.values():
                for layer in layers:
                    yield layer["attn"]["k"]
                    yield layer["attn"]["v"]

    # Recurrent state is per slot in the JAX package's paged cache; an
    # attention-only model has none, so these are identities.
    def paged_state_slice(self, cache, width: int):
        return cache

    def paged_state_merge(self, full, new, width: int, active=None):
        return new

    def paged_zero_state_row(self, cache, slot: int):
        return cache

    def paged_copy_page(self, cache, src: int, dst: int):
        """Copy-on-write: duplicate physical page ``src`` into ``dst`` across
        every attention leaf (the divergence page of a partial prefix match),
        in place."""
        for leaf in self._kv_leaves(cache):
            leaf[dst].copy_(leaf[src])
        return cache

    def paged_kv_bytes_per_page(self, page_size: int, dtype=torch.bfloat16) -> int:
        """Host-side accounting: bytes one page occupies across all
        attention leaves (the unit of the pool's memory high-water mark)."""
        cfg = self.cfg
        per_leaf = page_size * cfg.num_kv_heads * cfg.resolved_head_dim * dtype.itemsize
        return 2 * cfg.num_layers * per_leaf

    # -- serving ----------------------------------------------------------------
    def _segments(self, params, x, cache, *, positions, page_table, cache_index=None):
        for i, seg in enumerate(self.cfg.segments):
            x, _ = blocks.apply_segment(
                params[f"seg{i}"], x, self.cfg, seg, positions=positions,
                cache=cache[f"seg{i}"], page_table=page_table, cache_index=cache_index,
            )
        return x

    def decode_step(self, params, token, cache, cache_index, page_table):
        """One-token decode. token: (B, 1) int; cache_index: scalar or (B,)
        int, each slot's depth; page_table: (B, max_pages).
        Returns (logits (B, 1, V) f32, cache)."""
        cfg = self.cfg
        x = embedding.embed(params["embed"], token, cfg)
        idx = torch.as_tensor(cache_index, dtype=torch.int32, device=x.device)
        positions = idx.expand(token.shape[0])[:, None]
        x = self._segments(params, x, cache, positions=positions, page_table=page_table,
                           cache_index=idx)
        x = norm.apply(params["final_norm"], x, cfg.norm_eps)
        return embedding.logits(params["embed"], x, cfg), cache

    def prefill_chunk(self, params, tokens, cache, pos_start: int, slot: int, page_table):
        """One chunk of a paged, chunked prefill: ``tokens`` (1, C) are the
        prompt positions ``[pos_start, pos_start + C)`` of the request in
        slot ``slot``, whose pages ``page_table`` (1, max_pages) names. The
        chunk's KV is written into those pages and attends to everything
        already written (shared prefix pages included).
        Returns (logits (1, 1, V) for the chunk's last token, cache)."""
        cfg = self.cfg
        x = embedding.embed(params["embed"], tokens, cfg)
        positions = pos_start + torch.arange(tokens.shape[1], dtype=torch.int32, device=x.device)
        x = self._segments(params, x, cache, positions=positions[None, :], page_table=page_table)
        x = norm.apply(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
        return embedding.logits(params["embed"], x, cfg), cache
