"""Serving steps: the decode tick of the dense slot ring (continuous
batching), the paged decode tick and chunk prefill, and the page export
and import of disaggregated serving. The dense prefill
and the static batch's decode are ``LanguageModel.prefill`` and
``LanguageModel.decode_step`` themselves.

The JAX package jits each step and donates the cache to it; here a step is
a plain function that updates the cache in place and returns it. On a CUDA
device the paged steps' attention goes through the kernels/paged_decode
kernels and the sampler through the fused sampler kernel; on the CPU
through their plain versions. The dense decode's attention is plain
PyTorch, as it is XLA in the JAX package.

An encoder-decoder model's steps take its encoder ``memory``: the slot
ring's (width, T, d) rows for a decode tick (a step of a narrower ring
than the buffer reads its first ``width`` rows), the request's row for a
chunk prefill.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_decode import ops as paged_ops
from repro_torch.models.lm import LanguageModel


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard gumbel noise ``-log(-log(U))`` on the generator's device,
    with U in ``[tiny, 1)`` so that every value is finite."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_tokens(logits, noise, temperature, top_k):
    """Per-row token sampling. logits: (B, V) f32; noise: (B, V) gumbel;
    temperature: (B,) f32 (0 → greedy); top_k: (B,) int (0 → full vocab).
    Rows are independent, so mixed greedy/sampled requests share one
    decode step. The fused sampler kernel on a CUDA device, its plain
    version on the CPU."""
    return paged_ops.fused_sample(logits, noise, temperature, top_k)


def build_slot_decode_step(model: LanguageModel):
    """Fixed-shape decode tick over the dense slot ring (continuous
    batching): every slot advances one token at its own cache depth; freed
    slots ride along masked out (their sampled token is discarded and their
    depth does not advance), so the step's shapes depend only on the ring
    width.

    Inputs per call: tokens (B, 1) int, cache, cache_pos (B,) int, active
    (B,) bool, temperature (B,) f32, top_k (B,) int, the
    ``torch.Generator`` the sampling noise is drawn from, and an
    encoder-decoder model's memory (B, T, d).
    Returns (next_token (B,), cache, new_pos (B,)).
    """
    vocab = model.cfg.vocab_size

    def step(params, tokens, cache, cache_pos, active, temperature, top_k, generator, memory=None):
        logits, cache = model.decode_step(params, tokens, cache, cache_pos, memory=memory)
        logits = logits[:, -1, :vocab].float().contiguous()
        nxt = sample_tokens(logits, gumbel_noise(logits.shape, generator), temperature, top_k)
        nxt = torch.where(active, nxt, tokens[:, 0])
        new_pos = torch.where(active, cache_pos + 1, cache_pos)
        return nxt, cache, new_pos

    return step


def build_paged_decode_step(model: LanguageModel, width: int):
    """Fixed-width decode tick over a paged slot ring: every lane advances
    one token at its own depth, reading and writing KV through its
    ``page_table`` row. Inactive lanes keep their input token.

    The tick doubles as the tail of a chunked prefill: a slot still being
    prefilled rides along teacher-forced (the host feeds the next prompt
    token), and a slot waiting for its next chunk rides as a dead lane
    whose KV write at its fill position the chunk later overwrites.
    """
    vocab = model.cfg.vocab_size

    def step(params, tokens, cache, cache_pos, page_table, active, temperature, top_k, generator,
             memory=None):
        sliced = model.paged_state_slice(cache, width)
        mem = None if memory is None else memory[:width]
        logits, new_sliced = model.decode_step(params, tokens, sliced, cache_pos, page_table, memory=mem)
        logits = logits[:, -1, :vocab].float().contiguous()
        noise = gumbel_noise(logits.shape, generator)
        nxt = sample_tokens(logits, noise, temperature, top_k)
        nxt = torch.where(active, nxt, tokens[:, 0])
        return nxt, model.paged_state_merge(cache, new_sliced, width, active=active)

    return step


def build_chunk_prefill_step(model: LanguageModel):
    """Paged chunk prefill: one call computes ``chunk`` prompt tokens of one
    request at any position offset."""

    def step(params, tokens, cache, pos_start, slot, page_table, memory=None):
        return model.prefill_chunk(params, tokens, cache, pos_start, slot, page_table, memory=memory)

    return step


def build_page_export_step(model: LanguageModel):
    """Page-streaming gather (disaggregated serving, prefill side): one
    slot's prompt pages and recurrent state row out of the prefill pool, as
    a pool-size-free block of copies (``LanguageModel.paged_export_slot``).
    ``page_ids`` is (max_pages,) on the cache's device, padded with the
    scratch page 0, as in the JAX package."""

    def step(cache, page_ids, slot):
        return model.paged_export_slot(cache, page_ids, slot)

    return step


def build_page_import_step(model: LanguageModel):
    """Page-streaming scatter (disaggregated serving, decode side): a
    streamed block into this pool at the remapped ``page_ids`` ((max_pages,)
    host ints; 0 is a lane not written: padding, or a page the local prefix
    index already holds) and the state row at ``slot``, in place
    (``LanguageModel.paged_import_slot``)."""

    def step(cache, block, page_ids, slot):
        return model.paged_import_slot(cache, block, page_ids, slot)

    return step
