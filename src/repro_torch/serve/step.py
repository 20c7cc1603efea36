"""Serving steps over the paged cache.

The JAX package jits each step and donates the cache to it; here a step is
a plain function that updates the cache in place and returns it. On a CUDA
device every attention layer and the sampler go through the
kernels/paged_decode kernels; on the CPU through their plain versions.
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

    def step(params, tokens, cache, cache_pos, page_table, active, temperature, top_k, generator):
        sliced = model.paged_state_slice(cache, width)
        logits, new_sliced = model.decode_step(params, tokens, sliced, cache_pos, page_table)
        logits = logits[:, -1, :vocab].float().contiguous()
        noise = gumbel_noise(logits.shape, generator)
        nxt = sample_tokens(logits, noise, temperature, top_k)
        nxt = torch.where(active, nxt, tokens[:, 0])
        return nxt, model.paged_state_merge(cache, new_sliced, width, active=active)

    return step


def build_chunk_prefill_step(model: LanguageModel):
    """Paged chunk prefill: one call computes ``chunk`` prompt tokens of one
    request at any position offset."""

    def step(params, tokens, cache, pos_start, slot, page_table):
        return model.prefill_chunk(params, tokens, cache, pos_start, slot, page_table)

    return step
