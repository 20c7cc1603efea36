"""Grouped-query attention: GQA (num_kv_heads <= num_heads), optional QKV
bias (qwen2.5), rotary embeddings, causal / sliding-window masks and
attention-logit soft-capping.

Three execution modes are ported:

- full sequence (training; ``cache`` None): every query attends to the
  sequence under the causal/window mask, through kernels/flash_attention
  (forward and backward kernels for a CUDA tensor, the plain versions for a
  CPU tensor). The JAX package runs its ``_sdpa`` (or ``_sdpa_chunked``
  above ``attn_chunk``) here unless ``use_flash_kernel`` is set; the port
  always takes its kernel, and the tests show that the results agree.
  Soft-capping (gemma2) and cross-attention memory (whisper) come with
  their slices;
- chunked prefill (``s > 1`` with a paged cache): the chunk's KV is written
  at its absolute positions and its queries attend through the page table
  to every earlier position plus the chunk itself;
- paged decode (``s == 1``): one token per slot, each at its own depth.

The paged modes go through kernels/paged_decode. The dense-cache decode
mode comes with the dense-serving slice.

The cache is updated in place. The JAX package donates the paged cache to
each step and gets the updated buffer back; here each layer's
``(num_pages, page_size, hkv, hd)`` pool is written with ``index_put_``,
so a tick never copies the pool.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_decode import ops as paged_ops
from repro_torch.models.layers import rope


def init(gen: torch.Generator, cfg, device="cuda"):
    d = cfg.d_model
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dtype = getattr(torch, cfg.param_dtype)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device) * scale

    params = {
        "wq": normal((d, hq, hd), d**-0.5),
        "wk": normal((d, hkv, hd), d**-0.5),
        "wv": normal((d, hkv, hd), d**-0.5),
        "wo": normal((hq, hd, d), (hq * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            params[name] = torch.zeros((heads, hd), dtype=dtype, device=device)
    return params


def init_paged_cache(cfg, num_pages: int, page_size: int, dtype, device="cuda"):
    """Paged KV store: ``(num_pages, page_size, hkv, hd)`` per leaf. Page ids
    are global across layers (one logical page = a slab through every
    attention leaf); slots map logical→physical pages via a page table."""
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _paged_write(leaf, val, page_table, positions):
    """Scatter ``val`` (B, S, hkv, hd) into the paged ``leaf``
    (P, ps, hkv, hd), in place, at logical ``positions`` (B, S) through
    ``page_table`` (B, max_pages).

    Out-of-range indices follow the JAX package's gather/scatter rules,
    which CUDA indexing would turn into a device-side assert: a logical page
    past the table is clamped to its last entry (a negative one counts from
    the end), and a table entry outside ``[0, P)`` sends its row to scratch
    page 0, which is never read unmasked (JAX drops that row). Rows whose
    table entry is 0 land in the scratch page too."""
    num_pages, ps = leaf.shape[0], leaf.shape[1]
    mp = page_table.shape[1]
    logical = positions.long() // ps
    logical = torch.where(logical < 0, logical + mp, logical).clamp(0, mp - 1)
    rows = torch.arange(page_table.shape[0], device=leaf.device)[:, None]
    phys = page_table[rows, logical].reshape(-1).long()
    phys = torch.where((phys < 0) | (phys >= num_pages), 0, phys)
    off = (positions.long() % ps).reshape(-1)
    leaf.index_put_((phys, off), val.reshape((-1,) + val.shape[2:]).to(leaf.dtype))


def _project_qkv(params, x):
    dtype = x.dtype
    q = torch.einsum("bsd,dnh->bsnh", x, params["wq"].to(dtype))
    k = torch.einsum("bsd,dnh->bsnh", x, params["wk"].to(dtype))
    v = torch.einsum("bsd,dnh->bsnh", x, params["wv"].to(dtype))
    if "bq" in params:
        q = q + params["bq"].to(dtype)
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    return q, k, v


def apply(
    params,
    x,
    cfg,
    *,
    positions,
    cache=None,
    page_table=None,
    cache_index=None,
    sliding_window: Optional[int] = None,
):
    """Returns (out, cache); a paged ``cache`` is updated in place.

    full sequence: ``cache`` is None; ``positions`` (B, S) or (1, S).
    decode: ``x`` is (B, 1, d) and ``cache_index`` a scalar or (B,) int.
    chunked prefill: ``x`` is (B, C, d), ``cache_index`` None, and
    ``positions`` (B, C) are contiguous from each row's start.
    """
    b, s, _ = x.shape
    decode = s == 1 and cache_index is not None
    cap = cfg.attn_logit_softcap
    if cache is None and cap is not None:
        raise NotImplementedError(
            "full-sequence attention with logit soft-capping comes with the gemma2 slice"
        )
    if cache is not None and decode != (s == 1):
        raise ValueError("against a paged cache, a one-token step takes a cache_index and a "
                         "chunk (s > 1) takes none")
    q, k, v = _project_qkv(params, x)
    q = rope.apply_rope(q, positions, cfg.rope_theta)

    if cache is None:  # full sequence
        k = rope.apply_rope(k, torch.arange(s, device=x.device)[None, :], cfg.rope_theta)
        out = flash_ops.flash_attention(q, k, v, causal=True, sliding_window=sliding_window)
        return torch.einsum("bsnh,nhd->bsd", out, params["wo"].to(out.dtype)), None

    k = rope.apply_rope(k, positions, cfg.rope_theta)
    if not decode:  # chunked prefill
        write_pos = positions.expand(b, s)
        _paged_write(cache["k"], k, page_table, write_pos)
        _paged_write(cache["v"], v, page_table, write_pos)
        out = paged_ops.paged_chunk_prefill(
            q, cache["k"], cache["v"], page_table, write_pos[:, 0],
            sliding_window=sliding_window, softcap=cap,
        )
    else:
        idx = torch.as_tensor(cache_index, dtype=torch.int32, device=x.device)
        if idx.ndim == 0:
            idx = idx.expand(b)
        _paged_write(cache["k"], k, page_table, idx[:, None])
        _paged_write(cache["v"], v, page_table, idx[:, None])
        out = paged_ops.paged_flash_decode(
            q[:, 0], cache["k"], cache["v"], page_table, idx,
            sliding_window=sliding_window, softcap=cap,
        )[:, None]
    y = torch.einsum("bsnh,nhd->bsd", out, params["wo"].to(out.dtype))
    return y, cache
