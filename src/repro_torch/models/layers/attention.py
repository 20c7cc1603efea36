"""Grouped-query attention: GQA (num_kv_heads <= num_heads), optional QKV
bias (qwen2.5), rotary embeddings, causal / sliding-window masks and
attention-logit soft-capping.

Five execution modes are ported:

- full sequence (training; ``cache`` None): every query attends to the
  sequence under the causal/window mask, through kernels/flash_attention
  (forward and backward kernels for a CUDA tensor, the plain versions for a
  CPU tensor). The JAX package runs its ``_sdpa`` (or ``_sdpa_chunked``
  above ``attn_chunk``) here unless ``use_flash_kernel`` is set; the port
  takes its kernel, and the tests show that the results agree. With a
  logit soft-cap (gemma2) the JAX package never takes its flash kernel,
  and neither does the port: the configuration routes it to
  :func:`_sdpa` / :func:`_sdpa_chunked`, plain PyTorch as XLA computes
  them there, differentiated by autograd. A full sequence is causal, or
  not (whisper's encoder, ``causal=False``: the flash kernels without a
  mask, or the soft-capped route with an all-true mask);
- cross-attention (whisper's decoder, ``memory`` (B, T, d) given): K and V
  are projected from the memory, never cached and never rotated, and every
  query attends to every memory position through :func:`_sdpa` with an
  all-true mask, as the JAX package computes it outside any Pallas kernel
  (its ``memory is None`` is a condition of the flash branch); plain
  PyTorch here too. The JAX package recomputes these K and V from the
  memory at every serving step, and so does the port;
- dense prefill (a dense ``cache``, ``s > 1``): the same attention (the
  flash forward, or ``_sdpa`` with a soft-cap), and the whole K/V written
  into the zeroed cache;
- dense decode (a dense ``cache``, ``s == 1``): the new K/V written at a
  scalar ``cache_index`` (static batch) or a ``(B,)`` one (slot ring), and
  the query attends over the cache up to its write position (and within
  the window). The JAX package computes this with XLA's ``_sdpa``, outside
  any Pallas kernel, so it is plain PyTorch here (products and softmax in
  f32);
- chunked prefill (``s > 1`` with a paged cache): the chunk's KV is written
  at its absolute positions and its queries attend through the page table
  to every earlier position plus the chunk itself;
- paged decode (``s == 1`` with a paged cache): one token per slot, each at
  its own depth.

Under tensor parallelism (a ``"tp"`` entry in the params: the sharded
step's group, ``distributed/sharded.py``) the layer takes the rank's block
of the sequence and splits its work over the mesh's ``model`` group as the
JAX package's ``constrain`` of q and the output does: where the heads
divide the group, the rank projects its query heads and the kv heads they
read (its slice of them where the kv heads divide the group too), runs the
same attention on the gathered sequence, and its output projection is a
partial sum over the group, summed onto its block. Where they do not
(JAX's score fallback to ``seq_sp``: 14 heads over 16), every head runs on
the rank's query rows, its block, against the key prefix: the flash
kernel's queries are right-aligned. Serving keeps a dense cache of the
rank's kv heads (:func:`local_kv_heads`).

A ``page_table`` names the cache paged; without one it is dense
``(B, cache_len, hkv, hd)``, as in the JAX package. The paged modes go
through kernels/paged_decode.

The cache is updated in place. The JAX package donates the cache to each
step and gets the updated buffer back; here each layer's buffers are
written with ``copy_`` and ``index_put_``, so a step never copies a cache.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_decode import ops as paged_ops
from repro_torch.models.layers import rope

NEG_INF = -2.0e38


def init(gen: torch.Generator, cfg, device="cuda", cross: bool = False):
    """The layer's weights; a cross-attention layer (``cross``) takes no
    QKV bias, as in the JAX package."""
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
    if cfg.qkv_bias and not cross:
        for name, heads in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            params[name] = torch.zeros((heads, hd), dtype=dtype, device=device)
    return params


def param_axes(cfg, cross: bool = False):
    """The logical axes of :func:`init`'s leaves (``sharding/partitioning.py``)."""
    axes = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.qkv_bias and not cross:
        axes["bq"] = ("heads", "head_dim")
        axes["bk"] = ("kv_heads", "head_dim")
        axes["bv"] = ("kv_heads", "head_dim")
    return axes


def init_cache(cfg, batch: int, cache_len: int, dtype, device="cuda"):
    """Dense KV cache: ``(batch, cache_len, hkv, hd)`` per leaf."""
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


CACHE_AXES = {
    "k": ("batch", "kv_seq", "kv_heads", "head_dim"),
    "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
}


def init_paged_cache(cfg, num_pages: int, page_size: int, dtype, device="cuda"):
    """Paged KV store: ``(num_pages, page_size, hkv, hd)`` per leaf. Page ids
    are global across layers (one logical page = a slab through every
    attention leaf); slots map logical→physical pages via a page table."""
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


PAGED_CACHE_AXES = {
    "k": (None, None, "kv_heads", "head_dim"),
    "v": (None, None, "kv_heads", "head_dim"),
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


def _project_qkv(params, x, memory=None):
    """q from ``x``; k and v from ``memory`` where it is given, else ``x``."""
    dtype = x.dtype
    kv_in = x if memory is None else memory
    q = torch.einsum("bsd,dnh->bsnh", x, params["wq"].to(dtype))
    k = torch.einsum("btd,dnh->btnh", kv_in, params["wk"].to(dtype))
    v = torch.einsum("btd,dnh->btnh", kv_in, params["wv"].to(dtype))
    if "bq" in params:
        q = q + params["bq"].to(dtype)
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    return q, k, v


def _mask(q_pos, k_pos, window: Optional[int], causal: bool = True):
    """Boolean mask (.., q, k), causal or not, within the window if there
    is one: True = attend."""
    m = torch.ones(q_pos.shape[:-1] + (q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = m & (k_pos[..., None, :] <= q_pos[..., :, None])
    if window is not None:
        m = m & (k_pos[..., None, :] > q_pos[..., :, None] - window)
    return m


def _sdpa(q, k, v, mask, cfg):
    """Scaled-dot-product GQA attention as the JAX package's ``_sdpa``: KV
    heads repeated up to the query heads, the logits in f32, scaled,
    soft-capped and masked, the probabilities in q's type. q (B, S, hq, hd),
    k and v (B, T, hkv, hd), mask (B or 1, S, T)."""
    hq, hd = q.shape[2], q.shape[3]
    hkv = k.shape[2]
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    logits = torch.einsum("bsnh,btnh->bnst", q, k).float() * hd**-0.5
    cap = cfg.attn_logit_softcap
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    logits = logits.masked_fill(~mask[:, None, :, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnh->bsnh", probs, v)


def _sdpa_chunked(q, k, v, cfg, *, chunk: int, window: Optional[int], causal: bool = True):
    """:func:`_sdpa` over blocks of ``chunk`` queries, the whole K/V
    resident: (B, heads, chunk, S) logits at a time instead of (B, heads,
    S, S), as the JAX package's ``_sdpa_chunked``; S a multiple of
    ``chunk``."""
    pos = torch.arange(q.shape[1], device=q.device)[None, :]
    outs = []
    for i in range(q.shape[1] // chunk):
        rows = slice(i * chunk, (i + 1) * chunk)
        outs.append(_sdpa(q[:, rows], k, v, _mask(pos[:, rows], pos, window, causal), cfg))
    return torch.cat(outs, dim=1)


def _full_attention(q, k, v, cfg, positions, sliding_window, causal: bool = True):
    """The full-sequence (training and dense prefill) attention, causal or
    not: the flash kernels, or with a logit soft-cap the JAX package's
    ``_sdpa_chunked`` (above ``attn_chunk`` positions, in whole chunks) or
    ``_sdpa``. Where S is not a multiple of ``attn_chunk`` (whisper's
    encoder: 1,500 positions) the JAX package runs ``_sdpa`` over the whole
    sequence and the port its flash kernels; the tests show they agree."""
    if cfg.attn_logit_softcap is None:
        return flash_ops.flash_attention(q, k, v, causal=causal, sliding_window=sliding_window)
    s, chunk = q.shape[1], cfg.attn_chunk
    if chunk is not None and s > chunk and s % chunk == 0:
        return _sdpa_chunked(q, k, v, cfg, chunk=chunk, window=sliding_window, causal=causal)
    mask = _mask(positions, torch.arange(s, device=q.device)[None, :], sliding_window, causal)
    return _sdpa(q, k, v, mask, cfg)


def _dense_decode_attention(q, k_cache, v_cache, write_pos, cap, sliding_window):
    """One query a row (q (B, 1, hq, hd)) over the dense cache
    (B, T, hkv, hd), key positions ``<= write_pos`` (B, 1) and within the
    window: the JAX package's ``_sdpa`` with its decode mask, the products
    and the softmax in f32."""
    b, _, hq, hd = q.shape
    hkv = k_cache.shape[2]
    qg = q[:, 0].float().reshape(b, hkv, hq // hkv, hd)
    logits = torch.einsum("bkgh,btkh->bkgt", qg, k_cache.float()) * hd**-0.5
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    k_pos = torch.arange(k_cache.shape[1], device=q.device)[None, :]
    valid = k_pos <= write_pos
    if sliding_window is not None:
        valid = valid & (k_pos > write_pos - sliding_window)
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", probs, v_cache.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def kv_heads_read(cfg, width: int, me: int):
    """[lo, hi): the kv heads that the query heads of position ``me`` of a
    ``model`` group of ``width`` read, where the query heads divide the
    group and the kv heads do not."""
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    qm, g = hq // width, hq // hkv
    lo, hi = me * qm // g, ((me + 1) * qm - 1) // g + 1
    if qm % (hi - lo):
        raise ValueError(f"{qm} query heads a rank do not group over the {hi - lo} kv heads they read")
    return lo, hi


def local_kv_heads(cfg, width: int) -> int:
    """The kv heads a rank of a ``model`` group of ``width`` projects and
    caches under tensor parallelism: its slice where they divide the group,
    else those its query heads read, or every one where the query heads do
    not divide the group."""
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    if hq % width:
        return hkv
    if hkv % width == 0:
        return hkv // width
    lo, hi = kv_heads_read(cfg, width, 0)
    return hi - lo


def _apply_split(params, x, cfg, tp, *, positions, cache, cache_index, sliding_window, causal):
    """:func:`apply` over the rank's ``model`` group ``tp``: ``x`` (B, c, d)
    is the rank's block of the sequence, and so is the output."""
    local = {k: v for k, v in params.items() if k != "tp"}
    kw = dict(positions=positions, cache=cache, cache_index=cache_index, sliding_window=sliding_window,
              causal=causal)
    if cfg.num_heads % tp.width == 0:
        if cfg.num_kv_heads % tp.width:  # whole kv projections: the rank's query heads read a few heads of them
            lo, hi = kv_heads_read(cfg, tp.width, tp.me)
            local.update({k: local[k][:, lo:hi] for k in ("wk", "wv")})
            local.update({k: local[k][lo:hi] for k in ("bk", "bv") if k in local})
        y, cache = apply(local, tp.gather(x), cfg, **kw)
        return tp.scatter(y), cache
    if cache is not None:  # serving: every head on every rank of the group, each keeping its block
        y, cache = apply(local, tp.gather(x), cfg, **kw)
        return tp.slice(y), cache
    if not causal:
        raise ValueError("the query-row split of attention runs causal attention only")
    # the rank's query rows, every head, against the key prefix [0, hi)
    c = tp.block
    lo, hi = tp.me * c, (tp.me + 1) * c
    q, k, v = _project_qkv(local, x, tp.gather(x, trim=False)[:, :hi])
    q_pos = torch.arange(lo, hi, device=x.device)[None, :]
    k_pos = torch.arange(hi, device=x.device)[None, :]
    q = rope.apply_rope(q, q_pos, cfg.rope_theta)
    k = rope.apply_rope(k, k_pos, cfg.rope_theta)
    if cfg.attn_logit_softcap is None:
        out = flash_ops.flash_attention(q, k, v, causal=True, sliding_window=sliding_window)
    else:
        out = _sdpa(q, k, v, _mask(q_pos, k_pos, sliding_window), cfg)
    return torch.einsum("bsnh,nhd->bsd", out, local["wo"].to(out.dtype)), None


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
    causal: bool = True,
    memory=None,
):
    """Returns (out, cache); a ``cache`` is updated in place.

    full sequence: ``cache`` is None; ``positions`` (B, S) or (1, S);
    ``causal`` False attends to every position (whisper's encoder).
    cross-attention: ``memory`` (B, T, d); no cache, no mask, no RoPE.
    dense prefill: a dense ``cache``, ``x`` (B, S, d), ``cache_index`` None,
    ``positions`` ``arange(S)``.
    decode: ``x`` is (B, 1, d) and ``cache_index`` a scalar or (B,) int.
    chunked prefill: a paged cache, ``x`` (B, C, d), ``cache_index`` None,
    and ``positions`` (B, C) contiguous from each row's start.
    Under tensor parallelism (``params["tp"]``) ``x`` and the output are the
    rank's block of the sequence and a dense cache holds its kv heads;
    ``positions`` are the whole sequence's.
    """
    tp = params.get("tp")
    if tp is not None:
        if page_table is not None or memory is not None:
            raise ValueError("tensor parallelism splits self-attention over a dense cache or none; paged serving "
                             "on a mesh is ROADMAP.md Queue 1 item 6e")
        return _apply_split(params, x, cfg, tp, positions=positions, cache=cache, cache_index=cache_index,
                            sliding_window=sliding_window, causal=causal)
    b, s, _ = x.shape
    if memory is not None:
        q, k, v = _project_qkv(params, x, memory)
        mask = torch.ones((b, s, k.shape[1]), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, mask, cfg)
        return torch.einsum("bsnh,nhd->bsd", out, params["wo"].to(out.dtype)), cache
    decode = s == 1 and cache_index is not None
    cap = cfg.attn_logit_softcap
    prefill = cache is None or (page_table is None and not decode)
    if page_table is not None and decode != (s == 1):
        raise ValueError("against a paged cache, a one-token step takes a cache_index and a "
                         "chunk (s > 1) takes none")
    q, k, v = _project_qkv(params, x)
    q = rope.apply_rope(q, positions, cfg.rope_theta)

    if prefill:  # full sequence, filling a dense cache if there is one
        k = rope.apply_rope(k, torch.arange(s, device=x.device)[None, :], cfg.rope_theta)
        if cache is not None:
            for name, val in (("k", k), ("v", v)):
                cache[name].zero_()
                cache[name][:, :s].copy_(val)
        out = _full_attention(q, k, v, cfg, positions, sliding_window, causal)
        return torch.einsum("bsnh,nhd->bsd", out, params["wo"].to(out.dtype)), cache

    k = rope.apply_rope(k, positions, cfg.rope_theta)
    if page_table is None:  # dense decode
        idx = torch.as_tensor(cache_index, dtype=torch.long, device=x.device)
        rows = torch.arange(b, device=x.device) if idx.ndim else slice(None)
        for name, val in (("k", k), ("v", v)):
            cache[name][rows, idx] = val[:, 0].to(cache[name].dtype)
        write_pos = idx.expand(b)[:, None]
        out = _dense_decode_attention(q, cache["k"], cache["v"], write_pos, cap, sliding_window)
        return torch.einsum("bsnh,nhd->bsd", out, params["wo"].to(out.dtype)), cache
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
