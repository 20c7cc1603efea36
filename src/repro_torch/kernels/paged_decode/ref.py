"""Plain PyTorch versions of the paged-decode kernel family.

Each mirrors the masking/scaling/softcap semantics of the CUDA kernel it
stands beside, but materializes the table-gathered KV view, which the
kernels exist to avoid. The CPU path of ``ops`` runs these; the CUDA path
never does. Math is float32; outputs take the query's type.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0e38  # the attention mask fill


def _gather(leaf, page_table):
    """(P, ps, hkv, hd), (B, MP) -> slot-major dense (B, MP*ps, hkv, hd).
    Table entries are clamped into the pool, as a JAX gather clamps."""
    b, mp = page_table.shape
    idx = page_table.reshape(-1).long().clamp(0, leaf.shape[0] - 1)
    return leaf[idx].reshape((b, mp * leaf.shape[1]) + tuple(leaf.shape[2:]))


def _gathered_kv(k_pages, v_pages, page_table, hq):
    hkv = k_pages.shape[2]
    kg = _gather(k_pages, page_table).float()
    vg = _gather(v_pages, page_table).float()
    if hkv != hq:
        kg = kg.repeat_interleave(hq // hkv, dim=2)
        vg = vg.repeat_interleave(hq // hkv, dim=2)
    return kg, vg


def _masked_softmax(s, q_pos, k_pos, sliding_window, softcap):
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = k_pos <= q_pos
    if sliding_window is not None:
        mask = mask & (k_pos > q_pos - sliding_window)
    return torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)


def paged_attention_ref(
    q,
    k_pages,
    v_pages,
    page_table,
    positions,
    *,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
):
    """Single-token paged decode attention, gather-then-attend.

    q: (B, Hq, D); k_pages/v_pages: (P, ps, Hkv, D); page_table: (B, MP);
    positions: (B,), the write position of the current token (so KV at
    logical positions <= positions[b] is attended). Returns (B, Hq, D).
    """
    d = q.shape[-1]
    kg, vg = _gathered_kv(k_pages, v_pages, page_table, q.shape[1])
    s = torch.einsum("bnh,btnh->bnt", q.float(), kg) * d**-0.5
    k_pos = torch.arange(kg.shape[1], device=q.device)[None, None, :]
    q_pos = positions.long()[:, None, None]
    pr = _masked_softmax(s, q_pos, k_pos, sliding_window, softcap)
    return torch.einsum("bnt,btnh->bnh", pr, vg).to(q.dtype)


def paged_prefill_ref(
    q,
    k_pages,
    v_pages,
    page_table,
    pos_start,
    *,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
):
    """Chunked-prefill paged attention: queries at contiguous positions
    ``[pos_start[b], pos_start[b] + C)`` attend causally over the table view.

    q: (B, C, Hq, D); pos_start: (B,). Returns (B, C, Hq, D).
    """
    c, d = q.shape[1], q.shape[-1]
    kg, vg = _gathered_kv(k_pages, v_pages, page_table, q.shape[2])
    s = torch.einsum("bqnh,btnh->bnqt", q.float(), kg) * d**-0.5
    q_pos = pos_start.long()[:, None] + torch.arange(c, device=q.device)[None, :]
    k_pos = torch.arange(kg.shape[1], device=q.device)
    pr = _masked_softmax(s, q_pos[:, None, :, None], k_pos, sliding_window, softcap)
    return torch.einsum("bnqt,btnh->bqnh", pr, vg).to(q.dtype)


def fused_sample_ref(logits, noise, temperature, top_k):
    """Per-row token sampling with the gumbel noise given. logits: (B, V)
    f32; noise: (B, V) f32; temperature: (B,) f32 (0 -> greedy); top_k:
    (B,) int (0 -> full vocab). Greedy is the first-index argmax; a sampled
    row keeps the logits at or above its k-th largest (duplicates counted),
    divides by the temperature, adds the noise and takes the first-index
    argmax. Returns (B,) int32 tokens."""
    v = logits.shape[1]
    greedy = torch.argmax(logits, dim=-1)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, 1, (top_k.long() - 1).clamp(0, v - 1)[:, None])
    masked = torch.where((top_k[:, None] > 0) & (logits < kth), -torch.inf, logits)
    scaled = masked / temperature.clamp_min(1e-6)[:, None]
    sampled = torch.argmax(scaled + noise, dim=-1)
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)
