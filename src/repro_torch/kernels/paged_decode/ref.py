"""Plain PyTorch versions of the paged-decode kernel family.

Each mirrors the masking/scaling/softcap semantics of the CUDA kernel it
stands beside, but materializes the table-gathered KV view, which the
kernels exist to avoid. The CPU path of ``ops`` runs these; the CUDA path
never does. Math is float32; outputs take the query's type.

``paged_decode_split_ref`` and ``paged_prefill_tiled_ref`` instead follow
the bf16 (tensor-core) kernels step for step: 16-key chunks read through the
table, an online softmax per warp, partial (m, l, o) merged in a fixed
order across warps and, for decode, across the splits of a slot;
``fused_sample_split_ref`` follows the sampler's slices, per-slice
candidates and merge. The tests hold them against the JAX package; they are
not on any path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_decode.kernel import (
    CHUNK_KEYS, DECODE_KEY_GROUPS, PREFILL_KEY_GROUPS, PREFILL_TILE_ROWS, SAMPLE_SLACK, decode_layout,
    sample_slices,
)

NEG_INF = -2.0e38  # the attention mask fill
EMPTY = -1.0e30  # the kernels' running max before any visible key


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


def _visible_chunks(qlo: int, qhi: int, key_max: int, window: Optional[int]):
    """Keys that query positions qlo..qhi may see, [key_lo, key_hi] (the
    table addresses keys up to key_max), and their chunks [c_begin, c_end)."""
    key_lo = max(qlo - window + 1, 0) if window else 0
    key_hi = min(qhi, key_max)
    c_begin = key_lo // CHUNK_KEYS
    c_end = key_hi // CHUNK_KEYS + 1 if key_hi >= key_lo else c_begin
    return key_lo, key_hi, c_begin, c_end


def _chunk_kv(k_pages, v_pages, table_row, h, c, key_lo, key_hi):
    """K and V rows (f32) of chunk c's keys for kv head h, each read through
    the table (page index clamped into the pool); keys outside [key_lo,
    key_hi] are zeros, never read. Returns (k, v, key positions)."""
    keys = torch.arange(c * CHUNK_KEYS, (c + 1) * CHUNK_KEYS)
    live = (keys >= key_lo) & (keys <= key_hi)
    at = keys.clamp(key_lo, max(key_hi, key_lo))
    ps = k_pages.shape[1]
    page = table_row[at // ps].long().clamp(0, k_pages.shape[0] - 1)
    k = torch.where(live[:, None], k_pages[page, at % ps, h].float(), 0.0)
    v = torch.where(live[:, None], v_pages[page, at % ps, h].float(), 0.0)
    return k, v, keys


def walk_chunks(q, qlim, qwin, chunk_kv, chunks, scale: float, softcap: Optional[float]):
    """One warp's online softmax: query rows q (R, D) f32 over the given
    chunks, ``chunk_kv(c)`` -> (k, v, keys); row r sees key t iff qwin[r] <
    t <= qlim[r]. Scores are scaled after the product, then soft-capped.
    Returns the partial (m (R,), l (R,), o (R, D)); with no visible key it is
    (EMPTY, 0, 0)."""
    m = torch.full((q.shape[0],), EMPTY)
    l = torch.zeros(q.shape[0])
    o = torch.zeros(q.shape)
    for c in chunks:
        k, v, keys = chunk_kv(c)
        s = (q @ k.T) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        seen = (keys[None, :] <= qlim[:, None]) & (keys[None, :] > qwin[:, None])
        s = torch.where(seen, s, EMPTY)
        m_new = torch.maximum(m, s.max(dim=1).values)
        p = torch.where(seen, torch.exp(s - m_new[:, None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=1)
        o = o * alpha[:, None] + p @ v
        m = m_new
    return m, l, o


def merge_partials(parts):
    """Partials (m, l, o) over disjoint keys, merged in their order as the
    kernels merge warps and splits: M = max m, L = sum l exp(m - M), O = sum
    o exp(m - M). A partial with no visible key adds exactly 0."""
    big_m = parts[0][0]
    for m, _, _ in parts[1:]:
        big_m = torch.maximum(big_m, m)
    big_l, big_o = 0.0, 0.0
    for m, l, o in parts:
        f = torch.exp(m - big_m)
        big_l = big_l + l * f
        big_o = big_o + o * f[:, None]
    return big_m, big_l, big_o


def paged_decode_split_ref(q, k_pages, v_pages, page_table, positions, *, sliding_window=None,
                           softcap=None, partials: Optional[list] = None):
    """Decode as the bf16 kernels compute it: a slot's visible chunks in
    the kernel's splits for this table width (``decode_layout``), each
    split's chunks dealt to DECODE_KEY_GROUPS warps in turn and merged in
    order, each live split's partial (m, l, o), then the live splits merged
    in index order, out = O / max(L, 1e-30). Arguments as
    :func:`paged_attention_ref`; ``partials`` collects (b, kv head, split,
    m, l, o) of every live split."""
    nb, hq, d = q.shape
    hkv, ps, mp = k_pages.shape[2], k_pages.shape[1], page_table.shape[1]
    group = hq // hkv
    split_chunks = decode_layout(mp, ps)[0]
    out = torch.empty((nb, hq, d))
    for b in range(nb):
        pos = int(positions[b])
        key_lo, key_hi, c_begin, c_end = _visible_chunks(pos, pos, mp * ps - 1, sliding_window)
        qlim = torch.full((group,), min(pos, key_hi))
        qwin = torch.full((group,), pos - sliding_window if sliding_window else -1)
        live = range(c_begin // split_chunks, (c_end - 1) // split_chunks + 1) if c_end > c_begin else []
        for h in range(hkv):
            qh = q[b, h * group:(h + 1) * group].float()

            def chunk_kv(c):
                return _chunk_kv(k_pages, v_pages, page_table[b], h, c, key_lo, key_hi)

            splits = []
            for s in live:
                lo, hi = max(c_begin, s * split_chunks), min(c_end, (s + 1) * split_chunks)
                warps = [walk_chunks(qh, qlim, qwin, chunk_kv, range(lo + w, hi, DECODE_KEY_GROUPS), d**-0.5,
                                     softcap)
                         for w in range(DECODE_KEY_GROUPS)]
                splits.append(merge_partials(warps))
                if partials is not None:
                    partials.append((b, h, s) + splits[-1])
            if splits:
                _, big_l, big_o = merge_partials(splits)
                out[b, h * group:(h + 1) * group] = big_o / big_l.clamp_min(1e-30)[:, None]
            else:
                out[b, h * group:(h + 1) * group] = 0.0
    return out.to(q.dtype)


def paged_prefill_tiled_ref(q, k_pages, v_pages, page_table, pos_start, *, sliding_window=None,
                            softcap=None):
    """Chunk prefill as the bf16 kernel computes it: per kv head h, query
    rows r = c * G + g (head h * G + g at position pos_start + c) in tiles of
    PREFILL_TILE_ROWS; a tile's visible chunks dealt to PREFILL_KEY_GROUPS
    warps in turn (warp w takes chunks c_begin + w, c_begin + w +
    PREFILL_KEY_GROUPS, ...),
    each an online softmax, merged in order; out = O / max(L, 1e-30).
    Arguments as :func:`paged_prefill_ref`."""
    nb, chunk, hq, d = q.shape
    hkv, ps, mp = k_pages.shape[2], k_pages.shape[1], page_table.shape[1]
    group = hq // hkv
    rows_total = group * chunk
    out = torch.empty((nb, chunk, hq, d))
    for b in range(nb):
        pos0 = int(pos_start[b])
        for h in range(hkv):
            rows_q = q[b, :, h * group:(h + 1) * group].float().reshape(rows_total, d)
            res = torch.empty((rows_total, d))
            for r0 in range(0, rows_total, PREFILL_TILE_ROWS):
                r1 = min(r0 + PREFILL_TILE_ROWS, rows_total)
                qpos = pos0 + torch.arange(r0, r1) // group
                key_lo, key_hi, c_begin, c_end = _visible_chunks(
                    pos0 + r0 // group, pos0 + (r1 - 1) // group, mp * ps - 1, sliding_window)
                qlim = qpos.clamp_max(key_hi)
                qwin = qpos - sliding_window if sliding_window else torch.full_like(qpos, -1)

                def chunk_kv(c):
                    return _chunk_kv(k_pages, v_pages, page_table[b], h, c, key_lo, key_hi)

                warps = [walk_chunks(rows_q[r0:r1], qlim, qwin, chunk_kv,
                                     range(c_begin + w, c_end, PREFILL_KEY_GROUPS), d**-0.5, softcap)
                         for w in range(PREFILL_KEY_GROUPS)]
                _, big_l, big_o = merge_partials(warps)
                res[r0:r1] = big_o / big_l.clamp_min(1e-30)[:, None]
            out[b, :, h * group:(h + 1) * group] = res.reshape(chunk, group, d)
    return out.to(q.dtype)


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


def sample_keys(x: torch.Tensor) -> torch.Tensor:
    """The sampler's order-preserving keys of f32 values, as int64 in [0,
    2**32): larger value, larger key; +0.0 and -0.0 one key."""
    u = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    return torch.where(x == 0, torch.full_like(key, 0x80000000), key)


def key_value(key: int) -> torch.Tensor:
    """The f32 value (a 0-d tensor) of a key of :func:`sample_keys`."""
    u = key & 0x7FFFFFFF if key & 0x80000000 else key ^ 0xFFFFFFFF
    return torch.tensor(u - (1 << 32) if u >= 1 << 31 else u, dtype=torch.int32).view(torch.float32)


def sample_radix_select(keys: torch.Tensor, k: int, early: bool) -> int:
    """The kernel's radix select, 8 bits a pass from the top: the k-th
    largest of ``keys`` (1 <= k <= len), or, with ``early``, the floor of the
    first bin that holds it and at most SAMPLE_SLACK keys beyond the k
    largest."""
    prefix, mask, remaining = 0, 0, k
    for shift in (24, 16, 8, 0):
        live = keys[(keys & mask) == prefix]
        hist = torch.bincount((live >> shift) & 255, minlength=256)
        at_or_above = hist.flip(0).cumsum(0).flip(0)
        b = int((at_or_above >= remaining).nonzero().max())
        prefix |= b << shift
        remaining -= int(at_or_above[b] - hist[b])
        mask |= 255 << shift
        if early and int(hist[b]) - remaining <= SAMPLE_SLACK:
            break
    return prefix


def _best(values: torch.Tensor, index: torch.Tensor):
    """(value, index) that the kernels' reductions keep: the largest value,
    its lowest index; NaN never wins; (-inf, 2**31 - 1) when nothing does."""
    ok = ~torch.isnan(values)
    if not bool(ok.any()):
        return float("-inf"), 2**31 - 1
    top = values[ok].max()
    return float(top), int(index[ok & (values == top)].min())


def _merge_best(parts):
    best_v, best_i = float("-inf"), 2**31 - 1
    for v, i in parts:
        if v > best_v or (v == best_v and i < best_i):
            best_v, best_i = v, i
    return best_i


def fused_sample_split_ref(logits, noise, temperature, top_k, splits: int):
    """The sampler as the kernel computes it, in ``splits`` slices a row
    (``sample_slices``). Greedy row: each slice's (max, first index), merged.
    Keep-all row (top_k <= 0 or >= V): the same of x / t + noise. Top-k
    row: each slice's radix select with the early stop (all its values when
    it holds at most k), the values at or above its threshold as
    candidates with their scores x / t + noise; then the exact k-th largest
    among the candidates (the kernel's select starts below the bits they
    all share and ranks the last 32 keys in a warp: the same key) and the
    (max, first index) of the scores of the candidates not below it; where
    that is not above -inf, or the k-th largest is NaN, the whole row as
    :func:`fused_sample_ref`. Arguments as :func:`fused_sample_ref`."""
    nb, v = logits.shape
    device = logits.device
    slice_len, nsplit = sample_slices(v, splits)
    logits, noise = logits.float().cpu(), noise.float().cpu()
    out = torch.empty((nb,), dtype=torch.int32)
    for r in range(nb):
        x, g = logits[r], noise[r]
        t = temperature[r].float().cpu()
        tt = t.clamp_min(1e-6)
        k = int(top_k[r])
        bounds = [(s * slice_len, min(v, (s + 1) * slice_len)) for s in range(nsplit)]
        if not bool(t > 0) or k <= 0 or k >= v:
            scores = x if not bool(t > 0) else x / tt + g
            out[r] = _merge_best(_best(scores[lo:hi], torch.arange(lo, hi)) for lo, hi in bounds)
            continue
        cand = []
        for lo, hi in bounds:
            keys = sample_keys(x[lo:hi])
            threshold = 0 if k >= hi - lo else sample_radix_select(keys, k, early=True)
            cand.append(lo + (keys >= threshold).nonzero().flatten())
        cand = torch.cat(cand)
        kth = key_value(sample_radix_select(sample_keys(x[cand]), k, early=False))
        best_v, best_i = float("-inf"), 2**31 - 1
        if not bool(torch.isnan(kth)):
            kept = cand[~(x[cand] < kth)]
            best_v, best_i = _best(x[kept] / tt + g[kept], kept)
        if not best_v > float("-inf"):
            scores = torch.where(x < kth, float("-inf"), x) / tt + g
            best_v, best_i = _best(scores, torch.arange(v))
        out[r] = best_i
    return out.to(device)
