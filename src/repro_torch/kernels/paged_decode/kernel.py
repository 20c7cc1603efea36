"""Bind and launch the hand-written CUDA kernels of the paged-decode family
(sources in ``csrc/``), built and loaded by :mod:`repro_torch.kernels._cuda`.

The launchers take CUDA tensors only and check device, type, shape,
contiguity and 16-byte alignment; they allocate the output (and the bf16
decode's split scratch; the sampler keeps its scratch and counters per
stream) and never fall back to the plain versions. ``ops`` adds the launch
counters and the CPU path. bf16 queries run the tensor-core kernels, f32
queries the CUDA-core ones.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels._cuda import F as _F, I as _I, P as _P
from repro_torch.kernels._cuda import check as _check, check_cuda as _check_cuda
from repro_torch.kernels._cuda import launch as _launch, query as _query, register

CSRC = Path(__file__).resolve().parent / "csrc"
_Q_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # pages are bf16
RING_STAGES = 4  # f32 route: pages of K and V staged in shared memory (kStages in paged_attention.cu)
SHARED_MEMORY_BYTES = 227 * 1024  # what one block may use on sm_90
#: head_dims each route takes: the f32 CUDA-core kernels give a lane D / 32
#: columns of a row; the bf16 tensor-core kernels step 16 columns, which also
#: takes zamba2's 80
HEAD_DIMS = {torch.float32: (64, 128, 256), torch.bfloat16: (64, 80, 128, 256)}
register("paged_attention", CSRC / "paged_attention.cu", {
    "paged_flash_decode": [_P] * 7 + [_I] * 9 + [_F],
    "paged_chunk_prefill": [_P] * 6 + [_I] * 10 + [_F],
}, queries={"paged_decode_scratch_floats": ([_I] * 5, ctypes.c_longlong)})
register("fused_sample", CSRC / "fused_sample.cu", {"fused_sample": [_P] * 7 + [_I] * 2}, queries={
    "fused_sample_splits": ([_I] * 2, ctypes.c_int),
    "fused_sample_scratch_bytes": ([_I] * 2, ctypes.c_longlong),
})

# The bf16 kernels' tiling (paged_attention.cu, namespace tc), stated for the
# plain versions that follow those kernels step for step (ref.py) and for the
# tests; the launchers take the decode's layout from the library itself.
# Keys a chunk; decode: the warps that deal a split's chunks among them, and
# splits a slot at most; prefill: query rows a block, and its warps.
CHUNK_KEYS = 16
DECODE_KEY_GROUPS = 2
MAX_DECODE_SPLITS = 256
PREFILL_TILE_ROWS = 32
PREFILL_KEY_GROUPS = 4
# The sampler's layout (fused_sample.cu), stated for its step-for-step plain
# version: each row cut into slices of at most SAMPLE_MAX_SLICE values (a
# multiple of 4), enough that batch x splits reaches SAMPLE_TARGET_BLOCKS
# where slices of at least SAMPLE_MIN_SLICE values allow it; a top-k slice
# stops its select once the bin holding its k-th largest adds at most
# SAMPLE_SLACK values beyond k.
SAMPLE_MAX_SLICE = 4096
SAMPLE_MIN_SLICE = 1024
SAMPLE_TARGET_BLOCKS = 264
SAMPLE_SLACK = 16


def _attention_checks(q, k_pages, v_pages, page_table, pos, *, head_axis: int):
    device = q.device
    _check_cuda(device, q=q, k_pages=k_pages, v_pages=v_pages, page_table=page_table, pos=pos)
    _check(q.dtype in _Q_DTYPE_CODES, lambda: f"q must be float32 or bfloat16, got {q.dtype}")
    _check(k_pages.dtype == v_pages.dtype == torch.bfloat16,
           lambda: f"k/v pages must be bfloat16, got {k_pages.dtype}/{v_pages.dtype}")
    _check(page_table.dtype == torch.int32 and pos.dtype == torch.int32,
           "page_table and positions must be int32")
    _check(k_pages.ndim == 4 and v_pages.shape == k_pages.shape, "pages must be (P, ps, Hkv, D)")
    hq, d = q.shape[head_axis], q.shape[-1]
    hkv = k_pages.shape[2]
    _check(k_pages.shape[3] == d, lambda: f"pages of head_dim {k_pages.shape[3]} do not fit q's {d}")
    _check(d in HEAD_DIMS[q.dtype],
           lambda: f"head_dim {d} is outside the {q.dtype} paged kernels: they take {HEAD_DIMS[q.dtype]}")
    _check(hq % hkv == 0, lambda: f"q heads {hq} % kv heads {hkv} != 0")
    ps = k_pages.shape[1]
    if q.dtype == torch.float32:  # the bf16 route stages 16-key chunks, whatever the page size
        ring = 2 * RING_STAGES * ps * d * k_pages.element_size() + 4 * 16 * (ps + d)  # + scores, queries
        _check(ring <= SHARED_MEMORY_BYTES,
               lambda: f"a ring of {RING_STAGES} pages of {ps} x {d} {k_pages.dtype} needs {ring} bytes "
                       f"of shared memory, more than a block has: use a smaller page size")
    else:  # 16-byte vector loads of q, K and V
        _check(all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)),
               "q and the k/v pages must start on a 16-byte boundary")
    b = q.shape[0]
    _check(page_table.ndim == 2 and page_table.shape[0] == b and pos.shape == (b,),
           "page_table must be (B, MP) and positions (B,)")
    return hq, hkv, d


def _window_softcap(window: Optional[int], softcap: Optional[float]):
    _check(window is None or window >= 1, lambda: f"sliding window must be >= 1, got {window}")
    _check(softcap is None or softcap > 0, lambda: f"softcap must be > 0, got {softcap}")
    return (0 if window is None else int(window)), (0.0 if softcap is None else float(softcap))


def decode_layout(max_pages: int, page_size: int) -> Tuple[int, int]:
    """(chunks a split, splits a slot) of the bf16 decode, from the table
    width alone (tc::decode_layout): the fewest chunks a split, a multiple of
    DECODE_KEY_GROUPS, that keep the splits within MAX_DECODE_SPLITS."""
    chunks = -(-max_pages * page_size // CHUNK_KEYS)
    per = max(1, -(-chunks // DECODE_KEY_GROUPS // MAX_DECODE_SPLITS))
    split_chunks = per * DECODE_KEY_GROUPS
    return split_chunks, max(1, -(-chunks // split_chunks))


@functools.lru_cache(maxsize=256)
def decode_scratch_floats(batch: int, hq: int, d: int, max_pages: int, page_size: int) -> int:
    """Floats of the bf16 decode's split scratch, as the library lays it out."""
    return _query("paged_attention", "paged_decode_scratch_floats", batch, hq, d, max_pages, page_size)


def paged_flash_decode(q, k_pages, v_pages, page_table, positions, *, window=None, softcap=None):
    """q: (B, Hq, D); pages: (P, ps, Hkv, D) bf16; page_table: (B, MP) int32;
    positions: (B,) int32. Returns (B, Hq, D) in q's type."""
    _check(q.ndim == 3, lambda: f"q must be (B, Hq, D), got {tuple(q.shape)}")
    hq, hkv, d = _attention_checks(q, k_pages, v_pages, page_table, positions, head_axis=1)
    w, cap = _window_softcap(window, softcap)
    b, mp = q.shape[0], page_table.shape[1]
    out = torch.empty_like(q)
    scratch = None
    if q.dtype == torch.bfloat16:  # each split's (o, m, l) per query row, f32
        floats = decode_scratch_floats(b, hq, d, mp, k_pages.shape[1])
        scratch = torch.empty(floats, dtype=torch.float32, device=q.device)
    _launch(
        "paged_attention", "paged_flash_decode", q.device,
        q.data_ptr(), out.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), positions.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
        b, hq, hkv, d, k_pages.shape[0], k_pages.shape[1], mp, _Q_DTYPE_CODES[q.dtype], w, cap,
    )
    return out


def paged_chunk_prefill(q, k_pages, v_pages, page_table, pos_start, *, window=None, softcap=None):
    """q: (B, C, Hq, D); pos_start: (B,) int32, the position of each chunk's
    first query; the rest as :func:`paged_flash_decode`. Returns (B, C, Hq, D)."""
    _check(q.ndim == 4, lambda: f"q must be (B, C, Hq, D), got {tuple(q.shape)}")
    hq, hkv, d = _attention_checks(q, k_pages, v_pages, page_table, pos_start, head_axis=2)
    w, cap = _window_softcap(window, softcap)
    out = torch.empty_like(q)
    _launch(
        "paged_attention", "paged_chunk_prefill", q.device,
        q.data_ptr(), out.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), pos_start.data_ptr(),
        q.shape[0], q.shape[1], hq, hkv, d, k_pages.shape[0], k_pages.shape[1],
        page_table.shape[1], _Q_DTYPE_CODES[q.dtype], w, cap,
    )
    return out


def sample_slices(vocab: int, splits: int) -> Tuple[int, int]:
    """(slice length, splits) of a row of ``vocab`` values cut into about
    ``splits`` slices whose length is a multiple of 4: the last may be
    shorter, none is empty. Asking again with the splits it gives returns
    the same layout."""
    per = -(-vocab // max(1, splits))
    slice_len = -(-per // 4) * 4
    return slice_len, -(-vocab // slice_len)


def sample_layout(batch: int, vocab: int) -> Tuple[int, int]:
    """(slice length, splits a row) of the sampler for (batch, vocab), as
    the library cuts it (fused_sample.cu, layout)."""
    want = -(-SAMPLE_TARGET_BLOCKS // batch)
    splits = max(min(want, max(1, vocab // SAMPLE_MIN_SLICE)), -(-vocab // SAMPLE_MAX_SLICE))
    return sample_slices(vocab, splits)


@functools.lru_cache(maxsize=256)
def sample_splits(batch: int, vocab: int) -> int:
    """Splits a row of the library's sampler for (batch, vocab)."""
    return _query("fused_sample", "fused_sample_splits", batch, vocab)


@functools.lru_cache(maxsize=256)
def sample_scratch_bytes(batch: int, vocab: int) -> int:
    """Bytes of the sampler's scratch (partials and candidates), as the
    library lays it out."""
    return _query("fused_sample", "fused_sample_scratch_bytes", batch, vocab)


#: (device index, stream) -> (scratch, counters) of the sampler: a 64-bit
#: counter a row, 0 between calls (each call's merging blocks reset theirs);
#: two calls that may run at once (other streams) never share them
_SAMPLE_BUFFERS: dict = {}


def _sample_buffers(device: torch.device, batch: int, vocab: int):
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    scratch, counters = _SAMPLE_BUFFERS.get(key, (None, None))
    need = sample_scratch_bytes(batch, vocab)
    if scratch is None or scratch.numel() < need:
        scratch = torch.empty(need, dtype=torch.uint8, device=device)
    if counters is None or counters.numel() < batch:
        counters = torch.zeros(batch, dtype=torch.int64, device=device)
    _SAMPLE_BUFFERS[key] = (scratch, counters)
    return scratch, counters


def fused_sample(logits, noise, temperature, top_k):
    """logits, noise: (B, V) f32; temperature: (B,) f32; top_k: (B,) int32.
    Returns (B,) int32 tokens. Rows that are 16-byte aligned with V % 4 == 0
    take 16-byte loads, others one value at a time."""
    _check_cuda(logits.device, logits=logits, noise=noise, temperature=temperature, top_k=top_k)
    _check(logits.dtype == noise.dtype == temperature.dtype == torch.float32,
           "logits, noise and temperature must be float32")
    _check(top_k.dtype == torch.int32, "top_k must be int32")
    _check(logits.ndim == 2 and logits.shape[0] >= 1 and logits.shape[1] >= 1,
           lambda: f"logits must be (B, V) with B, V >= 1, got {tuple(logits.shape)}")
    b, v = logits.shape
    _check(noise.shape == (b, v) and temperature.shape == (b,) and top_k.shape == (b,),
           "noise must be (B, V), temperature and top_k (B,)")
    out = torch.empty((b,), dtype=torch.int32, device=logits.device)
    scratch, counters = _sample_buffers(logits.device, b, v)
    _launch(
        "fused_sample", "fused_sample", logits.device, logits.data_ptr(), noise.data_ptr(),
        temperature.data_ptr(), top_k.data_ptr(), out.data_ptr(), scratch.data_ptr(), counters.data_ptr(), b, v,
    )
    return out
