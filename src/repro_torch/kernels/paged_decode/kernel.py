"""Bind and launch the hand-written CUDA kernels of the paged-decode family
(sources in ``csrc/``), built and loaded by :mod:`repro_torch.kernels._cuda`.

The launchers take CUDA tensors only and check device, type, shape and
contiguity; they allocate the output and never fall back to the plain
versions. ``ops`` adds the launch counters and the CPU path.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels._cuda import F as _F, I as _I, P as _P
from repro_torch.kernels._cuda import check as _check, check_cuda as _check_cuda
from repro_torch.kernels._cuda import launch as _launch, register

CSRC = Path(__file__).resolve().parent / "csrc"
_Q_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # pages are bf16
RING_STAGES = 4  # pages of K and V staged in shared memory (kStages in paged_attention.cu)
SHARED_MEMORY_BYTES = 227 * 1024  # what one block may use on sm_90
register("paged_attention", CSRC / "paged_attention.cu", {
    "paged_flash_decode": [_P] * 6 + [_I] * 9 + [_F],
    "paged_chunk_prefill": [_P] * 6 + [_I] * 10 + [_F],
})
register("fused_sample", CSRC / "fused_sample.cu", {"fused_sample": [_P] * 5 + [_I] * 2})


def _attention_checks(q, k_pages, v_pages, page_table, pos, *, head_axis: int):
    device = q.device
    _check_cuda(device, q=q, k_pages=k_pages, v_pages=v_pages, page_table=page_table, pos=pos)
    _check(q.dtype in _Q_DTYPE_CODES, f"q must be float32 or bfloat16, got {q.dtype}")
    _check(k_pages.dtype == v_pages.dtype == torch.bfloat16,
           f"k/v pages must be bfloat16, got {k_pages.dtype}/{v_pages.dtype}")
    _check(page_table.dtype == torch.int32 and pos.dtype == torch.int32,
           "page_table and positions must be int32")
    _check(k_pages.ndim == 4 and v_pages.shape == k_pages.shape, "pages must be (P, ps, Hkv, D)")
    hq, d = q.shape[head_axis], q.shape[-1]
    hkv = k_pages.shape[2]
    _check(k_pages.shape[3] == d and d in (64, 128, 256), f"head_dim {d} must be 64, 128 or 256")
    _check(hq % hkv == 0, f"q heads {hq} % kv heads {hkv} != 0")
    ps = k_pages.shape[1]
    ring = 2 * RING_STAGES * ps * d * k_pages.element_size() + 4 * 16 * (ps + d)  # + scores, queries
    _check(ring <= SHARED_MEMORY_BYTES,
           f"a ring of {RING_STAGES} pages of {ps} x {d} {k_pages.dtype} needs {ring} bytes "
           f"of shared memory, more than a block has: use a smaller page size")
    b = q.shape[0]
    _check(page_table.ndim == 2 and page_table.shape[0] == b and pos.shape == (b,),
           "page_table must be (B, MP) and positions (B,)")
    return hq, hkv, d


def _window_softcap(window: Optional[int], softcap: Optional[float]):
    _check(window is None or window >= 1, f"sliding window must be >= 1, got {window}")
    _check(softcap is None or softcap > 0, f"softcap must be > 0, got {softcap}")
    return (0 if window is None else int(window)), (0.0 if softcap is None else float(softcap))


def paged_flash_decode(q, k_pages, v_pages, page_table, positions, *, window=None, softcap=None):
    """q: (B, Hq, D); pages: (P, ps, Hkv, D) bf16; page_table: (B, MP) int32;
    positions: (B,) int32. Returns (B, Hq, D) in q's type."""
    _check(q.ndim == 3, f"q must be (B, Hq, D), got {tuple(q.shape)}")
    hq, hkv, d = _attention_checks(q, k_pages, v_pages, page_table, positions, head_axis=1)
    w, cap = _window_softcap(window, softcap)
    out = torch.empty_like(q)
    _launch(
        "paged_attention", "paged_flash_decode", q.device,
        q.data_ptr(), out.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), positions.data_ptr(),
        q.shape[0], hq, hkv, d, k_pages.shape[0], k_pages.shape[1], page_table.shape[1],
        _Q_DTYPE_CODES[q.dtype], w, cap,
    )
    return out


def paged_chunk_prefill(q, k_pages, v_pages, page_table, pos_start, *, window=None, softcap=None):
    """q: (B, C, Hq, D); pos_start: (B,) int32, the position of each chunk's
    first query; the rest as :func:`paged_flash_decode`. Returns (B, C, Hq, D)."""
    _check(q.ndim == 4, f"q must be (B, C, Hq, D), got {tuple(q.shape)}")
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


def fused_sample(logits, noise, temperature, top_k):
    """logits, noise: (B, V) f32; temperature: (B,) f32; top_k: (B,) int32.
    Returns (B,) int32 tokens."""
    _check_cuda(logits.device, logits=logits, noise=noise, temperature=temperature, top_k=top_k)
    _check(logits.dtype == noise.dtype == temperature.dtype == torch.float32,
           "logits, noise and temperature must be float32")
    _check(top_k.dtype == torch.int32, "top_k must be int32")
    b, v = logits.shape
    _check(noise.shape == (b, v) and temperature.shape == (b,) and top_k.shape == (b,),
           "noise must be (B, V), temperature and top_k (B,)")
    out = torch.empty((b,), dtype=torch.int32, device=logits.device)
    _launch(
        "fused_sample", "fused_sample", logits.device, logits.data_ptr(), noise.data_ptr(),
        temperature.data_ptr(), top_k.data_ptr(), out.data_ptr(), b, v,
    )
    return out
