"""Public wrappers for the paged-decode kernel family: flat-head layouts in,
int32 table/position casts here, then the CUDA kernel (``kernel``) for a
CUDA tensor or the plain version (``ref``) for a CPU tensor.

The CPU path exists for the tests, and is taken only because the tensor
lies on the CPU: a CUDA tensor launches its kernel or raises, with no
fallback. Each wrapper adds one to its entry of :data:`LAUNCHES` where it
launches its kernel, and nowhere else, so a run can show that its main
path went through the kernels.

The sampler takes its gumbel noise as an input: the caller draws it from
its ``torch.Generator``, so the kernel and the plain version see the same
noise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_decode import kernel, ref

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"paged_flash_decode": 0, "paged_chunk_prefill": 0, "fused_sample": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"paged-decode kernels run on cuda (or their plain versions on cpu), not {t.device}")


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def paged_flash_decode(
    q: torch.Tensor,           # (B, Hq, D): one query token per slot
    k_pages: torch.Tensor,     # (P, ps, Hkv, D)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages)
    positions: torch.Tensor,   # (B,): per-slot decode write position
    *,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    if not _on_cuda(q):
        return ref.paged_attention_ref(
            q, k_pages, v_pages, page_table, positions,
            sliding_window=sliding_window, softcap=softcap,
        )
    out = kernel.paged_flash_decode(
        q.contiguous(), k_pages, v_pages, _i32(page_table), _i32(positions),
        window=sliding_window, softcap=softcap,
    )
    LAUNCHES["paged_flash_decode"] += 1
    return out


def paged_chunk_prefill(
    q: torch.Tensor,           # (B, C, Hq, D): a contiguous chunk of queries
    k_pages: torch.Tensor,     # (P, ps, Hkv, D)
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages)
    pos_start: torch.Tensor,   # (B,): position of each chunk's first query
    *,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    if not _on_cuda(q):
        return ref.paged_prefill_ref(
            q, k_pages, v_pages, page_table, pos_start,
            sliding_window=sliding_window, softcap=softcap,
        )
    out = kernel.paged_chunk_prefill(
        q.contiguous(), k_pages, v_pages, _i32(page_table), _i32(pos_start),
        window=sliding_window, softcap=softcap,
    )
    LAUNCHES["paged_chunk_prefill"] += 1
    return out


def fused_sample(
    logits: torch.Tensor,       # (B, V)
    noise: torch.Tensor,        # (B, V) gumbel noise
    temperature: torch.Tensor,  # (B,)
    top_k: torch.Tensor,        # (B,)
) -> torch.Tensor:
    logits = logits.float().contiguous()
    noise = noise.float().contiguous()
    temperature = temperature.float().contiguous()
    if not _on_cuda(logits):
        return ref.fused_sample_ref(logits, noise, temperature, top_k)
    out = kernel.fused_sample(logits, noise, temperature, _i32(top_k))
    LAUNCHES["fused_sample"] += 1
    return out
