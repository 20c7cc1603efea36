"""Public wrapper for flash attention: (B, S, H, D) layout in, GQA-aware,
differentiable. For CUDA tensors the forward and the backward are the CUDA
kernels (``kernel``); for CPU tensors they are the plain versions (``ref``).

The CPU path exists for the tests, and is taken only because the tensors
lie on the CPU: a CUDA tensor launches its kernel or raises, with no
fallback. :data:`LAUNCHES` counts, per kernel, the launches since the last
:func:`reset_launches`; a count is raised where the kernel is launched and
nowhere else, so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel, ref

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"flash attention runs on cuda (or its plain version on cpu), not {t.device}")


def forward(q, k, v, *, causal: bool = True, sliding_window: Optional[int] = None):
    """(out, lse): the kernel for CUDA tensors, the plain version for CPU ones."""
    if not _on_cuda(q):
        return ref.attention_fwd_ref(q, k, v, causal=causal, sliding_window=sliding_window)
    out = kernel.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                     causal=causal, window=sliding_window)
    LAUNCHES["flash_attention_fwd"] += 1
    return out


def backward(q, k, v, out, lse, d_out, *, causal: bool = True, sliding_window: Optional[int] = None):
    """(dq, dk, dv): the kernels for CUDA tensors, the plain version for CPU ones."""
    if not _on_cuda(q):
        return ref.attention_bwd_ref(q, k, v, out, lse, d_out, causal=causal,
                                     sliding_window=sliding_window)
    grads = kernel.flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), out, lse,
                                       d_out.contiguous(), causal=causal, window=sliding_window)
    LAUNCHES["flash_attention_bwd"] += 1
    return grads


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window):
        out, lse = forward(q, k, v, causal=causal, sliding_window=sliding_window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sliding_window = causal, sliding_window
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = backward(q, k, v, out, lse, d_out, causal=ctx.causal,
                              sliding_window=ctx.sliding_window)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Softmax attention with GQA, causal and sliding-window masks and
    right-aligned queries; differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, causal, sliding_window)
