"""Public wrapper for flash attention: (B, S, H, D) layout in, GQA-aware,
differentiable. For CUDA tensors the forward and the backward are the CUDA
kernels (``kernel``); for CPU tensors they are the plain versions (``ref``);
for meta tensors (the dry run) they allocate the kernels' outputs and
scratch and compute nothing. Each call reports :func:`cost` to the active
counters (``kernels/accounting.py``).

The CPU path exists for the tests, and is taken only because the tensors
lie on the CPU: a CUDA tensor launches its kernel or raises, with no
fallback. :data:`LAUNCHES` counts, per kernel, the launches since the last
:func:`reset_launches`; a count is raised where the kernel is launched and
nowhere else, so a run can show that its main path went through the
kernels. :data:`LAUNCHES_NONCAUSAL` counts, of those, the launches made
without the causal mask, so that a model with both kinds (an encoder's
self-attention and a decoder's) shows which ran which.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.accounting import kernel_region
from repro_torch.kernels.flash_attention import kernel, ref

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}
#: of :data:`LAUNCHES`, the launches made with ``causal=False``
LAUNCHES_NONCAUSAL = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_NONCAUSAL):
        for name in counts:
            counts[name] = 0


def _count(name: str, causal: bool) -> None:
    LAUNCHES[name] += 1
    if not causal:
        LAUNCHES_NONCAUSAL[name] += 1


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cuda", "cpu", "meta"):
        return t.device.type
    raise ValueError(f"flash attention runs on cuda (or its plain version on cpu, its count on meta), "
                     f"not {t.device}")


def visible_pairs(sq: int, sk: int, causal: bool = True, sliding_window: Optional[int] = None) -> int:
    """(query, key) pairs the masks leave visible, queries right-aligned
    (query ``i`` at position ``i + sk - sq``): what the kernels compute."""
    pos = np.arange(sk - sq, sk, dtype=np.int64)
    hi = np.minimum(pos + 1, sk) if causal else np.full_like(pos, sk)
    lo = np.maximum(pos - sliding_window + 1, 0) if sliding_window is not None else np.zeros_like(pos)
    return int(np.maximum(hi - lo, 0).sum())


def cost(q, k, v, *, causal: bool = True, sliding_window: Optional[int] = None,
         backward: bool = False) -> Tuple[float, float]:
    """(operations, bytes) of one call, from the shapes alone: 4 D flops a
    visible (query, key) pair and query head forward (the two products), 8
    backward (dV, dP, dQ, dK); the forward reads q, k and v and writes out
    and the f32 log-sum-exp; the backward reads q, k, v, out, dO and the
    log-sum-exp and writes dq, dk and dv. The bounds of ``chip_smoke.py``'s
    kernel table are these counts over the card's rates."""
    b, sq, hq, d = q.shape
    pairs = visible_pairs(sq, k.shape[1], causal, sliding_window)
    qkv = (q.numel() + k.numel() + v.numel()) * q.element_size()
    lse = 4 * b * hq * sq
    if backward:
        return float(8 * d * pairs * b * hq), float(2 * qkv + 2 * q.numel() * q.element_size() + lse)
    return float(4 * d * pairs * b * hq), float(qkv + q.numel() * q.element_size() + lse)


def forward(q, k, v, *, causal: bool = True, sliding_window: Optional[int] = None):
    """(out, lse): the kernel for CUDA tensors, the plain version for CPU
    ones, empty tensors of their shapes for meta ones."""
    route = _route(q)
    with kernel_region("flash_attention_fwd", *cost(q, k, v, causal=causal, sliding_window=sliding_window),
                       (q, k, v)):
        if route == "cpu":
            return ref.attention_fwd_ref(q, k, v, causal=causal, sliding_window=sliding_window)
        if route == "meta":
            return torch.empty_like(q), q.new_empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32)
        out = kernel.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                         causal=causal, window=sliding_window)
    _count("flash_attention_fwd", causal)
    return out


def backward(q, k, v, out, lse, d_out, *, causal: bool = True, sliding_window: Optional[int] = None):
    """(dq, dk, dv): the kernels for CUDA tensors, the plain version for CPU
    ones, the kernels' scratch and empty gradients for meta ones."""
    route = _route(q)
    with kernel_region("flash_attention_bwd", *cost(q, k, v, causal=causal, sliding_window=sliding_window,
                                                    backward=True), (q, k, v, out, lse, d_out)):
        if route == "cpu":
            return ref.attention_bwd_ref(q, k, v, out, lse, d_out, causal=causal,
                                         sliding_window=sliding_window)
        if route == "meta":
            b, sq, hq, d = q.shape
            scratch = q.new_empty(kernel.bwd_workspace_floats(b, sq, k.shape[1], hq, d, q.dtype),
                                  dtype=torch.float32)
            grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            del scratch
            return grads
        grads = kernel.flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), out, lse,
                                           d_out.contiguous(), causal=causal, window=sliding_window)
    _count("flash_attention_bwd", causal)
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
