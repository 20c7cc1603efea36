"""Plain PyTorch versions of flash attention, forward and backward: dense
GQA softmax attention in f32, layout (B, S, H, D), causal and
sliding-window masks with right-aligned queries (query ``i`` sits at
position ``i + Sk - Sq``).

The forward is the JAX package's ``attention_ref`` plus the row
log-sum-exp, which the backward needs. A row with no visible key (causal
with ``Sq > Sk``) gets an output of zeros and a log-sum-exp of -inf, as the
kernels give it (the TPU kernel's ``max(l, 1e-30)`` guard); the JAX
``attention_ref`` would average every value there instead. The backward
recomputes the probabilities from the saved log-sum-exp; dK and dV sum over
each KV head's group of query heads.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _mask(sq: int, sk: int, causal: bool, sliding_window: Optional[int], device) -> torch.Tensor:
    """(Sq, Sk) bool, True = attend."""
    q_pos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if sliding_window is not None:
        mask &= k_pos > q_pos - sliding_window
    return mask


def _grouped(q, k):
    """q (B, Sq, Hq, D) -> (B, Hkv, G, Sq, D) f32; k (B, Sk, Hkv, D) -> (B, Hkv, Sk, D) f32."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, sq, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)
    return qg, k.float().permute(0, 2, 1, 3)


def _probs(q, k, lse, causal, sliding_window):
    """Recomputed probabilities (B, Hkv, G, Sq, Sk) f32 and the mask."""
    b, sq, hq, d = q.shape
    qg, kg = _grouped(q, k)
    mask = _mask(sq, k.shape[1], causal, sliding_window, q.device)
    logits = torch.einsum("bngsh,bnth->bngst", qg, kg) * d**-0.5
    lse_g = lse.reshape(b, k.shape[2], hq // k.shape[2], sq, 1)
    p = torch.exp(logits - lse_g)
    return torch.where(mask, p, 0.0), mask


def attention_fwd_ref(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, Sq, Hq, D) in q's type, lse (B, Hq, Sq) f32)."""
    b, sq, hq, d = q.shape
    qg, kg = _grouped(q, k)
    mask = _mask(sq, k.shape[1], causal, sliding_window, q.device)
    logits = torch.einsum("bngsh,bnth->bngst", qg, kg) * d**-0.5
    logits = torch.where(mask, logits, -torch.inf)
    lse = torch.logsumexp(logits, dim=-1)  # -inf where no key is visible
    p = torch.where(mask, torch.exp(logits - lse[..., None]), 0.0)
    out = torch.einsum("bngst,bnth->bsngh", p, v.float().permute(0, 2, 1, 3))
    return out.reshape(b, sq, hq, d).to(q.dtype), lse.reshape(b, hq, sq)


def attention_ref(q, k, v, *, causal: bool = True, sliding_window: Optional[int] = None):
    """The forward's output alone (the JAX package's ``attention_ref``)."""
    return attention_fwd_ref(q, k, v, causal=causal, sliding_window=sliding_window)[0]


def attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,   # the forward's output
    lse: torch.Tensor,   # (B, Hq, Sq) f32, the forward's log-sum-exp
    d_out: torch.Tensor,  # (B, Sq, Hq, D)
    *,
    causal: bool = True,
    sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (dq, dk, dv), each in its input's type and shape. (With
    ``out`` zero, ``Di`` is zero: the backward with that term left out.)"""
    b, sq, hq, d = q.shape
    p, _ = _probs(q, k, lse, causal, sliding_window)  # (B, Hkv, G, Sq, Sk)
    qg, kg = _grouped(q, k)
    vg = v.float().permute(0, 2, 1, 3)                 # (B, Hkv, Sk, D)
    dog, og = _grouped(d_out, k)[0], _grouped(out, k)[0]  # (B, Hkv, G, Sq, D)
    delta = (dog * og).sum(-1, keepdim=True)            # rowsum(dO * O)
    dv = torch.einsum("bngst,bngsh->bnth", p, dog)
    dp = torch.einsum("bngsh,bnth->bngst", dog, vg)
    ds = p * (dp - delta)
    scale = d**-0.5
    dq = torch.einsum("bngst,bnth->bngsh", ds, kg) * scale
    dk = torch.einsum("bngst,bngsh->bnth", ds, qg) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
    dk = dk.permute(0, 2, 1, 3).to(k.dtype)
    dv = dv.permute(0, 2, 1, 3).to(v.dtype)
    return dq.contiguous(), dk.contiguous(), dv.contiguous()

