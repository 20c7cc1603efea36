"""Gated linear attention recurrence, the shared math behind Mamba2 (SSD)
and RWKV6 (Finch).

State: ``S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t`` with per-(head, k-channel)
decay ``w_t = exp(log_w_t) ∈ (0, 1]``; readout either

- ``y_t = q_t · S_t``              (Mamba2: current token included), or
- ``y_t = q_t · (S_{t-1} + diag(u) k_t ⊗ v_t)``  (RWKV6: ``u`` bonus).

The full sequence (training, chunked prefill) goes through
kernels/gla: the chunked CUDA kernels (forward and backward) for a CUDA
tensor, the plain recurrence for a CPU tensor. The JAX package runs an
exact ``lax.scan`` here, checkpointed per 64-step chunk, and leaves its
Pallas kernel unused; the tests show that the results agree. A single
decode step stays plain PyTorch, as in the JAX package, which has no kernel
for it.

Shapes: q, k, log_w: (B, S, H, K); v: (B, S, H, V); state: (B, H, K, V).
Under tensor parallelism H is a rank's heads (rwkv6's H/M, Mamba2's H/M
with q and k broadcast from its B and C); the operands may be views of a
packed projection or broadcasts, and ``gla_ops`` hands the kernels
contiguous, 16-byte-aligned copies of them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.gla import ops as gla_ops


def gla_scan(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    log_w: torch.Tensor,
    *,
    bonus_u: Optional[torch.Tensor] = None,
    include_current: bool = True,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (B, S, H, V) in v's type, final_state: (B, H, K, V) f32),
    differentiable in every input."""
    return gla_ops.gla_chunked(q, k, v, log_w.float(), bonus_u=bonus_u,
                               include_current=include_current, initial_state=initial_state)


def gla_step(
    state: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    log_w: torch.Tensor,
    *,
    bonus_u: Optional[torch.Tensor] = None,
    include_current: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. q, k, log_w: (B, H, K); v: (B, H, V); state
    (B, H, K, V). Returns (y: (B, H, V), new_state f32)."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    wt = torch.exp(log_w.float())[..., None]
    outer = k32[..., :, None] * v32[..., None, :]
    new_state = state.float() * wt + outer
    if include_current:
        readout = new_state
    elif bonus_u is not None:
        readout = state.float() + bonus_u.float()[None, :, :, None] * outer
    else:
        readout = state.float()
    y = torch.einsum("bhk,bhkv->bhv", q32, readout).to(v.dtype)
    return y, new_state
