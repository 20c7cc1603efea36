"""Plain PyTorch versions of chunked gated linear attention (GLA), forward
and backward, layout (B, S, H, ·).

The forward is the JAX package's ``gla_ref``: the exact per-step
recurrence, one step per position, so it takes any S::

    S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t,   w_t = exp(log_w_t)
    y_t = q_t · S_t                          (include_current=True; Mamba2)
    y_t = q_t · (S_{t-1} + diag(u) k_t ⊗ v_t)  (include_current=False; RWKV6)

with an f32 state and ``u`` the optional RWKV6 bonus. The backward is
autograd through that forward (``torch.func.vjp``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def gla_fwd_ref(
    q: torch.Tensor,       # (B, S, H, K)
    k: torch.Tensor,       # (B, S, H, K)
    v: torch.Tensor,       # (B, S, H, V)
    log_w: torch.Tensor,   # (B, S, H, K), <= 0
    *,
    bonus_u: Optional[torch.Tensor] = None,        # (H, K)
    include_current: bool = True,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, K, V)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, V) in v's dtype, final state (B, H, K, V) f32)."""
    b, s, h, kd = q.shape
    vd = v.shape[-1]
    if initial_state is None:
        state = torch.zeros((b, h, kd, vd), dtype=torch.float32, device=q.device)
    else:
        state = initial_state.float()
    q32, k32, v32 = q.float(), k.float(), v.float()
    w = torch.exp(log_w.float())
    ys = []
    for t in range(s):
        outer = k32[:, t, :, :, None] * v32[:, t, :, None, :]
        new_state = state * w[:, t, :, :, None] + outer
        if include_current:
            read = new_state
        elif bonus_u is not None:
            read = state + bonus_u.float()[None, :, :, None] * outer
        else:
            read = state
        ys.append(torch.einsum("bhk,bhkv->bhv", q32[:, t], read))
        state = new_state
    return torch.stack(ys, dim=1).to(v.dtype), state


def gla_bwd_ref(q, k, v, log_w, bonus_u, initial_state, d_y, d_final, *, include_current: bool):
    """Gradients of :func:`gla_fwd_ref` for the cotangents ``d_y`` (of y) and
    ``d_final`` (of the final state; None for zero). Returns (dq, dk, dv,
    dlog_w, du, ds0), each in its input's type; du and ds0 are None where
    ``bonus_u`` and ``initial_state`` are."""
    names = ("q", "k", "v", "log_w", "bonus_u", "initial_state")
    given = {n: t for n, t in zip(names, (q, k, v, log_w, bonus_u, initial_state)) if t is not None}

    def fwd(*tensors):
        args = dict(zip(given, tensors))
        return gla_fwd_ref(args["q"], args["k"], args["v"], args["log_w"],
                           bonus_u=args.get("bonus_u"), include_current=include_current,
                           initial_state=args.get("initial_state"))

    (y, final), vjp = torch.func.vjp(fwd, *given.values())
    d_final = torch.zeros_like(final) if d_final is None else d_final.float()
    grads = dict(zip(given, vjp((d_y.to(y.dtype), d_final))))
    return tuple(grads.get(n) for n in names)
